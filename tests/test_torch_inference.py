"""Inference engine: the port's ``generate`` against the JAX package's
``InferenceEngine.generate`` on the same fp32 weights. Greedy tokens must be
equal; sampled tokens differ by design (torch.Generator against threefry),
so sampling is checked by its own invariants."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.engine import \
    apply_repetition_penalty as jax_penalty
from deepspeed_tpu.ops.attention import attention_impl as jax_attention_impl
from deepspeed_tpu_torch.inference.engine import apply_repetition_penalty
from deepspeed_tpu_torch.ops.attention import attention_impl

from torch_bridge import tiny_pair

NEW = 12


@pytest.fixture(scope="module")
def engines():
    jm, jp, pm, pp = tiny_pair(seed=0)
    jeng = deepspeed_tpu.init_inference(
        jm, dtype=jnp.float32, replace_with_kernel_inject=True, params=jp,
        max_tokens=512,
    )
    peng = deepspeed_tpu_torch.init_inference(
        pm, dtype=torch.float32, replace_with_kernel_inject=True, params=pp,
        max_tokens=512, device="cpu",
    )
    return jm, jp, jeng, pm, pp, peng


def _assert_no_near_ties(peng, tokens, P, margin=1e-4):
    """Every greedy step's top-2 logits are apart by more than float noise
    (else a different seed is needed: token equality is never loosened)."""
    logits = peng.forward(tokens[:, :-1])[:, P - 1:]
    top2 = logits.topk(2, dim=-1).values
    assert float((top2[..., 0] - top2[..., 1]).min()) > margin


def _prompt(B, P, seed):
    return np.random.RandomState(seed).randint(0, 256, size=(B, P))


# 20 stays in the first 32-token prompt bucket, 40 crosses into the second
@pytest.mark.parametrize("P", [20, 40])
def test_greedy_tokens_match_jax_with_eos_stop(engines, P):
    _, _, jeng, _, _, peng = engines
    ids = _prompt(2, P, seed=P)
    free = np.asarray(jeng.generate(ids, max_new_tokens=NEW))
    _assert_no_near_ties(peng, free, P)
    np.testing.assert_array_equal(peng.generate(ids, max_new_tokens=NEW).numpy(), free)
    eos = int(free[0, P + 4])  # a token row 0 emits: its row stops there
    want = np.asarray(jeng.generate(ids, max_new_tokens=NEW, eos_token_id=eos))
    assert (want[0, P + 4:] == eos).all()
    got = peng.generate(ids, max_new_tokens=NEW, eos_token_id=eos)
    np.testing.assert_array_equal(got.numpy(), want)


def test_repetition_penalty_tokens_match_jax(engines):
    _, _, jeng, _, _, peng = engines
    ids = _prompt(2, 40, seed=7)
    want = np.asarray(jeng.generate(ids, max_new_tokens=NEW, repetition_penalty=1.3))
    got = peng.generate(ids, max_new_tokens=NEW, repetition_penalty=1.3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_flash_kernels_path_matches_jax(engines):
    """The JAX side runs its Pallas flash prefill (prompt bucket 128) and
    decode kernels in interpret mode; the port runs its kernel wrappers
    (their plain versions on CPU tensors). Both engines are built without
    injection, whose "auto" scope would shadow the forced one."""
    jm, jp, _, pm, pp, _ = engines
    jeng = deepspeed_tpu.init_inference(jm, dtype=jnp.float32, params=jp,
                                        max_tokens=512)
    peng = deepspeed_tpu_torch.init_inference(pm, dtype=torch.float32, params=pp,
                                              max_tokens=512, device="cpu")
    ids = _prompt(2, 100, seed=3)
    with jax_attention_impl("flash"):
        want = np.asarray(jeng.generate(ids, max_new_tokens=8))
    with attention_impl("flash"):
        got = peng.generate(ids, max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_forward_logits_match_jax(engines):
    _, _, jeng, _, _, peng = engines
    ids = _prompt(2, 24, seed=4)
    np.testing.assert_allclose(peng.forward(ids).numpy(),
                               np.asarray(jeng.forward(ids)),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("active", [None, [True, False, True]])
def test_apply_repetition_penalty_matches_jax(active):
    r = np.random.RandomState(5)
    logits = r.randn(3, 50).astype(np.float32)
    seen = r.rand(3, 50) < 0.3
    act = None if active is None else np.asarray(active)
    want = jax_penalty(jnp.asarray(logits), jnp.asarray(seen), 1.3,
                       None if act is None else jnp.asarray(act))
    got = apply_repetition_penalty(torch.from_numpy(logits), torch.from_numpy(seen),
                                   1.3, None if act is None else torch.from_numpy(act))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_zero_new_tokens_echoes_prompt(engines):
    peng = engines[-1]
    ids = _prompt(2, 9, seed=6)
    out = peng.generate(ids, max_new_tokens=0)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ids)


def test_too_long_prompt_raises(engines):
    peng = engines[-1]
    with pytest.raises(ValueError, match="no room to generate"):
        peng.generate(_prompt(1, 512, seed=8), max_new_tokens=4)


def test_top_k_one_and_top_p_zero_sampling_equal_greedy(engines):
    peng = engines[-1]
    ids = _prompt(2, 30, seed=9)
    greedy = peng.generate(ids, max_new_tokens=8)
    for kw in (dict(top_k=1), dict(top_p=0.0)):
        sampled = peng.generate(ids, max_new_tokens=8, temperature=0.7, **kw)
        assert torch.equal(sampled, greedy), kw


def test_sampling_is_seeded(engines):
    peng = engines[-1]
    ids = _prompt(2, 30, seed=10)
    kw = dict(max_new_tokens=8, temperature=0.9, top_k=50, top_p=0.9)
    a = peng.generate(ids, rng=torch.Generator().manual_seed(1), **kw)
    b = peng.generate(ids, rng=torch.Generator().manual_seed(1), **kw)
    assert torch.equal(a, b)
    assert ((a >= 0) & (a < 256)).all()


@pytest.mark.parametrize("kw", [
    dict(tp_size=2), dict(ep_size=2), dict(tensor_parallel={"tp_size": 2}),
    dict(tensor_parallel={"tp_size": 1, "overlap_comm": True}),
])
def test_later_slice_arguments_raise(engines, kw):
    pm = engines[3]
    with pytest.raises(NotImplementedError, match="not yet ported"):
        deepspeed_tpu_torch.init_inference(pm, device="cpu", **kw)
