"""The GPT-2 and BLOOM families in the port against the JAX package, fp32 on
the CPU, on ``gpt2-tiny`` and ``bloom-tiny`` (vocab 256, 256 positions) whose
JAX parameters are perturbed by seeded numpy noise before both packages see
them: the JAX init sets every bias to zero and every norm scale to one, which
would hide a missing or misplaced bias or scale.

- logits of ``apply`` and of ``forward_with_cache`` (prefill, then three
  decode steps; the plain attention and the kernels' plain versions), rtol
  1e-4 / atol 1e-5 as ``test_torch_model.py``;
- greedy ``generate`` tokens equal to the JAX ``InferenceEngine``'s;
- three ``train_batch`` steps against ``TpuEngine`` on one device, kernel
  switches on (the kernels' plain versions through their autograd Functions;
  Pallas in interpret mode on the JAX side): losses rtol 1e-5, grad norm rtol
  1e-4, masters atol 2e-5 and Adam moments (mu atol 1e-6, nu atol 1e-9), the
  tolerances of ``test_torch_training.py`` and, for the moments, a hundredth
  of their scale after three steps;
- the tied head's gradient: the token table's gradient sums the lookup's
  and the head's, equal to JAX's;
- ``num_params`` equal to the JAX formula for every preset;
- what these families refuse: quantized weights, the int8 KV cache,
  speculative decode and the continuous-batching engine (later ROADMAP
  items), and positions the port does not have."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.topology import MeshTopology, ParallelDims
from deepspeed_tpu.models import bloom as jax_bloom
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.models.decoding import forward_with_cache as jax_fwc
from deepspeed_tpu.models.decoding import init_cache as jax_init_cache
from deepspeed_tpu.models.transformer import loss_fn as jax_loss_fn
from deepspeed_tpu.models.transformer import make_lm_batch as jax_lm_batch
from deepspeed_tpu_torch.models import TransformerConfig, TransformerModel
from deepspeed_tpu_torch.models import bloom, gpt2, llama
from deepspeed_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from deepspeed_tpu_torch.models.decoding import forward_with_cache, init_cache
from deepspeed_tpu_torch.models.transformer import check_supported, make_lm_batch
from deepspeed_tpu_torch.ops.attention import attention_impl

from torch_bridge import FAMILIES, V, family_pair, port_config, to_torch

RTOL, ATOL = 1e-4, 1e-5


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_apply_logits_match_jax(family):
    jm, jp, pm, pp = family_pair(family)
    ids = np.random.RandomState(0).randint(0, V, size=(2, 40))
    want, _ = jax.jit(functools.partial(jm.apply, dtype=jnp.float32))(jp, jnp.asarray(ids))
    got = pm.apply(pp, to_torch(ids))
    assert got.dtype == torch.float32 and got.shape == (2, 40, V)
    _close(got, want)


B_CACHE, P_CACHE, SMAX = 2, 40, 128


@functools.lru_cache(maxsize=None)
def _jax_cached_run(family):
    """The JAX forward_with_cache logits of a 40-token prefill and three
    decode steps, and the final cache (shared by both port impls)."""
    jm, jp, _, _ = family_pair(family, seed=1)
    ids = np.random.RandomState(1).randint(0, V, size=(B_CACHE, P_CACHE + 3))
    jcache = jax_init_cache(jm.config, B_CACHE, SMAX, jnp.float32)
    logits = []
    for start, stop in [(0, P_CACHE)] + [(p, p + 1) for p in range(P_CACHE, P_CACHE + 3)]:
        want, jcache = jax_fwc(jm.config, jp, jnp.asarray(ids[:, start:stop]), jcache, start,
                               dtype=jnp.float32)
        logits.append(np.asarray(want))
    return ids, logits, jcache


@pytest.mark.parametrize("impl", ["plain", "flash"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_prefill_then_three_decode_steps_match_jax(family, impl):
    """Learned positions at the cache positions, the embedding norm, biases,
    the ALiBi slopes of both attention branches and the tied head."""
    _, _, pm, pp = family_pair(family, seed=1)
    ids, wants, jcache = _jax_cached_run(family)
    cache = init_cache(pm.config, B_CACHE, SMAX, torch.float32)
    steps = [(0, P_CACHE)] + [(p, p + 1) for p in range(P_CACHE, P_CACHE + 3)]
    with attention_impl(impl):
        for (start, stop), want in zip(steps, wants):
            got, _ = forward_with_cache(pm.config, pp, to_torch(ids[:, start:stop]), cache,
                                        start)
            _close(got, want)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_greedy_generate_matches_jax_engine(family):
    jm, jp, pm, pp = family_pair(family, seed=2)
    jeng = deepspeed_tpu.init_inference(jm, dtype=jnp.float32,
                                        replace_with_kernel_inject=True, params=jp,
                                        max_tokens=256)
    peng = deepspeed_tpu_torch.init_inference(pm, dtype=torch.float32,
                                              replace_with_kernel_inject=True,
                                              params=pp, max_tokens=256, device="cpu")
    ids = np.random.RandomState(2).randint(0, V, size=(2, 20))
    want = np.asarray(jeng.generate(ids, max_new_tokens=10))
    # every greedy step's top-2 logits apart by more than float noise
    top2 = peng.forward(np.array(want[:, :-1]))[:, 19:].topk(2, dim=-1).values
    assert float((top2[..., 0] - top2[..., 1]).min()) > 1e-4
    np.testing.assert_array_equal(peng.generate(ids, max_new_tokens=10).numpy(), want)


def _train_cfg():
    return {
        "train_batch_size": 4, "gradient_accumulation_steps": 2,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.01}},
        "gradient_clipping": 1.0, "steps_per_print": 100,
        "tpu_kernels": {"flash_attention": True, "fused_rmsnorm": True,
                        "fused_adam": True, "fused_ce": True, "ce_chunk": 100},
        # explicit values for the JAX engine's "auto" knobs (tests/test_torch_training.py)
        "zero_optimization": {"stage": 0, "grad_wire": "fp32", "param_wire": "fp32"},
        "serving": {"moe_a2a": "stock", "kv_cache_dtype": "bf16"},
    }


def _adam_moments(opt_state):
    """(mu, nu) of the optax Adam state inside the JAX engine's opt_state."""
    for node in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda n: hasattr(n, "mu") and hasattr(n, "nu")):
        if hasattr(node, "mu"):
            return node.mu, node.nu
    raise AssertionError("no Adam state")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_three_steps_match_tpu_engine(family):
    jm, jp, pm, pp = family_pair(family, seed=3)
    cfg = _train_cfg()
    topo = MeshTopology(dims=ParallelDims(), devices=jax.devices()[:1])
    jeng, *_ = deepspeed_tpu.initialize(model=jm, config=dict(cfg), topology=topo,
                                        model_parameters=jp, rng=jax.random.PRNGKey(0))
    peng, *_ = deepspeed_tpu_torch.initialize(
        model=pm, config=dict(cfg), model_parameters=params_from_numpy(
            pm.config, jax.tree.map(np.asarray, jeng.state.params)), device="cpu")
    r = np.random.RandomState(3)
    jl, pl = [], []
    for _ in range(3):
        batch = {"input_ids": r.randint(0, V, size=(4, 64))}
        jl.append(float(jeng.train_batch(batch=batch)))
        pl.append(peng.train_batch(batch=batch).item())
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    np.testing.assert_allclose(peng.get_global_grad_norm(), jeng.get_global_grad_norm(),
                               rtol=1e-4)
    want = jax.tree.map(np.asarray, jeng.state.params)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, atol=2e-5),
                 params_to_numpy(peng.params), want)
    mu, nu = _adam_moments(jeng.state.opt_state)
    for got, w, atol in ((peng.opt_state["mu"], mu, 1e-6), (peng.opt_state["nu"], nu, 1e-9)):
        jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, atol=atol, rtol=1e-4),
                     params_to_numpy(got), jax.tree.map(np.asarray, w))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tied_head_gradient_sums_lookup_and_head(family):
    jm, jp, pm, pp = family_pair(family, seed=4)
    ids = np.random.RandomState(4).randint(0, V // 2, size=(2, 32))
    jbatch = jax_lm_batch(jnp.asarray(ids))
    want = jax.jit(jax.grad(
        lambda p: jax_loss_fn(jm.config, p, jbatch, dtype=jnp.float32)[0]))(jp)
    leaves = {k: v for k, v in pp.items()}
    tok = pp["embed"]["tok"].clone().requires_grad_(True)
    leaves["embed"] = {**pp["embed"], "tok": tok}
    loss, _ = pm.loss(leaves, make_lm_batch(to_torch(ids).long()), dtype=None)
    loss.backward()
    assert "lm_head" not in pp
    _close(tok.grad, want["embed"]["tok"])
    # rows no token looks up get the head's gradient only, and it is not zero
    assert float(tok.grad[V // 2:].abs().min()) > 0


PRESETS = ([(jax_gpt2, gpt2, s) for s in ("gpt2-tiny", "gpt2", "gpt2-medium",
                                          "gpt2-large", "gpt2-xl")]
           + [(jax_bloom, bloom, s) for s in ("bloom-tiny", "bloom-560m", "bloom-7b1",
                                              "bloom-176b")]
           + [(jax_llama, llama, s) for s in ("llama-tiny", "llama3-1b", "llama3-8b",
                                              "llama3-70b")])


@pytest.mark.parametrize("jax_fn,port_fn,size", PRESETS,
                         ids=[p[2] for p in PRESETS])
def test_num_params_equal_jax_and_the_tree(jax_fn, port_fn, size):
    from deepspeed_tpu_torch.models.transformer import param_specs

    jcfg, pm = jax_fn(size).config, port_fn(size)
    assert pm.config == port_config(jcfg)
    assert pm.num_params() == jcfg.num_params()

    def count(spec):
        if isinstance(spec, dict):
            return sum(count(v) for v in spec.values())
        return int(np.prod(spec[0]))

    assert count(param_specs(pm.config)) == pm.num_params()


@pytest.mark.parametrize("kwargs,match", [
    (dict(dtype="int8"), "item 2"), (dict(quantize_bits=4), "item 2"),
    (dict(kv_cache_dtype="int8"), "item 2"), (dict(draft_model="ngram"), "item 2"),
])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_llama_only_serving_refuses_these_families(family, kwargs, match):
    pm = TransformerModel(port_config(FAMILIES[family][0](
        FAMILIES[family][1], vocab_size=V).config))
    kw = {"dtype": torch.float32, **kwargs}
    with pytest.raises(NotImplementedError, match=match):
        deepspeed_tpu_torch.init_inference(pm, device="cpu", **kw)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_continuous_batching_refuses_these_families(family):
    pm = TransformerModel(port_config(FAMILIES[family][0](
        FAMILIES[family][1], vocab_size=V).config))
    with pytest.raises(NotImplementedError, match="A4"):
        deepspeed_tpu_torch.init_serving(pm, serving={"max_slots": 2, "token_budget": 8,
                                                      "max_tokens": 64},
                                         device="cpu", dtype=torch.float32)
    # a Llama draft for a BLOOM model, and a BLOOM draft for a Llama model
    with pytest.raises(NotImplementedError, match="item 2"):
        deepspeed_tpu_torch.init_inference(llama("llama-tiny", vocab_size=V), device="cpu",
                                           dtype=torch.float32, draft_model=pm)


def test_positions_the_port_lacks_still_raise():
    with pytest.raises(NotImplementedError, match="pos_embedding='none'"):
        check_supported(TransformerConfig(pos_embedding="none"))
