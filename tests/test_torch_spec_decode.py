"""Speculative decoding: ``serving/spec.py`` against the JAX package's on
random inputs, and the port's speculative ``generate`` (int8 weights, so the
verify window runs the quantized matvec at k rows): spec-on == spec-off inside
the port for a draft model, "ngram" and an eos; full acceptance's round count
with the main weights as the draft; tokens and rounds equal to the JAX
engine's speculative decode."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.serving import spec as jspec
from deepspeed_tpu_torch.models import TransformerModel
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.serving import spec as pspec

from torch_bridge import port_config, tiny_pair

PACKED = dict(hidden_size=256, intermediate_size=512)
DRAFT = dict(hidden_size=64, num_layers=1, num_heads=2, num_kv_heads=2,
             intermediate_size=128)
P, NEW = 12, 20


# ------------------------------------------------------------- spec.py
@pytest.mark.parametrize("seed", range(4))
def test_ngram_propose_matches_jax(seed):
    r = np.random.RandomState(seed)
    buf = r.randint(0, 4, size=40).astype(np.int32)  # small vocab: matches happen
    for pos in (2, 9, 25, 33):
        k = 5
        want = np.asarray(jax.jit(jspec.ngram_propose, static_argnums=(2, 3))(
            jnp.asarray(buf), pos, k, 3))
        host = pspec.ngram_propose(buf, pos, k, 3)
        dev = pspec.ngram_propose(torch.from_numpy(buf), torch.tensor(pos), k, 3)
        np.testing.assert_array_equal(host, np.asarray(jspec.ngram_propose(buf, pos, k, 3)))
        np.testing.assert_array_equal(host, want)
        np.testing.assert_array_equal(dev.numpy(), want)


def test_propose_drafts_matches_jax():
    r = np.random.RandomState(5)
    for _ in range(6):
        prompt = r.randint(0, 3, size=r.randint(1, 12))
        tokens = r.randint(0, 3, size=r.randint(1, 8))
        tail = r.randint(0, 3, size=r.randint(0, 5))
        np.testing.assert_array_equal(pspec.propose_drafts(prompt, tokens, tail, 4, 2),
                                      jspec.propose_drafts(prompt, tokens, tail, 4, 2))


def test_acceptance_math_matches_jax():
    r = np.random.RandomState(6)
    match = r.rand(16, 6) < 0.7
    np.testing.assert_array_equal(pspec.longest_accepted_prefix(torch.from_numpy(match)).numpy(),
                                  np.asarray(jspec.longest_accepted_prefix(jnp.asarray(match))))
    targets = r.randint(0, 5, size=(16, 6))
    adv = r.randint(1, 7, size=16)
    eos = r.randint(-1, 5, size=16)
    want = jspec.clamp_advance_at_eos(jnp.asarray(targets), jnp.asarray(adv), jnp.asarray(eos))
    got = pspec.clamp_advance_at_eos(torch.from_numpy(targets), torch.from_numpy(adv),
                                     torch.from_numpy(eos))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for row in range(4):  # the scalar form of the lockstep loop
        a, h = pspec.clamp_advance_at_eos(torch.from_numpy(targets[row]), int(adv[row]),
                                          int(eos[row]))
        wa, wh = jspec.clamp_advance_at_eos(targets[row], int(adv[row]), int(eos[row]))
        assert (int(a), bool(h)) == (int(wa), bool(wh))


# ------------------------------------------------------------- engines
@pytest.fixture(scope="module")
def models():
    jm, jp, pm, pp = tiny_pair(seed=0, **PACKED)
    jd, _, dm, _ = tiny_pair(seed=0, **DRAFT)
    jdp = jd.init(jax.random.PRNGKey(7))
    dp = params_from_numpy(dm.config, jax.tree.map(np.asarray, jdp))
    return jm, jp, pm, pp, jd, jdp, dm, dp


def _port(models, **kw):
    _, _, pm, pp, *_ = models
    return deepspeed_tpu_torch.init_inference(pm, dtype=torch.float32, params=pp,
                                              quantize_bits=8, max_tokens=256,
                                              device="cpu", **kw)


def _prompt(seed, repetitive=False):
    if repetitive:
        return np.tile(np.asarray([[7, 3, 9]]), (1, P // 3))
    return np.random.RandomState(seed).randint(0, 256, size=(1, P))


def test_spec_equals_plain_greedy_in_the_port(models):
    *_, dm, dp = models
    plain = _port(models)
    drafted = _port(models, draft_model=dm, draft_params=dp)
    ngram = _port(models, draft_model="ngram")
    for seed, rep in ((1, False), (2, True)):
        ids = _prompt(seed, rep)
        want = plain.generate(ids, max_new_tokens=NEW)
        for eng in (drafted, ngram):
            for nd in (1, 4):
                got = eng.generate(ids, max_new_tokens=NEW, num_draft_tokens=nd)
                assert torch.equal(got, want), (seed, nd, got.tolist(), want.tolist())
                assert 1 <= eng.last_spec_rounds <= NEW - 1
    # a repetitive prompt lands acceptances under the ngram draft
    ngram.generate(_prompt(0, True), max_new_tokens=NEW, num_draft_tokens=4)
    assert ngram.last_spec_rounds < NEW - 1
    # eos inside an accepted window stops the row, padded with eos after it
    ids = _prompt(3)
    free = plain.generate(ids, max_new_tokens=NEW)
    eos = int(free[0, P + 6])
    want = plain.generate(ids, max_new_tokens=NEW, eos_token_id=eos)
    for eng in (drafted, ngram):
        got = eng.generate(ids, max_new_tokens=NEW, eos_token_id=eos, num_draft_tokens=3)
        assert torch.equal(got, want)
        assert (got[0, P + 7:] == eos).all()
    # batched, sampled and penalised requests take the plain loop
    assert drafted.generate(np.tile(ids, (2, 1)), max_new_tokens=4).shape == (2, P + 4)


def test_full_acceptance_round_count(models):
    """The main weights as the draft accept every proposal: ceil((new-1)/k)
    verifier rounds (a draft-cache row left unwritten after a fully accepted
    round would desync the draft and add rounds)."""
    pm = models[2]
    plain = _port(models)
    # the draft is the main model with its own packed weights
    spec = _port(models, draft_model=pm, draft_params=plain.params)
    ids = _prompt(4)
    want = plain.generate(ids, max_new_tokens=NEW)
    for nd in (2, 4):
        got = spec.generate(ids, max_new_tokens=NEW, num_draft_tokens=nd)
        assert torch.equal(got, want)
        assert spec.last_spec_rounds == math.ceil((NEW - 1) / (nd + 1))


def test_verify_window_logits_match_single_token_steps(models):
    """A window forward against a filled int8 cache (the verify; its head
    runs a row at a time) gives the logits of single-token steps (fp32 on
    the CPU)."""
    from deepspeed_tpu_torch.models.decoding import forward_with_cache, init_cache
    eng = _port(models, kv_cache_dtype="int8")
    cfg = eng.config
    ids = torch.from_numpy(_prompt(6))
    caches = [init_cache(cfg, 1, 128, torch.float32, quantized=True) for _ in range(2)]
    for cache in caches:
        forward_with_cache(cfg, eng.params, ids[:, :8], cache, 0)
    window, _ = forward_with_cache(cfg, eng.params, ids[:, 8:], caches[0], 8)
    steps = torch.cat([forward_with_cache(cfg, eng.params, ids[:, s:s + 1], caches[1], s)[0]
                       for s in range(8, P)], dim=1)
    assert window.shape == steps.shape == (1, P - 8, cfg.vocab_size)
    np.testing.assert_allclose(window.numpy(), steps.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("draft", ["model", "ngram"])
def test_spec_tokens_and_rounds_match_jax(models, draft):
    jm, jp, _, _, jd, jdp, dm, dp = models
    jkw = dict(draft_model=jd, draft_params=jdp) if draft == "model" \
        else dict(draft_model="ngram")
    pkw = dict(draft_model=dm, draft_params=dp) if draft == "model" \
        else dict(draft_model="ngram")
    jeng = deepspeed_tpu.init_inference(jm, dtype=jnp.float32, params=jp,
                                        quantize_bits=8, max_tokens=256, **jkw)
    peng = _port(models, **pkw)
    ids = _prompt(5, repetitive=draft == "ngram")
    want = np.asarray(jeng.generate(ids, max_new_tokens=NEW, num_draft_tokens=4))
    got = peng.generate(ids, max_new_tokens=NEW, num_draft_tokens=4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert peng.last_spec_rounds == jeng.last_spec_rounds


def test_bad_drafts_raise(models):
    with pytest.raises(ValueError, match="only string draft"):
        _port(models, draft_model="lookahead")
    other = TransformerModel(port_config(tiny_pair(seed=0, vocab_size=512, **DRAFT)[0].config))
    with pytest.raises(ValueError, match="vocabulary"):
        _port(models, draft_model=other)
