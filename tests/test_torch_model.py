"""Model core: the port's ``apply`` and ``forward_with_cache`` against the
JAX package's on the same weights (bridged by params_from_numpy), fp32,
rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.decoding import forward_with_cache as jax_fwc
from deepspeed_tpu.models.decoding import init_cache as jax_init_cache
from deepspeed_tpu_torch.models import llama, llama_config
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.models.decoding import forward_with_cache, init_cache
from deepspeed_tpu_torch.models.transformer import (TransformerConfig,
                                                    check_supported)

from torch_bridge import tiny_pair, to_torch

RTOL, ATOL = 1e-4, 1e-5


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_apply_logits_match_jax():
    jm, jp, pm, pp = tiny_pair()
    ids = np.random.RandomState(0).randint(0, 256, size=(2, 40))
    want, _ = jm.apply(jp, jnp.asarray(ids), dtype=jnp.float32)
    got = pm.apply(pp, to_torch(ids))
    assert got.dtype == torch.float32 and got.shape == (2, 40, 256)
    _close(got, want)


def test_prefill_then_three_decode_steps_match_jax():
    jm, jp, pm, pp = tiny_pair(seed=1)
    cfg = jm.config
    B, P, Smax = 2, 128, 256
    ids = np.random.RandomState(1).randint(0, 256, size=(B, P + 3))
    jcache = jax_init_cache(cfg, B, Smax, jnp.float32)
    cache = init_cache(pm.config, B, Smax, torch.float32)
    want, jcache = jax_fwc(cfg, jp, jnp.asarray(ids[:, :P]), jcache, 0,
                           dtype=jnp.float32)
    got, cache2 = forward_with_cache(pm.config, pp, to_torch(ids[:, :P]), cache, 0)
    assert cache2 is cache  # updated in place
    _close(got, want)
    for pos in range(P, P + 3):
        want, jcache = jax_fwc(cfg, jp, jnp.asarray(ids[:, pos:pos + 1]),
                               jcache, pos, dtype=jnp.float32)
        got, _ = forward_with_cache(pm.config, pp, to_torch(ids[:, pos:pos + 1]),
                                    cache, pos)
        _close(got, want)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])


def test_per_row_frontier_decode_matches_jax():
    """A [B] cache_len: each row writes and masks at its own frontier."""
    jm, jp, pm, pp = tiny_pair(seed=2)
    cfg = jm.config
    B, Smax = 2, 128
    r = np.random.RandomState(2)
    ids = r.randint(0, 256, size=(B, 40))
    jcache = jax_init_cache(cfg, B, Smax, jnp.float32)
    cache = init_cache(pm.config, B, Smax, torch.float32)
    _, jcache = jax_fwc(cfg, jp, jnp.asarray(ids), jcache, 0, dtype=jnp.float32)
    forward_with_cache(pm.config, pp, to_torch(ids), cache, 0)
    frontier = np.array([17, 40], np.int32)
    tok = r.randint(0, 256, size=(B, 1))
    want, _ = jax_fwc(cfg, jp, jnp.asarray(tok), jcache, jnp.asarray(frontier),
                      dtype=jnp.float32)
    got, _ = forward_with_cache(pm.config, pp, to_torch(tok), cache,
                                to_torch(frontier))
    _close(got, want)


def test_init_matches_jax_tree_and_scales():
    jm, jp, pm, _ = tiny_pair()
    got = pm.init(torch.Generator().manual_seed(0))
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat_j:
        t = got
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape, path
        # same init scale: stds agree to sampling noise (ones for norms)
        assert abs(float(t.std()) - float(np.std(leaf))) <= 0.1 * float(np.std(leaf)) + 1e-6


def test_params_from_numpy_rejects_mismatches():
    jm, jp, pm, _ = tiny_pair()
    tree = jax.tree.map(np.asarray, jp)
    bad = dict(tree, lm_head=tree["lm_head"][:, :10])
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(pm.config, bad)
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(pm.config, {k: v for k, v in tree.items() if k != "lm_head"})
    bf = params_from_numpy(pm.config, tree, dtype=torch.bfloat16)
    assert bf["layers"]["attn"]["wq"].dtype == torch.bfloat16


def test_presets_and_unsupported_families():
    cfg = llama_config("llama3-8b")
    assert (cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.kv_heads, cfg.hd,
            cfg.ffn, cfg.vocab_size, cfg.rope_theta) == \
        (4096, 32, 32, 8, 128, 14336, 128256, 500000.0)
    assert abs(llama("llama3-8b").num_params() / 1e9 - 8.03) < 0.01
    check_supported(cfg)
    # the GPT-2/BLOOM features are ported (slice 5) and accepted
    for ok in (dict(norm="layernorm"), dict(pos_embedding="alibi"),
               dict(pos_embedding="learned"), dict(use_bias=True),
               dict(activation="gelu"), dict(activation="gelu_new"),
               dict(tie_embeddings=True), dict(embed_norm=True)):
        check_supported(TransformerConfig(**ok))
    # what stays unported still raises
    for bad in (dict(pos_embedding="none"), dict(norm="batchnorm"),
                dict(activation="relu")):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            check_supported(TransformerConfig(**bad))
