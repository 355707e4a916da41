"""Decode attention with ALiBi: a BLOOM layer's cached attention in the port
(``models/decoding._cached_attention`` with slopes: the plain masked
attention, and the decode kernel's plain version a row each with
``rows_per_seq``) against the JAX package's ``_cached_attention``, whose every
ALiBi step after a fresh prefill is its XLA einsum (``models/decoding.py``
lines 424-438). One layer of ``bloom-tiny`` with its biases perturbed by
seeded noise, a cache holding random K/V, per-row (ragged) frontiers; single
tokens and a 3-token window; the output (after ``wo`` and ``bo``) and the
cache's new rows. fp32 within atol 2e-5."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import bloom as jax_bloom
from deepspeed_tpu.models import decoding as jdec
from deepspeed_tpu_torch.models import decoding as pdec
from deepspeed_tpu_torch.models.transformer import alibi_slopes, model_slopes
from deepspeed_tpu_torch.ops.attention import attention_impl
from deepspeed_tpu_torch.ops.cuda import decode_attention as dec

from torch_bridge import port_config, to_torch

B, SMAX = 3, 64
ATOL = 2e-5


def _layer(seed=0):
    """(jax config, port config, one layer's attention params as numpy with
    its biases perturbed)."""
    jm = jax_bloom("bloom-tiny", vocab_size=256, num_layers=1)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    attn = {k: np.array(v[0]) for k, v in params["layers"]["attn"].items()}
    r = np.random.RandomState(seed)
    for name in ("bq", "bk", "bv", "bo"):
        attn[name] = attn[name] + 0.1 * r.randn(*attn[name].shape).astype(np.float32)
    return jm.config, port_config(jm.config), attn


def _case(cfg, S, seed=0):
    r = np.random.RandomState(seed + 10)
    x = r.randn(B, S, cfg.hidden_size).astype(np.float32)
    shape = (B, SMAX, cfg.kv_heads, cfg.hd)
    return x, r.randn(*shape).astype(np.float32), r.randn(*shape).astype(np.float32)


def _jax(cfg, attn, x, kc, vc, cache_len):
    S = x.shape[1]
    positions = jnp.asarray(cache_len)[:, None] + jnp.arange(S)[None, :]
    out, k_new, v_new = jax.jit(functools.partial(jdec._cached_attention, cfg))(
        {k: jnp.asarray(v) for k, v in attn.items()}, jnp.asarray(x), positions,
        jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(cache_len, jnp.int32))
    return np.asarray(out), np.asarray(k_new), np.asarray(v_new)


@pytest.mark.parametrize("impl", ["plain", "flash"])
@pytest.mark.parametrize("S,frontier", [(1, [0, 17, 63]), (3, [5, 40, 61])])
def test_cached_attention_with_slopes_matches_jax_xla(impl, S, frontier):
    """``plain`` takes the masked attention over the cache (one token) or
    the plain twins a row each; ``flash`` takes the decode kernel's plain
    version a row each with rows_per_seq = S (what runs on the card)."""
    jcfg, pcfg, attn = _layer()
    x, kc, vc = _case(jcfg, S)
    cache_len = np.array(frontier, np.int32)
    want, k_new, v_new = _jax(jcfg, attn, x, kc, vc, cache_len)
    p = {k: torch.from_numpy(v) for k, v in attn.items()}
    tk, tv = to_torch(kc).clone(), to_torch(vc).clone()
    slopes = model_slopes(pcfg, "cpu")
    with attention_impl(impl):
        got = pdec._cached_attention(pcfg, p, to_torch(x), None, tk, tv,
                                     torch.from_numpy(cache_len), slopes=slopes)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(tk.numpy(), k_new, atol=ATOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), v_new, atol=ATOL, rtol=0)


def test_decode_rows_with_slopes_equal_single_rows_and_pages():
    """rows_per_seq rows with slopes equal one call a row at the row's
    frontier (to fp32 summation order: the plain rows of a sequence attend
    its cache cut at the furthest frontier, a single row at its own), and
    the paged plain version over shuffled pages equals the dense one over
    the same bytes, bit for bit."""
    r = np.random.RandomState(3)
    H, KV, hd, R = 4, 4, 32, 3
    slopes = alibi_slopes(H)
    q = torch.from_numpy(r.randn(2 * R, 1, H, hd).astype(np.float32))
    kc = torch.from_numpy(r.randn(2, SMAX, KV, hd).astype(np.float32))
    vc = torch.from_numpy(r.randn(2, SMAX, KV, hd).astype(np.float32))
    fr = torch.tensor([10, 11, -1, 0, 62, 63], dtype=torch.int32)
    rows = dec.decode_attention(q, kc, vc, fr, rows_per_seq=R, slopes=slopes)
    for i in range(2 * R):
        n = i // R
        one = dec.decode_attention(q[i:i + 1], kc[n:n + 1], vc[n:n + 1], fr[i:i + 1],
                                   slopes=slopes)
        if fr[i] < 0:
            assert (rows[i] == 0).all()
        else:
            np.testing.assert_allclose(rows[i:i + 1].numpy(), one.numpy(), atol=1e-6,
                                       rtol=0)
    ps, mp = 8, SMAX // 8
    perm = torch.from_numpy(r.permutation(2 * mp).astype(np.int32))
    table = perm.reshape(2, mp)
    pool_k = torch.zeros(2 * mp + 1, ps, KV, hd)
    pool_v = torch.zeros_like(pool_k)
    pool_k[table.long()] = kc.reshape(2, mp, ps, KV, hd)
    pool_v[table.long()] = vc.reshape(2, mp, ps, KV, hd)
    paged = dec.paged_decode_attention(q, pool_k, pool_v, fr, table, rows_per_seq=R,
                                       slopes=slopes)
    assert torch.equal(paged, rows)
