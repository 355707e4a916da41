"""The int8 KV cache: ``_quantize_kv`` bytes against the JAX package's, the
int8 decode attention's plain version (what the CUDA kernel computes) against
the Pallas decode kernel with scales in interpret mode (atol 2e-5), and the
cached forward over an int8 cache against the JAX ``forward_with_cache``.

The port keeps one scale per (token, kv head) as [B, KV, Smax]; the JAX
package keeps SCALE_LANES copies [B, KV, Smax, SL], of which column 0 is the
port's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import decoding as jdec
from deepspeed_tpu.ops.pallas.decode_attention import decode_attention_kernel
from deepspeed_tpu_torch.models import decoding as pdec
from deepspeed_tpu_torch.ops.cuda.decode_attention import (
    cached_attention_plain, decode_attention, decode_attention_plain, launches)

from torch_bridge import tiny_pair

B, SMAX, H, KV, HD = 2, 256, 4, 2, 64


def _int8_cache(seed=0):
    """q [B,1,H,hd] fp32 and an int8 cache quantized by the JAX package:
    (q, k8, v8, ks_port, vs_port, ks_jax, vs_jax)."""
    r = np.random.RandomState(seed)
    q = r.randn(B, 1, H, HD).astype(np.float32)
    k = r.randn(B, SMAX, KV, HD).astype(np.float32)
    v = r.randn(B, SMAX, KV, HD).astype(np.float32)
    k8, ks = (np.array(a) for a in jdec._quantize_kv(jnp.asarray(k)))
    v8, vs = (np.array(a) for a in jdec._quantize_kv(jnp.asarray(v)))
    ks_j = np.ascontiguousarray(np.swapaxes(ks, 1, 2))  # [B,KV,Smax,SL]
    vs_j = np.ascontiguousarray(np.swapaxes(vs, 1, 2))
    return (q, k8, v8, np.ascontiguousarray(ks_j[..., 0]),
            np.ascontiguousarray(vs_j[..., 0]), ks_j, vs_j)


def _pallas(q, k8, v8, ks_j, vs_j, cache_len):
    return np.asarray(decode_attention_kernel(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8),
        jnp.asarray(cache_len, jnp.int32), k_scale=jnp.asarray(ks_j),
        v_scale=jnp.asarray(vs_j), interpret=True,
    ))


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_quantize_kv_bytes_equal_jax(dtype):
    t = np.random.RandomState(1).randn(2, 5, KV, HD).astype(dtype) * 3
    t[0, 0, 0] = 0.0  # an all-zero head row: the 1e-8 floor
    jq, js = jdec._quantize_kv(jnp.asarray(t))
    pq, ps = pdec._quantize_kv(torch.from_numpy(t))
    assert pq.dtype == torch.int8 and ps.shape == (2, 5, KV)
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js)[..., 0])
    assert (np.asarray(js) == np.asarray(js)[..., :1]).all()


@pytest.mark.parametrize("cache_len", [0, 77, 255, [3, 200], [255, 0]])
def test_int8_decode_plain_matches_pallas(cache_len):
    q, k8, v8, ks, vs, ks_j, vs_j = _int8_cache(seed=len(str(cache_len)))
    cl = torch.tensor(cache_len, dtype=torch.int32) if isinstance(cache_len, list) \
        else cache_len
    t = torch.from_numpy
    got = decode_attention(t(q), t(k8), t(v8), cl, t(ks), t(vs))
    want = _pallas(q, k8, v8, ks_j, vs_j, np.asarray(cache_len))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_int8_decode_reads_layer_views_without_counting():
    q, k8, v8, ks, vs, ks_j, vs_j = _int8_cache(seed=4)
    t = torch.from_numpy
    kall = torch.stack([torch.zeros_like(t(k8)), t(k8)])
    vall = torch.stack([torch.zeros_like(t(v8)), t(v8)])
    sall = torch.stack([torch.zeros_like(t(ks)), t(ks)])
    vsall = torch.stack([torch.zeros_like(t(vs)), t(vs)])
    before = dict(launches)
    got = decode_attention(t(q), kall[1], vall[1], 100, sall[1], vsall[1])
    assert launches == before
    np.testing.assert_allclose(got.numpy(), _pallas(q, k8, v8, ks_j, vs_j, 100),
                               atol=2e-5)


def test_plain_rounds_dequantized_rows_to_q_dtype():
    """The kernel's order: float(q) * scale rounded to q's dtype before the
    dot, for a single token and for a multi-token window alike."""
    q, k8, v8, ks, vs, _, _ = _int8_cache(seed=5)
    t = torch.from_numpy
    kb = (t(k8).float() * t(ks).transpose(1, 2)[..., None]).bfloat16()
    vb = (t(v8).float() * t(vs).transpose(1, 2)[..., None]).bfloat16()
    qb = t(q).bfloat16()
    got = decode_attention_plain(qb, t(k8), t(v8), 40, t(ks), t(vs))
    assert torch.equal(got, cached_attention_plain(qb, kb, vb, 40))
    q2 = torch.cat([qb, qb.flip(0)], dim=1)
    window = cached_attention_plain(q2, t(k8), t(v8), 40, t(ks), t(vs))
    assert torch.equal(window, cached_attention_plain(q2, kb, vb, 40))
    assert torch.equal(window[:, :1], got)


@pytest.mark.parametrize("int8", [True, False])
def test_window_rows_are_single_token_decode(int8):
    """A one-sequence window as decode rows over one cache (rows_per_seq =
    S): row s is the single-token decode at cache_len + s, and the window
    agrees with the plain masked window attention. (Bit for bit is the
    kernel's property, a row's result independent of its tile-mates;
    chip_smoke.py checks it on the card.)"""
    _, k8, v8, ks, vs, _, _ = _int8_cache(seed=6)
    t = torch.from_numpy
    qw = t(np.random.RandomState(6).randn(1, 4, H, HD).astype(np.float32))
    if int8:
        k, v, scales = t(k8[:1]), t(v8[:1]), (t(ks[:1]), t(vs[:1]))
    else:
        k, v, scales = t(k8[:1]).float() / 50, t(v8[:1]).float() / 50, ()
    rows = pdec._window_rows(qw, k, v, 50, None, None, *(scales or (None, None)),
                             kernel=True)
    for s in range(4):
        np.testing.assert_allclose(
            rows[:, s:s + 1].numpy(),
            decode_attention(qw[:, s:s + 1], k, v, 50 + s, *scales).numpy(), atol=1e-6)
    np.testing.assert_allclose(rows.numpy(),
                               cached_attention_plain(qw, k, v, 50, *scales).numpy(),
                               atol=1e-5)


def test_int8_cached_forward_matches_jax():
    """Prefill of 24 tokens into an int8 cache, then three single-token
    steps and one 3-token window, through both packages' forward_with_cache
    (plain attention): logits, cache bytes and scales."""
    jm, jp, pm, pp = tiny_pair(seed=3)
    cfg = pm.config
    ids = np.random.RandomState(3).randint(0, 256, size=(2, 30))
    jc = jdec.init_cache(jm.config, 2, 128, jnp.float32, quantized=True)
    pc = pdec.init_cache(cfg, 2, 128, torch.float32, quantized=True)
    assert pc["k_scale"].shape == (cfg.num_layers, 2, cfg.kv_heads, 128)
    spans = [(0, 24), (24, 25), (25, 26), (26, 27), (27, 30)]
    for a, b in spans:
        jl, jc = jdec.forward_with_cache(jm.config, jp, jnp.asarray(ids[:, a:b]), jc, a,
                                         dtype=jnp.float32)
        pl, _ = pdec.forward_with_cache(cfg, pp, torch.from_numpy(ids[:, a:b]), pc, a)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(pc["k"].numpy(), np.asarray(jc["k"]))
    np.testing.assert_array_equal(pc["v"].numpy(), np.asarray(jc["v"]))
    np.testing.assert_allclose(pc["k_scale"].numpy(), np.asarray(jc["k_scale"])[..., 0],
                               rtol=1e-6)


def test_ragged_frontier_writes_scales_per_row():
    cfg = tiny_pair(seed=0)[2].config
    cache = pdec.init_cache(cfg, 2, 16, quantized=True)
    new = torch.randn(2, 2, cfg.kv_heads, cfg.hd, generator=torch.Generator().manual_seed(0))
    q8, s = pdec._quantize_kv(new)
    pdec._update_at(cache["k"][0], q8, torch.tensor([3, 9]))
    pdec._update_scale_at(cache["k_scale"][0], s, torch.tensor([3, 9]))
    assert torch.equal(cache["k"][0, 0, 3:5], q8[0]) and torch.equal(cache["k"][0, 1, 9:11], q8[1])
    assert torch.equal(cache["k_scale"][0, 0, :, 3:5], s[0].T)
    assert torch.equal(cache["k_scale"][0, 1, :, 9:11], s[1].T)
    assert int((cache["k_scale"] != 0).sum()) == 2 * 2 * cfg.kv_heads
