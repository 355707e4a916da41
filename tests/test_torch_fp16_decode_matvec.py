"""The fp16 forms of the decode attention and packed-matvec kernels (fp16
serving), on their plain versions (what ``csrc/decode_attention_f16.cu`` and
``csrc/quantized_matvec_f16.cu`` compute), against the JAX package's Pallas
kernels in fp16 in interpret mode, inputs from a seed with numpy.

- Decode: ``decode_attention_kernel`` and ``paged_decode_attention_kernel``
  with fp16 q over an fp16 cache, an int8 cache with its scales, and a bf16
  cache (the mixed form: both sides round each value to fp16 first, the
  Pallas ``_tile_update:44-48``), at ragged frontiers (and -1: zeros in the
  port), through shuffled pages with NULL tails for the paged form. Within
  atol 1e-3: the Pallas kernel rounds P to fp16 before P V (2^-12 of each
  weight) where the plain version keeps it fp32, and the outputs are fp16
  (an ulp is 2^-12 to 2^-10 at the outputs' 0.25-1); measured 2.4e-4.
- ALiBi: a BLOOM layer's cached attention in fp16 (the decode rows' plain
  twin with slopes) against the JAX package's ``_cached_attention`` in fp16,
  whose ALiBi steps are its XLA einsum; within atol 4e-3 after ``wo`` and
  ``bo`` in fp16 (measured 9.8e-4), the cache's new rows within an fp16 ulp
  (the fp16 projections sum in another order: 1 of 24,576 elements moved).
- A verify window's rows equal single-token decode within DEC_ATOL in each
  form (bitwise on the card, where ``chip_smoke.py`` holds it: the plain
  version's einsum cuts the cache at the window's furthest frontier), and
  bitwise the same window over a larger cache; the paged plain version
  equals the dense one over the gathered view bitwise.
- The matvec and its expert form in fp16 against ``_packed_matvec`` and
  ``_packed_expert_matvec_local``, int8 and int4 (nibble planes), within one
  fp16 ulp of each output (both fold in fp32 and round once) plus 2e-6.
- The fp16 magic-number conversions of the matvec kernel give each of the
  256 int8 bytes and each of the 16 nibbles exactly (numpy bit level).

About 8 s in one process on 8 CPU cores.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import bloom as jax_bloom
from deepspeed_tpu.models import decoding as jdec
from deepspeed_tpu.ops import quantizer as jq
from deepspeed_tpu.ops.pallas import quantized_matmul as jqm
from deepspeed_tpu.ops.pallas.decode_attention import (decode_attention_kernel,
                                                       paged_decode_attention_kernel)
from deepspeed_tpu_torch.models import decoding as pdec
from deepspeed_tpu_torch.models.transformer import model_slopes
from deepspeed_tpu_torch.ops import quantizer as pq
from deepspeed_tpu_torch.ops.attention import attention_impl
from deepspeed_tpu_torch.ops.cuda import decode_attention as dec
from deepspeed_tpu_torch.ops.cuda import quantized_matmul as pqm

from torch_bridge import port_config

B, SMAX, H, KV = 3, 256, 4, 2
N, MP, PS = 3, 4, 8
P = N * MP  # pool pages; page P is the NULL page
DEC_ATOL = 1e-3
FORMS = ("fp16", "int8", "mixed")


def _cache(r, shape, form):
    """(port K or V, JAX K or V, port scales, JAX scales) of one random
    cache in ``form``: fp16, int8 (quantized by the JAX package, its scales
    [..., KV, S, SL] and the port's column 0), or bf16 ("mixed")."""
    x = r.randn(*shape).astype(np.float32)
    if form == "fp16":
        a = x.astype(np.float16)
        return torch.from_numpy(a), jnp.asarray(a), None, None
    if form == "mixed":
        t = torch.from_numpy(x).bfloat16()
        return t, jnp.asarray(x).astype(jnp.bfloat16), None, None
    q8, s = (np.array(a) for a in jdec._quantize_kv(jnp.asarray(x.astype(np.float16))))
    sj = np.ascontiguousarray(np.swapaxes(s, -3, -2))  # [..., KV, S, SL]
    return (torch.from_numpy(q8), jnp.asarray(q8),
            torch.from_numpy(np.ascontiguousarray(sj[..., 0])), jnp.asarray(sj))


def _close(got: torch.Tensor, want, atol=DEC_ATOL):
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("hd", [64, 128])
def test_decode_plain_fp16_matches_pallas(form, hd):
    r = np.random.RandomState(hd + len(form))
    q = r.randn(B, 1, H, hd).astype(np.float16)
    k, jk, ks, jks = _cache(r, (B, SMAX, KV, hd), form)
    v, jv, vs, jvs = _cache(r, (B, SMAX, KV, hd), form)
    cl = np.array([0, 77, 255], np.int32)
    scales = {} if ks is None else dict(k_scale=jks, v_scale=jvs)
    want = decode_attention_kernel(jnp.asarray(q), jk, jv, jnp.asarray(cl), interpret=True,
                                   **scales)
    before = dict(dec.launches)
    got = dec.decode_attention(torch.from_numpy(q), k, v, torch.from_numpy(cl),
                               *(() if ks is None else (ks, vs)))
    assert dec.launches == before  # CPU tensors take the plain version
    _close(got, want)


@pytest.mark.parametrize("form", FORMS)
def test_paged_plain_fp16_matches_pallas(form):
    """Shuffled physical pages, NULL tails, ragged frontiers and a -1
    (zeros in the port; the JAX kernel's row is checked where it attends)."""
    r = np.random.RandomState(7 + len(form))
    hd = 64
    q = r.randn(N, 1, H, hd).astype(np.float16)
    k, jk, ks, jks = _cache(r, (P + 1, PS, KV, hd), form)
    v, jv, vs, jvs = _cache(r, (P + 1, PS, KV, hd), form)
    frontier = np.array([5, 29, -1], np.int32)
    perm = r.permutation(P).astype(np.int32)
    table = np.full((N, MP), P, np.int32)
    for n, f in enumerate(frontier):
        used = -(-(f + 1) // PS) if f >= 0 else 0
        table[n, :used] = perm[n * MP:n * MP + used]
    scales = {} if ks is None else dict(k_scale=jks, v_scale=jvs)
    want = np.asarray(paged_decode_attention_kernel(
        jnp.asarray(q), jk, jv, jnp.asarray(frontier), jnp.asarray(table), interpret=True,
        **scales), np.float32)
    got = dec.paged_decode_attention(torch.from_numpy(q), k, v, torch.from_numpy(frontier),
                                     torch.from_numpy(table),
                                     *(() if ks is None else (ks, vs)))
    _close(got[:2], want[:2])
    assert not bool(got[2].any())
    # the paged plain version is the dense one over the gathered view, bitwise
    gathered = (dec.gather_pages(k, torch.from_numpy(table)),
                dec.gather_pages(v, torch.from_numpy(table)))
    sc = () if ks is None else (dec.gather_page_scales(ks, torch.from_numpy(table)),
                                dec.gather_page_scales(vs, torch.from_numpy(table)))
    assert torch.equal(got, dec.decode_attention(torch.from_numpy(q), *gathered,
                                                 torch.from_numpy(frontier), *sc))


@pytest.mark.parametrize("form", FORMS)
def test_window_rows_fp16(form):
    """A verify window of 5 tokens as decode rows (``rows_per_seq``, the
    card's verify path): each token within DEC_ATOL of single-token decode
    at its position and of the contiguous plain window, and bitwise the same
    window over a cache twice as long (the rows depend on the sequence's
    bytes up to the frontier alone)."""
    r = np.random.RandomState(11 + len(form))
    hd = 64
    qw = torch.from_numpy(r.randn(1, 5, H, hd).astype(np.float16))
    k, _, ks, _ = _cache(r, (1, 2 * SMAX, KV, hd), form)
    v, _, vs, _ = _cache(r, (1, 2 * SMAX, KV, hd), form)
    sc = (None, None) if ks is None else (ks, vs)
    half = (k[:, :SMAX], v[:, :SMAX]) + ((None, None) if ks is None else
                                          (ks[..., :SMAX], vs[..., :SMAX]))
    win = pdec._window_rows(qw, *half[:2], 100, None, None, *half[2:], kernel=True)
    assert torch.equal(win, pdec._window_rows(qw, k, v, 100, None, None, *sc, kernel=True))
    for s in range(5):
        _close(win[:, s:s + 1], dec.decode_attention(qw[:, s:s + 1], k, v, 100 + s,
                                                     *sc).float().numpy())
    _close(win, dec.cached_attention_plain(qw, k, v, 100, *sc).float().numpy())


def _bloom_layer():
    """(jax config, port config, one BLOOM layer's attention params as fp32
    numpy with its biases perturbed)."""
    jm = jax_bloom("bloom-tiny", vocab_size=256, num_layers=1)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    attn = {k: np.array(v[0]) for k, v in params["layers"]["attn"].items()}
    r = np.random.RandomState(0)
    for name in ("bq", "bk", "bv", "bo"):
        attn[name] = attn[name] + 0.1 * r.randn(*attn[name].shape).astype(np.float32)
    return jm.config, port_config(jm.config), attn


@pytest.mark.parametrize("S,frontier", [(1, [0, 17, 63]), (3, [5, 40, 61])])
def test_alibi_fp16_matches_jax_xla(S, frontier):
    jcfg, pcfg, attn = _bloom_layer()
    r = np.random.RandomState(S + 20)
    x = r.randn(B, S, jcfg.hidden_size).astype(np.float16)
    shape = (B, 64, jcfg.kv_heads, jcfg.hd)
    kc, vc = (r.randn(*shape).astype(np.float16) for _ in range(2))
    cache_len = np.array(frontier, np.int32)
    positions = jnp.asarray(cache_len)[:, None] + jnp.arange(S)[None, :]
    jp = {k: jnp.asarray(v, jnp.float16) for k, v in attn.items()}
    want, k_new, v_new = jax.jit(functools.partial(jdec._cached_attention, jcfg))(
        jp, jnp.asarray(x), positions, jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(cache_len, jnp.int32))
    p = {k: torch.from_numpy(v).half() for k, v in attn.items()}
    tk, tv = torch.from_numpy(kc).clone(), torch.from_numpy(vc).clone()
    with attention_impl("flash"):  # the decode rows' plain twin, as on the card
        got = pdec._cached_attention(pcfg, p, torch.from_numpy(x), None, tk, tv,
                                     torch.from_numpy(cache_len),
                                     slopes=model_slopes(pcfg, "cpu"))
    _close(got, want, atol=4e-3)
    _within_an_ulp(tk, k_new)
    _within_an_ulp(tv, v_new)


def _packed(shape, bits, seed):
    w = (np.random.RandomState(seed).randn(*shape) * 0.05).astype(np.float16)
    return (jq.pack_quantize_blockwise(jnp.asarray(w), bits=bits),
            pq.pack_quantize_blockwise(torch.from_numpy(w), bits=bits))


def _within_an_ulp(got: torch.Tensor, want):
    """Every element within one fp16 ulp of JAX's, at the larger of the two
    magnitudes (both sum in fp32 and round once to fp16, in another order),
    plus 2e-6 for a sum that cancels to near zero (the fp32 sums' own error:
    about 2^-24 of the terms' magnitudes, here ~20; one such element of
    9.5e-5 moved 2.4e-7)."""
    assert got.dtype == torch.float16
    g = got.float().numpy()
    w = np.asarray(want).astype(np.float32)
    ulp = np.spacing(np.maximum(np.abs(g), np.abs(w)).astype(np.float16)).astype(np.float32)
    assert (np.abs(g - w) <= ulp + 2e-6).all(), np.abs(g - w).max()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", [1, 5])
def test_matvec_plain_fp16_matches_pallas(bits, M):
    D, N_ = 512, 256
    jw, pw = _packed((D, N_), bits, seed=M + bits)
    assert pw.dtype == torch.float16 and pw.nibbles == (bits == 4)
    x = np.random.RandomState(M).randn(M, D).astype(np.float16)
    want = jqm._packed_matvec(jnp.asarray(x), jw.qdata, jw.scale, block_n=128,
                              nibbles=jw.nibbles)
    assert want.dtype == jnp.float16
    before = dict(pqm.launches)
    _within_an_ulp(pqm.packed_matvec(torch.from_numpy(x), pw), want)
    assert pqm.launches == before


@pytest.mark.parametrize("bits", [8, 4])
def test_expert_matvec_plain_fp16_matches_pallas(bits):
    E, C, D, N_ = 4, 3, 512, 256
    jw, pw = _packed((E, D, N_), bits, seed=bits + 40)
    x = np.random.RandomState(bits).randn(E, C, D).astype(np.float16)
    x[1] = 0.0  # an unrouted expert's rows
    want = jqm._packed_expert_matvec_local(jnp.asarray(x), jw.qdata, jw.scale,
                                           nibbles=jw.nibbles, block_n=128)
    got = pqm.packed_expert_matvec(torch.from_numpy(x), pw)
    _within_an_ulp(got, want)
    assert not bool(got[1].any())


def _half(bits: np.ndarray) -> np.ndarray:
    return bits.astype(np.uint16).view(np.float16)


def test_fp16_magic_conversions_are_exact():
    """``csrc/quantized_matvec.cuh``'s fp16 conversions, in fp16 arithmetic:
    (0x6400 | (b & 0x7f)) - (0x6400 | (b & 0x80)) is int8(b) for every byte,
    ((n & 0xf) ^ 0x6408) - 0x6408 is the signed nibble (n ^ 8) - 8 for every
    nibble, each with one fp16 subtraction (round to nearest even)."""
    b = np.arange(256, dtype=np.uint16)
    got = _half(0x6400 | (b & 0x7F)) - _half(0x6400 | (b & 0x80))
    assert got.dtype == np.float16
    np.testing.assert_array_equal(got.astype(np.float32),
                                  b.astype(np.uint8).view(np.int8).astype(np.float32))
    n = np.arange(16, dtype=np.uint16)
    got4 = _half((n & 0xF) ^ 0x6408) - _half(np.full(16, 0x6408, np.uint16))
    np.testing.assert_array_equal(got4.astype(np.float32),
                                  ((n ^ 8).astype(np.int32) - 8).astype(np.float32))
    # the nibble a value v is stored as, (v + 8) ^ 8 (its low 4 bits), comes
    # back as v
    v = np.arange(-8, 8)
    stored = ((v + 8) ^ 8).astype(np.uint16)
    back = _half((stored & 0xF) ^ 0x6408) - _half(np.full(16, 0x6408, np.uint16))
    np.testing.assert_array_equal(back.astype(np.int32), v)
