"""The fp16 forms of the LayerNorm and flash kernels: the port's plain
versions in fp16 (what a CPU tensor takes; each fp16 kernel's function on the
card) against the JAX package's Pallas kernels run in fp16 in interpret mode.

- LayerNorm forward and backward (``ops/pallas/layernorm.py``), fp16 x, scale
  and bias (the fp16 GPT-2 and BLOOM models' pair): out and dx within two
  fp16 ulps (atol 1e-3, rtol 2e-3), dscale and dbias (fp32 here, which the
  autograd Function casts to the scale's fp16 as the Pallas VJP returns them)
  likewise.
- The flash forward, dq and dk/dv (``_flash_fwd``, ``_flash_bwd``) in every
  form the fp16 training paths launch: ALiBi slopes, segment ids, a full fp32
  bias with segment ids (BLOOM's packed positions bias: its gradient from the
  dq kernel, ``emit_dbias``), a broadcast fp16 bias (a caller's; its gradient
  from ``_bias_grad_kernel``), a block-sparse layout, and a ring hop's
  position offsets with ALiBi and with a (query, key) segment-id pair. B=2,
  H=4, KV=2, D=64, S=256, causal. Tolerances as for the Llama form
  (``tests/test_torch_fp16.py``): out within 2e-3 (the Pallas kernels round p
  to fp16 before P V, the plain versions keep it fp32), lse within 1e-4,
  dq, dk, dv and dbias within 5e-3 of their largest element. A query row
  that sees no key (the hop's rows whose segment the visiting chunk lacks)
  gives out 0 and lse -1e30 on both sides: the mask value stays fp32's
  finite -1e30 in the scores of both packages, whatever the inputs' dtype.

About 20-30 s in one process, mostly the Pallas kernels' interpret-mode
compiles, one a form.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.transformer import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu.ops.pallas import flash_attention as jfa
from deepspeed_tpu.ops.pallas.layernorm import layernorm as pallas_layernorm
from deepspeed_tpu_torch.models.transformer import alibi_slopes
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
from deepspeed_tpu_torch.ops.cuda import layernorm as ln

B, H, KV, D, S = 2, 4, 2, 64, 256
OUT_ATOL, LSE_ATOL, GRAD_RTOL = 2e-3, 1e-4, 5e-3
LAYOUT = np.array([[1, 0], [1, 1]], np.int32)  # two 128-token blocks, causal
# name: (alibi, segment ids, bias (shape, dtype) or None, sparse, offsets)
FORMS = {
    "alibi": (True, False, None, False, None),
    "seg": (False, True, None, False, None),
    "bias_full_fp32_seg": (False, True, ((B, H), np.float32), False, None),
    "bias_heads_fp16": (False, False, ((1, H), np.float16), False, None),
    "sparse": (False, False, None, True, None),
    "alibi_offsets": (True, False, None, False, (S, 0)),
    "seg_offsets": (False, True, None, False, (S, 0)),
}


def _inputs(name):
    r = np.random.RandomState(sum(map(ord, name)))
    q, do = (r.randn(B, S, H, D).astype(np.float16) for _ in range(2))
    k, v = (r.randn(B, S, KV, D).astype(np.float16) for _ in range(2))
    return q, k, v, do


def _segments(offsets):
    """[B, S] int32 ids, boundaries inside the 128-row tiles; with offsets a
    (query ids, key ids) pair in which the queries' last segment (from row
    180 of batch row 0) is not among the visiting keys: those rows see no
    key."""
    seg = np.zeros((B, S), np.int32)
    seg[0, 50:150], seg[0, 150:] = 1, 2
    seg[1, 135:] = 1
    if offsets is None:
        return seg
    seg_q = seg.copy()
    seg_q[0, 180:] = 7
    return seg_q, seg


def _bias(spec):
    shape, dtype = spec
    return (0.5 * np.random.RandomState(11).randn(*shape, S, S)).astype(dtype)


@functools.lru_cache(maxsize=None)
def _pallas(name):
    """(out, lse, dq, dk, dv, dbias or None) of the Pallas kernels in fp16 in
    interpret mode, fp32 numpy, [B, S, H, D] layouts."""
    alibi, has_seg, bias, sparse, offsets = FORMS[name]
    q, k, v, do = (jnp.asarray(a) for a in _inputs(name))
    seg = None
    if has_seg:
        ids = _segments(offsets)
        seg = tuple(map(jnp.asarray, ids)) if offsets else jnp.asarray(ids)
    b = jnp.asarray(_bias(bias)) if bias else None
    slopes = jnp.asarray(jax_alibi_slopes(H)) if alibi else None
    tables = None
    if sparse:
        tables = tuple(jnp.asarray(t) for t in (*jfa._compact_rows(LAYOUT),
                                                *jfa._compact_rows(LAYOUT.T)))
    offs = jnp.asarray([offsets], jnp.int32) if offsets else None
    sw = lambda t: jnp.swapaxes(t, 1, 2)  # noqa: E731
    kw = dict(causal=True, scale=1.0 / D ** 0.5, block_q=128, block_k=128, interpret=True)

    @jax.jit
    def run(q, k, v, do, b):
        o, lse = jfa._flash_fwd(sw(q), sw(k), sw(v), b, seg, slopes, tables, offs, **kw)
        dq, dk, dv, db = jfa._flash_bwd(sw(q), sw(k), sw(v), o, lse, sw(do), b, seg, slopes,
                                        tables, offs, **kw)
        return sw(o), lse[..., 0], sw(dq), sw(dk), sw(dv), db

    return [None if t is None else np.asarray(t, np.float32) for t in run(q, k, v, do, b)]


def _port(name):
    alibi, has_seg, bias, sparse, offsets = FORMS[name]
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(name))
    seg = None
    if has_seg:
        ids = _segments(offsets)
        seg = tuple(map(torch.from_numpy, ids)) if offsets else torch.from_numpy(ids)
    b = torch.from_numpy(_bias(bias)) if bias else None
    slopes = alibi_slopes(H) if alibi else None
    layout = LAYOUT if sparse else None
    out, lse = fa.flash_attention_fwd(q, k, v, True, slopes, b, seg, layout, offsets)
    emit = b is not None and tuple(b.shape[:2]) == (B, H)
    dq, delta, *db = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, True, slopes, b, seg,
                                               layout, emit, offsets)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, True, slopes, b, seg, layout,
                                        offsets)
    if b is not None and not emit:
        db = [fa.flash_attention_bias_grad(q, k, v, b, lse, delta, do, True, slopes, seg)]
    assert all(t.dtype == torch.float16 for t in (out, dq, dk, dv))
    if b is not None:
        assert db[0].dtype == b.dtype
    return [t.float().numpy() for t in (out, lse, dq, dk, dv)] + \
        [db[0].float().numpy() if b is not None else None]


@pytest.mark.parametrize("name", list(FORMS))
def test_plain_fp16_flash_form_matches_pallas(name):
    got, want = _port(name), _pallas(name)
    np.testing.assert_allclose(got[0], want[0], atol=OUT_ATOL, rtol=0, err_msg="out")
    np.testing.assert_allclose(got[1], want[1], atol=LSE_ATOL, rtol=0, err_msg="lse")
    for n, g, w in zip(("dq", "dk", "dv", "dbias"), got[2:], want[2:]):
        if w is None:
            assert g is None, n
            continue
        assert np.isfinite(g).all(), n
        assert np.abs(g - w).max() <= GRAD_RTOL * np.abs(w).max(), n
    if name == "seg_offsets":  # rows 180.. of batch row 0 see no key
        for side in (got, want):
            assert not side[0][0, 180:].any()
            np.testing.assert_array_equal(side[1][0, :, 180:], np.float32(fa.NEG_INF))


def test_fp16_form_counter_names():
    """An fp16 form counts under its bf16 name plus ``_f16``; the Llama
    form keeps ``flash_attention_fwd_f16``."""
    f16 = torch.float16
    assert fa.form_suffix(None, dtype=f16) == "_f16"
    assert fa.form_suffix(torch.ones(1), dtype=f16) == "_alibi_f16"
    assert fa.form_suffix(None, torch.ones(1), 0, dtype=f16) == "_bias_seg_f16"
    assert fa.form_suffix(None, segment_ids=0, offsets=(1, 0), dtype=f16) == "_seg_offsets_f16"
    for name in ("flash_attention_fwd_alibi_f16", "flash_attention_bwd_dq_bias_seg_f16",
                 "flash_attention_bwd_dkv_sparse_f16", "flash_attention_fwd_offsets_f16",
                 "flash_attention_bias_grad_f16", "flash_attention_fwd_f16"):
        assert name in fa.launches
    assert {"layernorm_fwd_f16", "layernorm_bwd_f16"} <= set(ln.launches)


@pytest.mark.parametrize("D_norm", [128, 1024])
def test_plain_fp16_layernorm_matches_pallas(D_norm):
    r = np.random.RandomState(D_norm)
    x = r.randn(64, D_norm).astype(np.float16)
    w = (1 + 0.1 * r.randn(D_norm)).astype(np.float16)
    b = (0.1 * r.randn(D_norm)).astype(np.float16)
    g = r.randn(64, D_norm).astype(np.float16)
    tx, tw, tb, tg = (torch.from_numpy(a) for a in (x, w, b, g))
    out = ln.layernorm_fwd(tx, tw, tb)
    dx, ds, db = ln.layernorm_bwd(tx, tw, tg)
    jout, vjp = jax.vjp(lambda a, s, c: pallas_layernorm(a, s, c, 1e-5),
                        *(jnp.asarray(a) for a in (x, w, b)))
    jdx, jds, jdb = vjp(jnp.asarray(g))
    assert out.dtype == dx.dtype == torch.float16
    for got, want in ((out, jout), (dx, jdx), (ds.to(torch.float16), jds),
                      (db.to(torch.float16), jdb)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=1e-3, rtol=2e-3)


def test_fp16_layernorm_overflow_stays_inf():
    """dx past 65504 is inf, never clamped (the plain version rounds to
    nearest as the kernel does), so the loss scaler sees it."""
    x = torch.randn(4, 128).to(torch.float16)
    g = torch.full((4, 128), 6e4, dtype=torch.float16)
    g[:, ::2] = -6e4
    dx = ln.layernorm_bwd(x, torch.full((128,), 4.0, dtype=torch.float16), g)[0]
    assert torch.isinf(dx).any() and not torch.isnan(dx).any()
