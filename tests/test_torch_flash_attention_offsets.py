"""Flash attention's offset form (a ring attention hop): the port's plain
forward, dq and dk/dv with ``offsets=(qoff, koff)`` and a (query ids, key
ids) segment pair, on the CPU, against the JAX package's ``_flash_fwd`` and
``_flash_bwd`` with ``offsets=`` in interpret mode.

A global sequence of 512 tokens in two chunks of S=256 (two 128-row tiles):
the query chunk i against the key chunk blk at offsets (256 i, 256 blk), on
the diagonal hop (1, 1), a past hop (1, 0) and a future hop (0, 1), causal
and not; B=2, H=4, KV=2 (GQA), D=64, fp32; plain, ALiBi (BLOOM's slopes),
segment ids crossing the chunk edge, and both. The backward reads a given
lse and output (a merged ring's, finite on every row) and its delta
rowsum(do * out), as ``_rf_bwd`` hands them to each hop. Tolerances as
``tests/test_ring_flash.py`` states them for fp32: 2e-5 absolute on out and
lse, 1e-4 of the largest value on the gradients (fp32 sums in another
order). A future hop gives out 0 and lse -1e30 exactly, and exact zero
gradients, in both packages."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.transformer import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu.ops.pallas import flash_attention as jfa
from deepspeed_tpu_torch.models.transformer import alibi_slopes
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

B, S, H, KV, D = 2, 256, 4, 2, 64
TOL, GRAD_TOL = 2e-5, 1e-4
HOPS = {"diagonal": (1, 1), "past": (1, 0), "future": (0, 1)}
FORMS = {"plain": (False, False), "alibi": (True, False), "seg": (False, True),
         "alibi_seg": (True, True)}


def _inputs(i, blk):
    """Chunk i's q and do, chunk blk's k and v, a given out [B,S,H,D] and lse
    [B,H,S], and the chunks' segment ids (boundaries at 200 and 300 of the
    global sequence, and at 260 in row 1)."""
    r = np.random.RandomState(10 * i + blk)
    q, do, out = (r.randn(B, S, H, D).astype(np.float32) for _ in range(3))
    k, v = (r.randn(B, S, KV, D).astype(np.float32) for _ in range(2))
    lse = (3.0 + r.rand(B, H, S)).astype(np.float32)
    seg = np.zeros((B, 2 * S), np.int32)
    seg[0, 200:300], seg[0, 300:] = 1, 2
    seg[1, 260:] = 1
    return q, k, v, do, out, lse, seg[:, i * S:(i + 1) * S], seg[:, blk * S:(blk + 1) * S]


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def _pallas(causal, alibi, has_seg, q, k, v, do, out, lse, seg_q, seg_k, offsets):
    sw = lambda t: jnp.swapaxes(t, 1, 2)  # noqa: E731
    kw = dict(causal=causal, scale=1.0 / D ** 0.5, block_q=128, block_k=128,
              interpret=True)
    seg = (seg_q, seg_k) if has_seg else None
    slopes = jnp.asarray(jax_alibi_slopes(H)) if alibi else None
    o, l = jfa._flash_fwd(sw(q), sw(k), sw(v), None, seg, slopes, None, offsets, **kw)
    aux = lambda t: jnp.broadcast_to(t[..., None], (*t.shape, jfa.AUX_LANES))  # noqa: E731
    delta = jnp.sum(do * out, axis=-1).transpose(0, 2, 1)
    dq, dk, dv, _ = jfa._flash_bwd(sw(q), sw(k), sw(v), sw(out), aux(lse), sw(do), None, seg,
                                   slopes, None, offsets, delta=aux(delta), **kw)
    return sw(o), l[..., 0], sw(dq), sw(dk), sw(dv)


def _port(causal, alibi, has_seg, q, k, v, do, out, lse, seg_q, seg_k, offsets):
    t = [torch.from_numpy(a) for a in (q, k, v, do, out, lse)]
    q, k, v, do, out, lse = t
    seg = (torch.from_numpy(seg_q), torch.from_numpy(seg_k)) if has_seg else None
    slopes = alibi_slopes(H) if alibi else None
    o, l = fa.flash_attention_fwd(q, k, v, causal, slopes, segment_ids=seg, offsets=offsets)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, causal, slopes,
                                          segment_ids=seg, offsets=offsets)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, causal, slopes,
                                        segment_ids=seg, offsets=offsets)
    return [x.numpy() for x in (o, l, dq, dk, dv)]


def _both(hop, causal, form):
    i, blk = HOPS[hop]
    alibi, has_seg = FORMS[form]
    args = _inputs(i, blk)
    offsets = (i * S, blk * S)
    want = _pallas(causal, alibi, has_seg, *(jnp.asarray(a) for a in args),
                   jnp.asarray([offsets], jnp.int32))
    return _port(causal, alibi, has_seg, *args, offsets), [np.asarray(w) for w in want]


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("hop", sorted(HOPS))
def test_causal_hops_match_pallas(hop, form):
    got, want = _both(hop, True, form)
    for n, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        tol = TOL if n in ("out", "lse") else GRAD_TOL * np.abs(w).max()
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=f"{hop} {form} {n}")
    if hop == "future":  # the chunk lies wholly ahead: nothing is visible
        for n, g, w in zip(("out", "dq", "dk", "dv"), got[:1] + got[2:],
                           want[:1] + want[2:]):
            assert not g.any() and not w.any(), n
        assert (got[1] == np.float32(-1e30)).all() and (want[1] == np.float32(-1e30)).all()


@pytest.mark.parametrize("hop", ["past", "future"])
def test_non_causal_hops_match_pallas(hop):
    """Non-causal, every pair of the two chunks is visible: the offsets move
    only ALiBi's distance."""
    got, want = _both(hop, False, "alibi_seg")
    for n, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        tol = TOL if n in ("out", "lse") else GRAD_TOL * np.abs(w).max()
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=f"{hop} {n}")


def test_zero_offsets_equal_the_unshifted_form():
    """Offsets (0, 0) and one segment tensor for both sides are the form
    without offsets, bit for bit."""
    q, k, v, do, out, lse, seg, _ = _inputs(0, 0)
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    seg = torch.from_numpy(seg)
    a = fa.flash_attention_fwd(q, k, v, True, alibi_slopes(H), segment_ids=seg)
    b = fa.flash_attention_fwd(q, k, v, True, alibi_slopes(H), segment_ids=(seg, seg),
                               offsets=(0, 0))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_offset_form_names_and_refusals():
    """The launch counters name the offset form on its own; offsets do not
    combine with a dense bias or a block-sparse layout."""
    assert fa.form_suffix(None, offsets=(0, 0)) == "_offsets"
    assert fa.form_suffix(alibi_slopes(H), segment_ids=0, offsets=(1, 0)) == \
        "_alibi_seg_offsets"
    for name in ("fwd", "bwd_dq", "bwd_dkv"):
        for form in ("_offsets", "_seg_offsets", "_alibi_offsets", "_alibi_seg_offsets"):
            assert fa.launches[f"flash_attention_{name}{form}"] == 0
    meta = torch.empty(2, 256, 4, 64, device="meta")
    with pytest.raises(ValueError, match="offsets do not combine"):
        fa.mask_array("fwd", meta, bias=torch.zeros(1, 1, 256, 256, device="meta"),
                      offsets=(0, 256))
    arr = fa.mask_array("fwd", meta, offsets=(256, 512))
    assert len(arr) == 14 and list(arr)[12:] == [256, 512] and not any(list(arr)[:12])
