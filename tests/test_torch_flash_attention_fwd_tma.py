"""The flash forward kernel's host side and its oracle, on the CPU.

The kernel (``csrc/flash_attention_fwd.cu``) runs only on the card. Here:

* its tensor maps, from the functions the wrapper sizes them with
  (``ops/cuda/flash_attention.py``: ``fwd_tma_maps``, ``ring_tile``,
  ``bias_tma_map``): dims, byte strides, boxes and start addresses, which
  ``csrc/flash_attention_sm90.cuh:encode_rows_map`` and ``encode_bias_map``
  encode from the same strides; the map reaches every element where torch
  keeps it;
* the layouts TMA refuses, on which the forward's host-side check raises
  (CPU tensors: the check is arithmetic), and the padded copy the wrapper
  makes of a bias whose rows TMA cannot step through;
* the kernel's oracle on the card, ``flash_attention_plain``, against the
  JAX package's Pallas ``_fwd_kernel`` (via ``_flash_fwd``) in interpret
  mode, on inputs made from one numpy seed, at the edges the kernel's tile
  classes turn on: segment boundaries on multiples of 128 and inside a tile,
  ragged S (whole-sequence Pallas blocks), GQA groups 1, 4 and 8, head dims
  64 and 128, a broadcast dense bias, and the diagonal, a past and a future
  ring hop with ALiBi and segment ids. fp32 throughout; out and lse within
  2e-5 absolute (the same sums in another order), and the future hop's out
  exactly 0 and lse exactly -1e30 in both.
"""

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

TOL = 2e-5


def _addresses(base, esize, strides, shape):
    """Byte address of every element [i3, i2, i1, i0] of a map with these
    strides (the innermost dim contiguous)."""
    idx = np.meshgrid(*(np.arange(n) for n in shape), indexing="ij")
    return base + esize * idx[3] + sum(st * i for st, i in zip(strides, idx[2::-1]))


def _torch_addresses(t: torch.Tensor) -> np.ndarray:
    idx = np.meshgrid(*(np.arange(n) for n in t.shape), indexing="ij")
    return t.data_ptr() + t.element_size() * sum(st * i for st, i in zip(t.stride(), idx))


# ---------------------------------------------------------------------------
# tensor maps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("form", ["llama", "masked", "bias"])
def test_fwd_maps_numbers(D, form):
    # q the slice of a fused [B, S, 3H, D] projection, k and v contiguous
    q = torch.zeros(2, 37, 3 * 8, D, dtype=torch.bfloat16).narrow(2, 8, 8)
    k = torch.zeros(2, 37, 2, D, dtype=torch.bfloat16)
    v = torch.zeros(2, 37, 2, D, dtype=torch.bfloat16)
    bias = torch.zeros(1, 8, 37, 40)[..., :37] if form == "bias" else None
    maps = fa.fwd_tma_maps("test", q, k, v, bias, masked=form == "masked")
    keys = fa.ring_tile(D, form != "llama")  # FwdSmem::kBN, the k and v boxes
    for name, t, rows in (("q", q, fa.TMA_ROWS), ("k", k, keys), ("v", v, keys)):
        m = maps[name]
        B, S, H, _ = t.shape
        assert m["dims"] == (D, S, H, B)
        assert m["box"] == (fa.TMA_BOX_COLS, rows, 1, 1)
        assert m["strides"] == (2 * t.stride(1), 2 * t.stride(2), 2 * t.stride(0))
        np.testing.assert_array_equal(
            _addresses(m["base"], 2, m["strides"], (B, H, S, D)),
            _torch_addresses(t.permute(0, 2, 1, 3)))
    assert ("bias" in maps) == (form == "bias")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 4, 64, 64), (3, 1, 64, 64), (3, 4, 64, 64),
                                   (1, 1, 64, 64)])
def test_bias_map_numbers(shape, dtype):
    B, H = 3, 4
    bias = torch.zeros(shape, dtype=dtype)
    m = fa.bias_tma_map("test", bias, B, H)
    esize = bias.element_size()
    S = shape[-1]
    dims = (S, S, H if shape[1] > 1 else 1, B if shape[0] > 1 else 1)
    assert m["dims"] == dims
    assert m["box"] == (128 // esize, fa.TMA_ROWS, 1, 1)
    assert all(st % 16 == 0 and st > 0 for st in m["strides"])
    # the map reaches every element where torch keeps it; a broadcast dim
    # is read at coordinate 0
    got = _addresses(m["base"], esize, m["strides"], dims[::-1])
    np.testing.assert_array_equal(got, _torch_addresses(bias))


def test_bias_map_expanded_view():
    # an expand()ed bias (stride 0 on the batch and head dims) is a broadcast
    base = torch.zeros(1, 1, 64, 64)
    bias = base.expand(3, 4, 64, 64)
    m = fa.bias_tma_map("test", bias, 3, 4)
    assert m["dims"] == (64, 64, 1, 1)
    assert m["strides"] == (256, 256 * 64, 256 * 64)


@pytest.mark.parametrize("dtype,S", [(torch.float32, 130), (torch.bfloat16, 37),
                                     (torch.float32, 64)])
def test_tma_bias_pads_rows(dtype, S):
    bias = torch.from_numpy(np.random.RandomState(3).randn(2, 1, S, S).astype(np.float32))
    bias = bias.to(dtype)
    got = fa.tma_bias(bias, 2, 4)
    assert torch.equal(got, bias)
    fa.bias_tma_map("test", got, 2, 4)  # takes the result
    if (S * bias.element_size()) % 16 == 0:
        assert got is bias  # no copy when TMA can read it
    else:
        assert got.stride(2) * got.element_size() % 16 == 0
        with pytest.raises(ValueError, match="multiples of 16"):
            fa.bias_tma_map("test", bias, 2, 4)


def _misaligned_start():
    # a 64-wide window that starts 8 bytes into each row
    return torch.zeros(2, 16, 4, 72, dtype=torch.bfloat16)[..., 4:68]


def _odd_row_stride():
    # rows 4 elements (8 bytes) longer than the heads: not a multiple of 16 bytes
    return torch.zeros(2, 16, 4 * 64 + 4, dtype=torch.bfloat16)[..., :256].view(2, 16, 4, 64)


def _strided_last_dim():
    return torch.zeros(2, 16, 4, 128, dtype=torch.bfloat16)[..., ::2]


def _partial_box():
    return torch.zeros(2, 16, 4, 96, dtype=torch.bfloat16)


@pytest.mark.parametrize("which", ["q", "k", "v"])
@pytest.mark.parametrize("make,what", [(_misaligned_start, "16-byte aligned"),
                                       (_odd_row_stride, "multiples of 16"),
                                       (_strided_last_dim, "not contiguous"),
                                       (_partial_box, "whole boxes")])
def test_fwd_maps_refuse(which, make, what):
    bad = make()
    good = torch.zeros(bad.shape, dtype=torch.bfloat16)
    args = {n: bad if n == which else good for n in ("q", "k", "v")}
    with pytest.raises(ValueError, match=what):
        fa.fwd_tma_maps("flash_attention_fwd", args["q"], args["k"], args["v"])


@pytest.mark.parametrize("make,what", [
    (lambda: torch.zeros(1, 2, 64, 128)[..., ::2], "not contiguous"),
    (lambda: torch.zeros(1, 2, 64 * 64 + 1)[..., 1:].view(1, 2, 64, 64), "16-byte aligned"),
    (lambda: torch.zeros(1, 2, 64, 1).expand(1, 2, 64, 64), "not contiguous")])
def test_bias_map_refuses(make, what):
    q = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=what):
        fa.fwd_tma_maps("flash_attention_fwd", q, q, q, make())


# ---------------------------------------------------------------------------
# the oracle against the Pallas kernel
# ---------------------------------------------------------------------------
def _docs(B, S, lengths):
    """[B, S] int32 segment ids of documents of these lengths (the last
    running to S), the second row's boundaries 32 tokens later."""
    seg = np.zeros((B, S), np.int32)
    for row in range(B):
        at = 0
        for i, n in enumerate(lengths):
            n = n + 32 * (row % 2 and i == 0)
            seg[row, at:at + n] = i
            at += n
        seg[row, at:] = len(lengths)
    return seg


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _pallas(causal, block, has_seg, alibi, q, k, v, bias, seg_q, seg_k, offsets):
    sw = lambda t: jnp.swapaxes(t, 1, 2)  # noqa: E731
    seg = (seg_q, seg_k) if has_seg else None
    slopes = jnp.asarray(jax_alibi_slopes(q.shape[2])) if alibi else None
    o, lse = jfa._flash_fwd(sw(q), sw(k), sw(v), bias, seg, slopes, None, offsets,
                            causal=causal, scale=1.0 / q.shape[-1] ** 0.5, block_q=block,
                            block_k=block, interpret=True)
    return sw(o), lse[..., 0]


# name: (B, S, H, KV, D, causal, segment lengths or None, bias shape or None,
#        alibi, offsets or None)
CASES = {
    "ragged 130 group 1": (1, 130, 8, 8, 64, True, None, None, False, None),
    "ragged 130 group 4 D128": (2, 130, 8, 2, 128, True, None, None, False, None),
    "ragged 300 group 8 non-causal": (1, 300, 8, 1, 64, False, None, None, False, None),
    "ragged 300 group 8 D128": (2, 300, 16, 2, 128, True, None, None, False, None),
    # boundaries at 128 and 192 (tile edges) and inside a tile (392, 420)
    "segments D64": (2, 512, 8, 2, 64, True, (128, 64, 200, 28), None, False, None),
    "segments D128 non-causal": (2, 512, 8, 8, 128, False, (128, 64, 200, 28), None, False,
                                 None),
    "bias [1,H,S,S] + segments": (2, 256, 4, 4, 64, True, (100, 28), (1, 4), False, None),
    "bias [B,1,S,S] D128": (2, 256, 4, 1, 128, False, None, (2, 1), False, None),
    "diagonal hop alibi + segments": (2, 256, 4, 2, 64, True, (200, 100), None, True,
                                      (256, 256)),
    "past hop alibi + segments": (2, 256, 4, 2, 64, True, (200, 100), None, True, (256, 0)),
    "future hop alibi + segments": (2, 256, 4, 2, 64, True, (200, 100), None, True,
                                    (0, 256)),
    "past hop group 8": (1, 256, 8, 1, 128, True, None, None, False, (256, 0)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas(name):
    B, S, H, KV, D, causal, docs, bias_bh, alibi, offsets = CASES[name]
    r = np.random.RandomState(21)
    q = r.randn(B, S, H, D).astype(np.float32)
    k, v = (r.randn(B, S, KV, D).astype(np.float32) for _ in range(2))
    bias = None if bias_bh is None else r.randn(*bias_bh, S, S).astype(np.float32)
    seg_q = seg_k = None
    if docs is not None:
        full = _docs(B, 2 * S if offsets else S, docs)
        i, j = (offsets[0] // S, offsets[1] // S) if offsets else (0, 0)
        seg_q, seg_k = full[:, i * S:(i + 1) * S], full[:, j * S:(j + 1) * S]
    block = 128 if S % 128 == 0 else S
    o_want, lse_want = _pallas(
        causal, block, docs is not None, alibi, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias),
        None if seg_q is None else jnp.asarray(seg_q),
        None if seg_k is None else jnp.asarray(seg_k),
        None if offsets is None else jnp.asarray([offsets], jnp.int32))
    seg = None if seg_q is None else (torch.from_numpy(seg_q), torch.from_numpy(seg_k))
    o, lse = fa.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal,
        alibi_slopes(H) if alibi else None,
        None if bias is None else torch.from_numpy(bias), seg, None, offsets)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_want), atol=TOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_want), atol=TOL, rtol=0)
    if name.startswith("future"):  # the chunk lies wholly ahead: nothing is visible
        assert not o.numpy().any() and not np.asarray(o_want).any()
        assert (lse.numpy() == np.float32(-1e30)).all()
        assert (np.asarray(lse_want) == np.float32(-1e30)).all()
