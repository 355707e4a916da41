"""The host-side arithmetic of the flash backward kernels' tensor maps
(``deepspeed_tpu_torch/ops/cuda/flash_attention.py:tma_map``): the dims, byte
strides, box and start address that ``csrc/flash_attention_sm90.cuh:
encode_rows_map`` encodes from the same strides, and the layouts TMA refuses,
on which the wrappers raise. No card is needed: the maps are plain numbers
here."""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.cuda import flash_attention as fa


def _addresses(t: torch.Tensor, m: dict) -> np.ndarray:
    """The byte address of every element of ``t`` [B, S, H, D] as the map
    reads it: start + 2 d + stride_s s + stride_h h + stride_b b."""
    B, S, H, D = t.shape
    st_s, st_h, st_b = m["strides"]
    b, s, h, d = np.meshgrid(np.arange(B), np.arange(S), np.arange(H), np.arange(D),
                             indexing="ij")
    return m["base"] + t.element_size() * d + st_s * s + st_h * h + st_b * b


def _torch_addresses(t: torch.Tensor) -> np.ndarray:
    B, S, H, D = t.shape
    b, s, h, d = np.meshgrid(np.arange(B), np.arange(S), np.arange(H), np.arange(D),
                             indexing="ij")
    off = sum(st * i for st, i in zip(t.stride(), (b, s, h, d)))
    return t.data_ptr() + t.element_size() * off


def _contiguous():
    return torch.zeros(2, 37, 4, 64, dtype=torch.bfloat16)


def _fused_q():
    # the q slice of a fused [B, S, 3H, D] projection
    return torch.zeros(2, 37, 3 * 4, 128, dtype=torch.bfloat16).narrow(2, 4, 4)


def _kv_heads():
    return torch.zeros(3, 130, 2, 64, dtype=torch.bfloat16)


def _batch_one():
    return torch.zeros(1, 300, 8, 128, dtype=torch.bfloat16)


@pytest.mark.parametrize("make,rows", [(_contiguous, fa.TMA_ROWS),
                                       (_fused_q, fa.ring_tile(128, False)),
                                       (_kv_heads, fa.TMA_ROWS),
                                       (_batch_one, fa.ring_tile(64, False))])
def test_tma_map_numbers(make, rows):
    t = make()
    B, S, H, D = t.shape
    m = fa.tma_map("test", "t", t, rows)
    assert m["dims"] == (D, S, H, B)
    assert m["box"] == (fa.TMA_BOX_COLS, rows, 1, 1)
    assert m["strides"] == (2 * t.stride(1), 2 * t.stride(2), 2 * t.stride(0))
    assert m["base"] == t.data_ptr() and m["base"] % 16 == 0
    assert all(st % 16 == 0 for st in m["strides"])
    # the map reaches every element where torch keeps it
    np.testing.assert_array_equal(_addresses(t, m), _torch_addresses(t))


@pytest.mark.parametrize("head_dim,masked,rows", [(64, False, 128), (64, True, 64),
                                                  (128, False, 64), (128, True, 64)])
def test_ring_tile(head_dim, masked, rows):
    # the kernels' ring tiles (DqSmem::kBN, DkvSmem::kBQ), which the maps' boxes take
    assert fa.ring_tile(head_dim, masked) == rows


def test_tma_map_fused_projection_offsets():
    fused = torch.zeros(2, 37, 12, 128, dtype=torch.bfloat16)
    for i, part in enumerate(fused.split(4, dim=2)):
        m = fa.tma_map("test", "q", part, fa.TMA_ROWS)
        assert m["base"] - fused.data_ptr() == i * 4 * 128 * 2
        assert m["strides"] == (12 * 128 * 2, 128 * 2, 37 * 12 * 128 * 2)


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


@pytest.mark.parametrize("make,what", [(_misaligned_start, "16-byte aligned"),
                                       (_odd_row_stride, "multiples of 16"),
                                       (_strided_last_dim, "not contiguous"),
                                       (_partial_box, "whole boxes")])
def test_tma_map_refuses(make, what):
    with pytest.raises(ValueError, match=what):
        fa.tma_map("flash_attention_bwd_dq", "q", make(), fa.TMA_ROWS)


def test_tma_map_refuses_tall_box():
    with pytest.raises(ValueError, match="box rows"):
        fa.tma_map("test", "q", _contiguous(), 512)
