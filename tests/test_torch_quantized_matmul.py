"""Quantized matvec: the port's plain version (what the CUDA kernel computes)
against the JAX package's Pallas ``_packed_matvec`` in interpret mode, fp32,
rtol 1e-5; and ``packed_proj``'s dispatch (dense weight, the matvec under
the row threshold, the dense product over the dequantized weight above it)
against the JAX ``packed_proj``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import quantizer as jq
from deepspeed_tpu.ops.pallas import quantized_matmul as jqm
from deepspeed_tpu_torch.ops import quantizer as pq
from deepspeed_tpu_torch.ops.cuda import quantized_matmul as pqm


def _packed(D, N, bits, seed=0):
    w = np.random.RandomState(seed).randn(D, N).astype(np.float32) * 0.05
    return (jq.pack_quantize_blockwise(jnp.asarray(w), bits=bits),
            pq.pack_quantize_blockwise(torch.from_numpy(w), bits=bits))


def _x(M, D, seed=1):
    return np.random.RandomState(seed).randn(M, D).astype(np.float32)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", [1, 4, 8])
def test_plain_matches_pallas_kernel(bits, M):
    D, N = 512, 256
    jw, pw = _packed(D, N, bits, seed=M)
    assert pw.nibbles == (bits == 4)
    x = _x(M, D, seed=M + 10)
    want = np.asarray(jqm._packed_matvec(jnp.asarray(x), jw.qdata, jw.scale,
                                         block_n=128, nibbles=jw.nibbles))
    got = pqm.packed_matvec_plain(torch.from_numpy(x), pw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_wrapper_takes_the_plain_version_on_cpu_without_counting():
    _, pw = _packed(256, 128, 8)
    x = torch.from_numpy(_x(3, 256))
    before = dict(pqm.launches)
    assert torch.equal(pqm.packed_matvec(x, pw), pqm.packed_matvec_plain(x, pw))
    assert pqm.launches == before


@pytest.mark.parametrize("rows,scope", [(4, None), (10, None), (10, 16), (3, 0)])
def test_packed_proj_dispatch_matches_jax(rows, scope):
    """Under the threshold the matvec, above it the dense product over the
    dequantized weight (both sides' own rule and scope)."""
    jw, pw = _packed(256, 384, 4, seed=rows)
    x = np.random.RandomState(rows).randn(1, rows, 256).astype(np.float32)
    with jqm.matvec_max_rows_scope(scope):
        want = np.asarray(jqm.packed_proj(jnp.asarray(x), jw))
    calls = []
    real = pqm.packed_matvec
    with pqm.matvec_max_rows_scope(scope):
        assert pqm.matvec_max_rows() == (8 if scope is None else scope)
        try:
            pqm.packed_matvec = lambda *a: calls.append(1) or real(*a)
            got = pqm.packed_proj(torch.from_numpy(x), pw)
        finally:
            pqm.packed_matvec = real
    assert bool(calls) == (rows <= (8 if scope is None else scope))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert pqm.matvec_max_rows() == 8


def test_packed_proj_dense_weight_and_unaligned_columns():
    x = torch.randn(2, 3, 128, generator=torch.Generator().manual_seed(0))
    w = torch.randn(128, 64, generator=torch.Generator().manual_seed(1))
    assert torch.equal(pqm.packed_proj(x, w), x @ w)
    # 64 columns are off the 128 grid: the JAX rule dequantizes on the CPU
    pw = pq.pack_quantize_blockwise(w, bits=8)
    torch.testing.assert_close(pqm.packed_proj(x, pw), x @ pw.dequantize(),
                               rtol=0, atol=0)


@pytest.mark.parametrize("planes,tiles", [(32, 8), (32, 112), (16, 112), (112, 32),
                                          (1, 1), (3, 200), (2, 2), (56, 32), (13, 50),
                                          (40, 1)])
def test_split_plan_covers_every_plane(planes, tiles):
    """Every plane in one split and no split empty; at most a cluster's
    blocks on a tile; a block's warps take equal shares above WARPS planes;
    and at least half the blocks the target asks for (rounding a split up to
    a multiple of WARPS planes gives up no more)."""
    splits, per = pqm.split_plan(planes, tiles)
    assert (splits - 1) * per < planes <= splits * per
    assert 1 <= splits <= pqm.MAX_SPLITS
    assert per <= pqm.WARPS or per % pqm.WARPS == 0
    want = min(planes, pqm.MAX_SPLITS, -(-pqm.TARGET_BLOCKS // tiles))
    assert 2 * splits >= want
