"""The packed matvec's arithmetic order (``csrc/quantized_matvec.cu``) as a
plain fp32 torch mirror: the contraction in byte planes of Bq rows, split
over the blocks of a cluster by ``split_plan`` (split ``sp`` owns planes
``[sp * per, min(Gp, (sp + 1) * per))``), warp w of a block taking planes
``p0 + w, p0 + w + 4, ...``; each Bq-row group's product x·q into a zeroed
fp32 sum, then scaled by s[g, n] and added to the warp's running sum (int4:
the plane's low block, then its high block); the block's warps added in
warp order, the splits in rank order; a split whose rows of x are all zero
over its contraction range (-0.0 included) contributes +0 without reading
its bytes. Held, in fp32, against the port's plain versions (x·(q·s), the
TPU fold) and against the JAX package's Pallas ``_packed_matvec`` /
``_packed_expert_matvec_local`` in interpret mode, within rtol 1e-5 and
1e-5 of the largest output (the two folds round their fp32 products
apart); int8 and int4, M in {1, 5, 16}, Bq = 128 and Bq = D."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import quantizer as jq
from deepspeed_tpu.ops.pallas import quantized_matmul as jqm
from deepspeed_tpu_torch.ops import quantizer as pq
from deepspeed_tpu_torch.ops.cuda import quantized_matmul as pqm

COLS = 128  # columns of a block's strip


def _value_planes(qdata: torch.Tensor, nibbles: bool):
    """The int values of each byte plane, per block the plane holds: int8
    [(q)], int4 split-half [(low nibbles), (high nibbles)]."""
    if not nibbles:
        return [qdata.float()]
    return [(((qdata & 15) ^ 8) - 8).float(), (qdata >> 4).float()]


def mirror(x: torch.Tensor, qdata: torch.Tensor, scale: torch.Tensor,
           nibbles: bool) -> torch.Tensor:
    """y [M, N] of one 2-D packed weight in the kernel's order, fp32."""
    Gp, Bq, N = qdata.shape
    splits, per = pqm.split_plan(Gp, N // COLS)
    planes = _value_planes(qdata, nibbles)
    total = None
    for sp in range(splits):
        p0, p1 = sp * per, min(Gp, (sp + 1) * per)
        rng = [x[:, (p0 + sub * Gp) * Bq:(p1 + sub * Gp) * Bq] for sub in range(len(planes))]
        skip = all(bool((r == 0).all()) for r in rng)
        block = None
        for w in range(pqm.WARPS):
            run = torch.zeros(x.shape[0], N)
            if not skip:
                for p in range(p0 + w, p1, pqm.WARPS):
                    for sub, vals in enumerate(planes):
                        g = p + sub * Gp
                        prod = x[:, g * Bq:(g + 1) * Bq] @ vals[p]  # x·q, exact products
                        run = run + prod * scale[g, 0]
            block = run if block is None else block + run
        total = block if total is None else total + block
    return total


def mirror_experts(x3d, w):
    return torch.stack([mirror(x3d[e], w.qdata[e], w.scale[e], w.nibbles)
                        for e in range(x3d.shape[0])])


def _weights(shape, bits, seed):
    w = np.random.RandomState(seed).randn(*shape).astype(np.float32) * 0.05
    return (jq.pack_quantize_blockwise(jnp.asarray(w), bits=bits),
            pq.pack_quantize_blockwise(torch.from_numpy(w), bits=bits))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", [1, 5, 16])
@pytest.mark.parametrize("D", [1024, 208])  # Bq = 128 (8 blocks), Bq = D (13 steps of 16)
def test_mirror_matches_plain_and_pallas(bits, M, D):
    N = 256
    jw, pw = _weights((D, N), bits, seed=D + M + bits)
    assert pw.qdata.shape[-2] == (128 if D % 128 == 0 else D)
    assert pw.nibbles == (bits == 4 and D % 128 == 0)
    x = np.random.RandomState(M).randn(M, D).astype(np.float32)
    got = mirror(torch.from_numpy(x), pw.qdata, pw.scale, pw.nibbles)
    _close(got, pqm.packed_matvec_plain(torch.from_numpy(x), pw))
    _close(got, jqm._packed_matvec(jnp.asarray(x), jw.qdata, jw.scale, block_n=128,
                                   nibbles=jw.nibbles))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("C", [1, 5])
def test_expert_mirror_skips_zero_rows_exactly(bits, C):
    """Experts 1 and 3 have all-zero rows (half of them -0.0, as the einsum
    dispatch makes them): their outputs are exactly 0 and equal the plain
    version; the routed experts equal the full bank's, and all agree with
    the Pallas per-expert kernel. Expert 2 is zero on the first split's
    contraction range only: that split is skipped, the result unchanged."""
    E, D, N = 4, 1024, 256
    jw, pw = _weights((E, D, N), bits, seed=C + bits)
    x = np.random.RandomState(C + 7).randn(E, C, D).astype(np.float32)
    full = mirror_experts(torch.from_numpy(x), pw)
    xs = torch.from_numpy(x.copy())
    xs[1] = 0.0
    xs[3] = -0.0
    xs[3, :, ::2] = 0.0
    _, per = pqm.split_plan(pw.qdata.shape[1], N // COLS)
    Gp, Bq = pw.qdata.shape[1:3]
    xs[2, :, :per * Bq] = -0.0
    if pw.nibbles:
        xs[2, :, Gp * Bq:(Gp + per) * Bq] = 0.0
    got = mirror_experts(xs, pw)
    plain = pqm.packed_expert_matvec_plain(xs, pw)
    for e in (1, 3):
        assert torch.equal(got[e], plain[e]) and not bool(got[e].any())
    assert torch.equal(got[0], full[0])
    _close(got, plain)
    _close(got, jqm._packed_expert_matvec_local(jnp.asarray(xs.numpy()), jw.qdata, jw.scale,
                                                nibbles=jw.nibbles, block_n=128))


def test_plan_depends_on_the_weight_shape_only():
    """split_plan takes the weight's byte planes and column tiles, nothing
    of x: a bank's experts and the 2-D weight of one expert get one plan,
    so an expert's rows are bitwise the 2-D call's on the card."""
    assert list(inspect.signature(pqm.split_plan).parameters) == ["planes", "n_tiles"]
    _, bank = _weights((3, 512, 384), 8, seed=0)
    assert pqm.split_plan(bank.qdata.shape[-3], bank.qdata.shape[-1] // COLS) == \
        pqm.split_plan(bank[1].qdata.shape[-3], bank[1].qdata.shape[-1] // COLS)
    for planes, tiles in ((32, 8), (32, 112), (112, 32), (16, 112), (56, 32), (1, 50)):
        assert pqm.split_plan(planes, tiles) == pqm.split_plan(planes, tiles)
