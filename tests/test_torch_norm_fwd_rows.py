"""The RMSNorm and LayerNorm forward kernels' sum order (``csrc/norm_fwd.cuh``)
as a plain fp32 torch mirror.

A row of D values is nvec = D * itemsize / 16 vectors. Up to 1024 vectors the
row is held by a team of rw = 1, 2, 4, 8 or 16 warps (64 vectors a warp): lane
l of warp w holds vectors 32 (w + rw i) + l, i < 2, and slab k (vectors 32 k
to 32 k + 31) is one warp's lanes. Each lane adds its vector's values in
order, each slab's 32 lane sums go through the warp's xor-shuffle tree, and
the row adds its slab sums in slab order, so a row's bits depend on D alone:
the slab order of a team is checked against the plain slab order. Wider rows
take a block of 8 warps a row: each of its 256 lanes adds its vectors l,
l + 256, ... in order, then each warp's tree, then the 8 warps in order.

Each mirror is held against the JAX package's Pallas forward in interpret mode
and against the port's plain version, within atol 1e-5 on fp32 values near 1
(the sums run in other orders; rsqrt on the card is approximate, the mirror's
is torch's), plus 4e-7 * |mean| for the LayerNorm rows whose mean is 1000
against a spread of 1 (one fp32 ulp at 1000 is 6.1e-5, and the mean's sum
order moves it by a few): a one-pass E[x^2] - mean^2 would lose most of the
variance's digits there, far outside."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.layernorm import layernorm as pallas_layernorm
from deepspeed_tpu.ops.pallas.rmsnorm import rmsnorm as pallas_rmsnorm
from deepspeed_tpu_torch.ops.cuda import layernorm as ln
from deepspeed_tpu_torch.ops.cuda import rmsnorm as rn

EPS = 1e-5
VECS = 2          # 16-byte vectors a lane holds of a row
WARP_VECS = 32 * VECS
WIDE_WARPS = 8    # warps of a wide row's block
ATOL = 1e-5


def plan(D: int, itemsize: int):
    """(warps a row, wide): a function of D only."""
    nvec = D * itemsize // 16
    if nvec > 16 * WARP_VECS:
        return WIDE_WARPS, True
    return next(rw for rw in (1, 2, 4, 8, 16) if nvec <= rw * WARP_VECS), False


def _tree(p):
    """The warp's xor-shuffle tree over the last dim (32 lanes)."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        p = p + p[..., lanes ^ o]
    return p[..., 0]


def _lane_sums(terms, N):
    """[rows, vectors, N] -> each vector's values added in order."""
    p = torch.zeros(terms.shape[:2])
    for j in range(N):
        p = p + terms[:, :, j]
    return p


def row_sums(terms, itemsize, slab_order=False):
    """The kernels' sum of terms [rows, D] over each row, in their order (with
    slab_order, the register path's slabs in plain order instead of through
    the team's layout)."""
    rows, D = terms.shape
    N = 16 // itemsize
    nvec = D // N
    rw, wide = plan(D, itemsize)
    if wide:
        lanes = 32 * WIDE_WARPS
        per = -(-nvec // lanes)
        v = torch.zeros(rows, per * lanes, N)
        v[:, :nvec] = terms.reshape(rows, nvec, N)
        lane = torch.zeros(rows, lanes)
        for i in range(per):  # lane l's vectors l + 256 i, in order
            lane = lane + _lane_sums(v[:, i * lanes:(i + 1) * lanes], N)
        warps = _tree(lane.reshape(rows, WIDE_WARPS, 32))
        t = torch.zeros(rows)
        for w in range(WIDE_WARPS):
            t = t + warps[:, w]
        return t
    nslab = -(-nvec // 32)
    v = torch.zeros(rows, VECS * rw * 32, N)
    v[:, :nvec] = terms.reshape(rows, nvec, N)
    lane = _lane_sums(v, N)  # [rows, vector]: each lane's partial of its vector
    if slab_order:
        slabs = _tree(lane.reshape(rows, VECS * rw, 32))
        order = [slabs[:, k] for k in range(nslab)]
    else:
        # warp w of the team, lane l, its i-th vector: 32 w + l + 32 rw i; the
        # tree of its slab i lands in buf[i * rw + w]; read back buf[k], k < nslab
        lanes = torch.arange(32)
        buf = [None] * (VECS * rw)
        for w in range(rw):
            for i in range(VECS):
                buf[i * rw + w] = _tree(lane[:, 32 * w + lanes + 32 * rw * i])
        order = buf[:nslab]
    t = torch.zeros(rows)
    for s in order:
        t = t + s
    return t


def mirror(kind, x, w, b, itemsize, slab_order=False):
    """The kernel's output in fp32 (before the rounding to x's dtype)."""
    D = x.shape[1]
    if kind == "rmsnorm":
        rstd = torch.rsqrt(row_sums(x * x, itemsize, slab_order) / D + EPS)
        return x * rstd[:, None] * w
    mean = row_sums(x, itemsize, slab_order) / D
    xc = x - mean[:, None]
    rstd = torch.rsqrt(row_sums(xc * xc, itemsize, slab_order) / D + EPS)
    return xc * rstd[:, None] * w + b


def _inputs(D, seed, bf16_values, shift=0.0, rows=512):
    rng = np.random.RandomState(seed)
    x = (shift + rng.randn(rows, D)).astype(np.float32)
    w = (1 + 0.1 * rng.randn(D)).astype(np.float32)
    b = (0.1 * rng.randn(D)).astype(np.float32)
    if bf16_values:  # the bf16 plan runs on values a bf16 tensor holds
        x, w, b = (torch.from_numpy(a).bfloat16().float().numpy() for a in (x, w, b))
    return x, w, b


@functools.lru_cache(maxsize=None)
def _case(kind, D, itemsize, shift):
    """(x, w, b, Pallas output) for 512 rows; a smaller case takes the first
    rows (each row's result is its own)."""
    x, w, b = _inputs(D, seed=D + itemsize + int(shift), bf16_values=itemsize == 2,
                      shift=shift)
    if kind == "rmsnorm":
        want = pallas_rmsnorm(jnp.asarray(x), jnp.asarray(w), EPS)
    else:
        want = pallas_layernorm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), EPS)
    return x, w, b, np.asarray(want)


SHAPES = [(1024, 2), (1600, 2), (2048, 2), (4096, 2), (8192, 4), (20480, 4)]


@pytest.mark.parametrize("rows", [1, 4, 5, 300, 512])
@pytest.mark.parametrize("D,itemsize", SHAPES)
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_mirror_matches_pallas_and_plain(kind, D, itemsize, rows):
    x, w, b, want = _case(kind, D, itemsize, 0.0)
    tx, tw, tb = (torch.from_numpy(a) for a in (x[:rows], w, b))
    got = mirror(kind, tx, tw, tb, itemsize)
    plain = (rn.rmsnorm_plain(tx, tw, EPS) if kind == "rmsnorm"
             else ln.layernorm_plain(tx, tw, tb, EPS))
    for out in (got, plain):
        np.testing.assert_allclose(out.numpy(), want[:rows], rtol=0, atol=ATOL)


@pytest.mark.parametrize("rows", [4, 64])
@pytest.mark.parametrize("D", [1600, 4096])
def test_mean_1000_layernorm_rows(D, rows):
    """fp32 rows of mean 1000 and spread 1: the mean first, then the mean of
    (x - mean)^2, within 1e-5 + 4e-7 * 1000 of the Pallas kernel."""
    x, w, b, want = _case("layernorm", D, 4, 1000.0)
    tx, tw, tb = (torch.from_numpy(a) for a in (x[:rows], w, b))
    atol = ATOL + 4e-7 * 1000.0
    for out in (mirror("layernorm", tx, tw, tb, 4), ln.layernorm_plain(tx, tw, tb, EPS)):
        np.testing.assert_allclose(out.numpy(), want[:rows], rtol=0, atol=atol)


@pytest.mark.parametrize("D,itemsize", SHAPES[:4] + [(4096, 4)])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_team_layout_adds_slabs_in_slab_order_bitwise(kind, D, itemsize):
    """The team's layout (warp w's slab i in buf[i * rw + w]) adds the same
    slab sums in the same order as the slabs taken in plain order, so a row's
    bits depend on D alone, not on the team a row lands on or the rows beside
    it (each row's sums are its own)."""
    x, w, b, _ = _case(kind, D, itemsize, 0.0)
    tx, tw, tb = (torch.from_numpy(a) for a in (x[:5], w, b))
    got = mirror(kind, tx, tw, tb, itemsize)
    assert torch.equal(got, mirror(kind, tx, tw, tb, itemsize, slab_order=True))
    assert torch.equal(got[2:3], mirror(kind, tx[2:3], tw, tb, itemsize))


def test_plan_depends_on_d_only():
    """The warps a row follow D (64 vectors a warp, up to 16); past 16 warps
    the wide path."""
    assert plan(4096, 2) == (8, False)
    assert plan(2048, 2) == (4, False)
    assert plan(1600, 2) == (4, False)
    assert plan(1024, 2) == (2, False)
    assert plan(512, 2) == (1, False)
    assert plan(8192, 2) == (16, False)
    assert plan(4096, 4) == (16, False)
    assert plan(20480, 4) == (WIDE_WARPS, True)
    assert plan(8192, 4) == (WIDE_WARPS, True)
    assert plan(16384, 2) == (WIDE_WARPS, True)
    for D, itemsize in SHAPES:
        rw, wide = plan(D, itemsize)
        nvec = D * itemsize // 16
        assert wide or rw * WARP_VECS >= nvec > rw * WARP_VECS // 2 or rw == 1
