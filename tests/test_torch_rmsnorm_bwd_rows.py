"""The RMSNorm backward's schedule (``csrc/rmsnorm_bwd.cu``) as a plain fp32
torch mirror.

A row of D values is nvec = D * itemsize / 16 vectors, held by a team of
rw = 1, 2, 4, 8 or 16 warps of two vectors a lane (64 vectors a warp) up to
1024 vectors, or 16 warps of four past them (up to 2048: 32 KB a row); lane
l of warp w holds vectors 32 (w + rw i) + l. A block is 8 warps (16 for a
team of 16), so it holds 8 / rw teams; the grid is ceil(rows / teams)
blocks, at most two (one for a 16-warp block) for each of the H100's 132
SMs. Team k of all teams takes rows k, k + teams, ...

A row's two sums (x^2 and (g w) x) run in the forwards' order: each lane
adds its vector's values in order, a slab of 32 vectors is one warp's
xor-shuffle tree, and the row adds its slab sums in slab order. dscale: each
lane adds its rows' g * xhat in row order, a block adds its teams' shares in
team order into one partial row, and the merge adds the partial rows of a
column in 32 row lanes (lane l takes rows l, l + 32, ... in order from 0),
then the lane sums in lane order.

Held against the JAX package's Pallas backward (the custom VJP of
``rmsnorm``) in interpret mode and against the port's plain version: dx
within 1e-5 of its largest value, dscale within 1e-5 of its largest value,
for D in {2048, 4096, 1600 (fp32), 8192} and rows in {1, 5, 40, 300}."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.rmsnorm import rmsnorm as pallas_rmsnorm
from deepspeed_tpu_torch.ops.cuda import rmsnorm as rn

EPS = 1e-5
LANE_VECS = 2      # 16-byte vectors a lane holds of a row (twice past 16 warps)
BLOCK_WARPS = 8    # warps of a block, unless a team is wider
SMS = 132          # the H100's SMs
MERGE_LANES = 32   # row lanes of the merge


def plan(rows: int, D: int, itemsize: int):
    """(warps a row, vectors a lane, teams a block, blocks): a function of
    rows and D only."""
    nvec = D * itemsize // 16
    rw = next((w for w in (1, 2, 4, 8, 16) if nvec <= 32 * w * LANE_VECS), 16)
    vecs = LANE_VECS if nvec <= 32 * rw * LANE_VECS else 2 * LANE_VECS
    assert nvec <= 32 * rw * vecs, "wider than 32 KB a row"
    warps = max(rw, BLOCK_WARPS)
    per_sm = 2 if warps * 32 <= 256 else 1
    teams = warps // rw
    return rw, vecs, teams, min(-(-rows // teams), SMS * per_sm)


def _tree(p):
    """The warp's xor-shuffle tree over the last dim (32 lanes)."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        p = p + p[..., lanes ^ o]
    return p[..., 0]


def row_sums(terms, itemsize, slab_order=False):
    """The kernel's sum of terms [rows, D] over each row, in its order (with
    slab_order, the slabs in plain order instead of through the team's
    layout)."""
    rows, D = terms.shape
    N = 16 // itemsize
    nvec = D // N
    rw, vecs, _, _ = plan(rows, D, itemsize)
    v = torch.zeros(rows, vecs * rw * 32, N)
    v[:, :nvec] = terms.reshape(rows, nvec, N)
    lane = torch.zeros(rows, vecs * rw * 32)
    for j in range(N):  # each lane's values of its vector, in order
        lane = lane + v[:, :, j]
    nslab = -(-nvec // 32)
    if slab_order:
        slabs = _tree(lane.reshape(rows, vecs * rw, 32))
        order = [slabs[:, k] for k in range(nslab)]
    else:
        # warp w of the team, lane l, its i-th vector 32 w + l + 32 rw i: the
        # tree of its slab lands in buf[i * rw + w]; read back buf[k], k < nslab
        lanes = torch.arange(32)
        buf = [None] * (vecs * rw)
        for w in range(rw):
            for i in range(vecs):
                buf[i * rw + w] = _tree(lane[:, 32 * w + lanes + 32 * rw * i])
        order = buf[:nslab]
    t = torch.zeros(rows)
    for s in order:
        t = t + s
    return t


def mirror(x, w, g, itemsize):
    """(dx, dscale) in the kernel's row, team, block and merge order, fp32."""
    rows, D = x.shape
    _, _, teams, nblocks = plan(rows, D, itemsize)
    rstd = torch.rsqrt(row_sums(x * x, itemsize) / D + EPS)
    dot = row_sums((g * w) * x, itemsize) * rstd / D
    xhat = x * rstd[:, None]
    dx = rstd[:, None] * (g * w - xhat * dot[:, None])
    stride = nblocks * teams
    part = torch.zeros(nblocks, D)
    for b in range(nblocks):
        for k in range(teams):
            acc = torch.zeros(D)
            for r in range(b * teams + k, rows, stride):
                acc = acc + g[r] * xhat[r]
            part[b] = acc if k == 0 else part[b] + acc
    lanes = []
    for lane in range(MERGE_LANES):
        v = torch.zeros(D)
        for b in range(lane, nblocks, MERGE_LANES):
            v = v + part[b]
        lanes.append(v)
    dscale = lanes[0]
    for v in lanes[1:]:
        dscale = dscale + v
    return dx, dscale


def _inputs(rows, D, seed, bf16_values):
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, D).astype(np.float32)
    g = rng.randn(rows, D).astype(np.float32)
    w = (1 + 0.1 * rng.randn(D)).astype(np.float32)
    if bf16_values:  # the bf16 plan runs on values a bf16 tensor holds
        x, g, w = (torch.from_numpy(a).bfloat16().float().numpy() for a in (x, g, w))
    return x, w, g


@functools.lru_cache(maxsize=None)
def _case(D, itemsize):
    """(x, w, g) for 300 rows and the Pallas backward on each row count (a
    smaller case takes the first rows)."""
    x, w, g = _inputs(300, D, seed=D + itemsize, bf16_values=itemsize == 2)

    def pallas(rows):
        _, vjp = jax.vjp(lambda x, s: pallas_rmsnorm(x, s, EPS), jnp.asarray(x[:rows]),
                         jnp.asarray(w))
        return [np.asarray(t) for t in vjp(jnp.asarray(g[:rows]))]

    return x, w, g, {rows: pallas(rows) for rows in (1, 5, 40, 300)}


@pytest.mark.parametrize("rows", [1, 5, 40, 300])
@pytest.mark.parametrize("D,itemsize", [(2048, 2), (4096, 2), (1600, 4), (8192, 2)])
def test_mirror_matches_pallas_and_plain(rows, D, itemsize):
    x, w, g, want = _case(D, itemsize)
    tx, tw, tg = (torch.from_numpy(a) for a in (x[:rows], w, g[:rows]))
    want_dx, want_ds = want[rows]
    for got_dx, got_ds in (mirror(tx, tw, tg, itemsize), rn.rmsnorm_bwd_plain(tx, tw, tg, EPS)):
        np.testing.assert_allclose(got_dx.numpy(), want_dx, rtol=0,
                                   atol=1e-5 * float(np.abs(want_dx).max()))
        np.testing.assert_allclose(got_ds.numpy(), want_ds, rtol=0,
                                   atol=1e-5 * float(np.abs(want_ds).max()))


@pytest.mark.parametrize("D,itemsize", [(2048, 2), (1600, 4), (8192, 2)])
def test_team_layout_adds_slabs_in_slab_order_bitwise(D, itemsize):
    """The team's layout adds the same slab sums in the same order as the
    slabs taken in plain order, so a row's dx depends on D alone: a row run
    alone gives its bits in the batch."""
    x, w, g, _ = _case(D, itemsize)
    tx, tw, tg = (torch.from_numpy(a) for a in (x[:5], w, g[:5]))
    terms = tx * tx
    assert torch.equal(row_sums(terms, itemsize), row_sums(terms, itemsize, slab_order=True))
    dx, _ = mirror(tx, tw, tg, itemsize)
    assert torch.equal(dx[2:3], mirror(tx[2:3], tw, tg[2:3], itemsize)[0])


def test_plan_depends_on_rows_and_d_only():
    """Two 8-warp blocks an SM at the training shape, one 16-warp block an
    SM for the widest rows, every row on some team, and the wider rows on
    wider teams."""
    assert plan(8192, 2048, 2) == (4, 2, 2, 264)
    assert plan(300, 4096, 2) == (8, 2, 1, 264)
    assert plan(5, 1600, 4) == (8, 2, 1, 5)
    assert plan(40, 8192, 2) == (16, 2, 1, 40)
    assert plan(300, 16384, 2) == (16, 4, 1, 132)
    assert plan(300, 8192, 4) == (16, 4, 1, 132)
    assert plan(40, 128, 2) == (1, 2, 8, 5)
    for rows in (1, 5, 40, 300, 8192):
        for D, itemsize in ((128, 2), (1600, 4), (2048, 2), (4096, 2), (8192, 2),
                            (16384, 2), (8192, 4)):
            rw, vecs, teams, nblocks = plan(rows, D, itemsize)
            assert rw * 32 * vecs >= D * itemsize // 16
            assert nblocks <= 2 * SMS
            assert (nblocks - 1) * teams < rows  # no block without a row
