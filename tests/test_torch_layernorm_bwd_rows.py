"""The LayerNorm backward's schedule (``csrc/layernorm_bwd.cu``) as a plain
fp32 torch mirror: a team of 1, 2, 4 or 8 warps per row (128 16-byte vectors
a warp), 4 warps a block (8 for a team of 8), at most 264 blocks; team k of
all teams takes rows k, k + teams, ... and adds its rows' g * xhat and g in
row order; a block adds its teams' partials in team order into one partial
row; the merge adds the partial rows of each column in 16 row lanes (lane l
takes rows l, l + 16, ... in order), then the lanes in order. Held against
the JAX package's Pallas backward (the custom VJP of ``layernorm``) in
interpret mode and against the port's plain version: dx within 1e-5 of its
largest value, dscale and dbias within 1e-5 relative, for D in {1024, 1600
(fp32), 4096, 8192} and ragged row counts 5, 40 and 300."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.layernorm import layernorm as pallas_layernorm
from deepspeed_tpu_torch.ops.cuda import layernorm as ln

EPS = 1e-5
WARP_VECS = 128    # 16-byte vectors a warp holds of a row (32 lanes x 4)
BLOCK_WARPS = 4    # warps of a block, unless a team is wider
MAX_BLOCKS = 264   # two blocks an SM of the H100's 132
MERGE_LANES = 16   # row lanes of the merge


def plan(rows: int, D: int, itemsize: int):
    """(warps a row, teams a block, blocks): a function of rows and D only."""
    nvec = D * itemsize // 16
    row_warps = 1 if nvec <= 128 else 2 if nvec <= 256 else 4 if nvec <= 512 else 8
    teams = max(1, BLOCK_WARPS // row_warps)
    return row_warps, teams, min(-(-rows // teams), MAX_BLOCKS)


def mirror(x, w, g, itemsize):
    """(dx, dscale, dbias) in the kernel's row and merge order, fp32."""
    rows, D = x.shape
    _, teams, nblocks = plan(rows, D, itemsize)
    stride = nblocks * teams
    dx = torch.empty_like(x)
    part_s, part_b = torch.zeros(nblocks, D), torch.zeros(nblocks, D)
    for b in range(nblocks):
        for k in range(teams):
            acc_s, acc_b = torch.zeros(D), torch.zeros(D)
            for r in range(b * teams + k, rows, stride):
                gs = g[r] * w
                mean, m1 = x[r].sum() / D, gs.sum() / D
                xc = x[r] - mean
                rstd = torch.rsqrt((xc * xc).sum() / D + EPS)
                m2 = (gs * xc).sum() * rstd / D
                xhat = xc * rstd
                dx[r] = rstd * (gs - m1 - xhat * m2)
                acc_s, acc_b = acc_s + g[r] * xhat, acc_b + g[r]
            part_s[b] += acc_s  # team order: the block's first team onto zeros
            part_b[b] += acc_b

    def merge(part):
        lanes = []
        for lane in range(MERGE_LANES):
            v = torch.zeros(D)
            for b in range(lane, nblocks, MERGE_LANES):
                v = v + part[b]
            lanes.append(v)
        total = lanes[0]
        for v in lanes[1:]:
            total = total + v
        return total

    return dx, merge(part_s), merge(part_b)


def _inputs(rows, D, seed, bf16_values):
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, D).astype(np.float32)
    g = rng.randn(rows, D).astype(np.float32)
    w = (1 + 0.1 * rng.randn(D)).astype(np.float32)
    if bf16_values:  # the bf16 plan runs on values a bf16 tensor holds
        x, g, w = (torch.from_numpy(a).bfloat16().float().numpy() for a in (x, g, w))
    return x, w, g


def _pallas(x, w, g):
    _, vjp = jax.vjp(lambda x, s, b: pallas_layernorm(x, s, b, EPS),
                     jnp.asarray(x), jnp.asarray(w), jnp.zeros_like(jnp.asarray(w)))
    return [np.asarray(t) for t in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("rows", [5, 40, 300])
@pytest.mark.parametrize("D,itemsize", [(1024, 2), (1600, 4), (4096, 2), (8192, 2)])
def test_mirror_matches_pallas_and_plain(rows, D, itemsize):
    x, w, g = _inputs(rows, D, seed=rows + D, bf16_values=itemsize == 2)
    dx, ds, db = mirror(*(torch.from_numpy(a) for a in (x, w, g)), itemsize)
    want_dx, want_ds, want_db = _pallas(x, w, g)
    plain = ln.layernorm_bwd_plain(*(torch.from_numpy(a) for a in (x, w, g)), EPS)
    for got_dx, got_ds, got_db in ((dx, ds, db), plain):
        np.testing.assert_allclose(got_dx.numpy(), want_dx, rtol=0,
                                   atol=1e-5 * float(np.abs(want_dx).max()))
        for got, want in ((got_ds, want_ds), (got_db, want_db)):
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-5 * float(np.abs(want).max()))


def test_plan_depends_on_rows_and_d_only():
    """One partial row a block, a handful of blocks an SM at the training
    shape, every row on some team, and the wider rows on wider teams."""
    assert plan(8192, 1024, 2) == (1, 4, 264)
    assert plan(5, 1600, 4) == (4, 1, 5)
    assert plan(40, 8192, 2) == (8, 1, 40)
    assert plan(300, 4096, 2) == (4, 1, 264)
    for rows in (1, 5, 40, 300, 8192):
        for D, itemsize in ((1024, 2), (1600, 4), (4096, 2), (8192, 2), (2048, 2)):
            _, teams, nblocks = plan(rows, D, itemsize)
            assert nblocks * teams >= min(rows, MAX_BLOCKS * teams)
            assert nblocks <= MAX_BLOCKS
