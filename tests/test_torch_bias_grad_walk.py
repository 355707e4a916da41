"""The broadcast-bias gradient kernel's walk (``csrc/flash_attention_bias_grad.cu``)
as a plain fp32 torch mirror.

The kernel's grid is a list of output tiles: for each slab (bo, ho) of the
bias [Bb, Hb, S, S], its query blocks of 128 rows, each by its key tiles of
``bias_grad_tile(D)`` keys (64 at head dim 64, 32 at 128). A tile wholly
above the causal diagonal is written as zeros. Any other tile adds, in the
Pallas grid's order (heads outer and batch rows inner for a bias [1, *, S, S],
the heads inner for [B, 1, S, S]), each (b, h) pair's p (dp - delta) into
its fp32 sum: each of the two 64-row halves of the tile (one consumer
warpgroup each) judges the pair by ``tile_class`` (empty: above the diagonal,
past S, or segment-id ranges that do not meet; full: every pair visible;
else partial) and skips an empty pair. The mirror checks each class against
the exact visibility of its pairs, and holds the walk's dbias against the
JAX package's ``_bias_grad_call`` in interpret mode and the port's plain
version, for the three broadcast shapes, causal and not, with segment ids,
with ALiBi slopes, a ragged S of 300 (query blocks and key tiles cut short;
the Pallas kernel in one block of 300) and head dims 64 and 128: within 1e-5
of the largest |dbias| (fp32 sums in other orders)."""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.transformer import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu.ops.pallas import flash_attention as jfa
from deepspeed_tpu_torch.models.transformer import alibi_slopes
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

ROWS = 128  # query rows of an output tile (two consumers of 64)
EMPTY, PARTIAL, FULL = 0, 1, 2
B, S, H, KV = 2, 300, 4, 2


def tile_class(q_lo, q_hi, k_lo, k_hi, causal, qseg=None, kseg=None):
    """``flash_attention_tiles.cuh:tile_class`` without position offsets:
    qseg and kseg the [min, max] segment ids of the rows and keys inside S."""
    if q_lo >= S or k_lo >= S or (causal and k_lo > q_hi):
        return EMPTY
    if qseg is not None and (qseg[1] < kseg[0] or kseg[1] < qseg[0]):
        return EMPTY
    full = q_hi < S and k_hi < S and (not causal or k_hi <= q_lo) and (
        qseg is None or (qseg[0] == qseg[1] == kseg[0] == kseg[1]))
    return FULL if full else PARTIAL


def pairs(bo, ho, Bb, Hb):
    """The (b, h) pairs that read slab (bo, ho), in the kernel's walk order."""
    if Hb != 1:
        return [(b if Bb == 1 else bo, ho) for b in (range(B) if Bb == 1 else [bo])]
    if Bb == 1:
        return [(i % B, i // B) for i in range(B * H)]
    return [(bo, h) for h in range(H)]


def _range(seg, lo, n):
    """[min, max] of seg over [lo, lo + n) inside S (the kernel reduces 64
    ids from lo; a 32-key tile's range then covers 64 keys: wider, so a
    class can only move from full or empty to partial)."""
    ids = seg[lo:min(lo + max(n, 64), S)]
    return int(ids.min()), int(ids.max())


def walk(q, k, v, bias, lse, delta, do, causal, slopes=None, seg=None):
    """dbias [Bb, Hb, S, S] in the kernel's tile walk and pair order, fp32;
    and the count of each class the walk met."""
    D = q.shape[-1]
    G = H // KV
    BN = fa.bias_grad_tile(D)
    Bb, Hb = bias.shape[:2]
    scale = 1.0 / math.sqrt(D)
    pos = torch.arange(S, dtype=torch.float32)
    out = torch.zeros(Bb, Hb, S, S)
    seen = {"zero tile": 0, EMPTY: 0, PARTIAL: 0, FULL: 0}
    for bo in range(Bb):
        for ho in range(Hb):
            for row_base in range(0, S, ROWS):
                for k0 in range(0, S, BN):
                    if causal and k0 > row_base + ROWS - 1:
                        seen["zero tile"] += 1
                        continue
                    keys = torch.arange(k0, min(k0 + BN, S))
                    acc = torch.zeros(min(ROWS, S - row_base), len(keys))
                    for b, h in pairs(bo, ho, Bb, Hb):
                        for r0 in (row_base, row_base + 64):
                            if r0 >= S:
                                continue
                            rows = torch.arange(r0, min(r0 + 64, S))
                            if seg is not None:
                                cls = tile_class(r0, r0 + 63, k0, k0 + BN - 1, causal,
                                                 _range(seg[b], r0, 64),
                                                 _range(seg[b], k0, BN))
                            else:
                                cls = tile_class(r0, r0 + 63, k0, k0 + BN - 1, causal)
                            vis = torch.ones(len(rows), len(keys), dtype=torch.bool)
                            if causal:
                                vis &= keys[None, :] <= rows[:, None]
                            if seg is not None:
                                vis &= seg[b][rows][:, None] == seg[b][keys][None, :]
                            seen[cls] += 1
                            if cls == EMPTY:
                                assert not vis.any()
                                continue
                            if cls == FULL:
                                assert vis.all() and len(rows) == 64 and len(keys) == BN
                            s = q[b, rows, h] @ k[b, keys, h // G].T * scale
                            s = s + bias[bo, ho][rows][:, keys]
                            if slopes is not None:
                                s = s - slopes[h] * (pos[rows][:, None] - pos[keys][None, :]).abs()
                            p = torch.where(vis, torch.exp(s - lse[b, h, rows][:, None]), 0.0)
                            dp = do[b, rows, h] @ v[b, keys, h // G].T
                            acc[rows - row_base] += p * (dp - delta[b, h, rows][:, None])
                    out[bo, ho, row_base:row_base + acc.shape[0], k0:k0 + len(keys)] = acc
    return out, seen


def _segments():
    """[B, S] int32: boundaries inside and on tile edges."""
    seg = np.zeros((B, S), np.int32)
    seg[0, 50:128], seg[0, 128:200], seg[0, 200:] = 1, 2, 3
    seg[1, 100:] = 1
    return seg


CASES = {  # name: (bias shape, causal, segment ids, ALiBi, head dim)
    "[1,H] causal D64": ((1, H), True, False, False, 64),
    "[1,H] ALiBi D128": ((1, H), False, False, True, 128),
    "[B,1] causal segments D64": ((B, 1), True, True, False, 64),
    "[B,1] ALiBi D64": ((B, 1), False, False, True, 64),
    "[1,1] causal segments ALiBi D64": ((1, 1), True, True, True, 64),
    "[1,1] D128": ((1, 1), False, False, False, 128),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    """Inputs (bf16 values in fp32, [B, S, H, D] numpy), the forward's lse
    and delta, and the Pallas kernel's dbias (interpret mode)."""
    shape, causal, has_seg, alibi, D = CASES[name]
    r = np.random.RandomState(sum(map(ord, name)))

    def draw(*s):
        return torch.from_numpy(r.randn(*s).astype(np.float32)).bfloat16().float().numpy()

    q, k, v, do = draw(B, S, H, D), draw(B, S, KV, D), draw(B, S, KV, D), draw(B, S, H, D)
    bias = 0.5 * r.randn(*shape, S, S).astype(np.float32)
    seg = _segments() if has_seg else None
    jseg = jnp.asarray(seg) if has_seg else None
    jslopes = jnp.asarray(jax_alibi_slopes(H)) if alibi else None
    sw = lambda t: jnp.swapaxes(jnp.asarray(t), 1, 2)  # noqa: E731  [B,S,H,D] -> [B,H,S,D]
    kw = dict(causal=causal, scale=1.0 / D ** 0.5, block_q=S, block_k=S, interpret=True)
    out, lse = jfa._flash_fwd(sw(q), sw(k), sw(v), jnp.asarray(bias), jseg, jslopes, None, **kw)
    delta = jnp.sum(sw(do) * out.astype(jnp.float32), axis=-1)
    dbias = jfa._bias_grad_call(
        sw(q), sw(k), sw(v), jnp.asarray(bias), jseg, jslopes, sw(do), lse,
        jnp.broadcast_to(delta[..., None], (*delta.shape, jfa.AUX_LANES)), group=H // KV, **kw)
    return (q, k, v, do, bias, seg, np.asarray(lse[..., 0]), np.asarray(delta),
            np.asarray(dbias))


@pytest.mark.parametrize("name", list(CASES))
def test_walk_matches_pallas_and_plain(name):
    shape, causal, has_seg, alibi, D = CASES[name]
    q, k, v, do, bias, seg, lse, delta, want = _case(name)
    t = {n: torch.from_numpy(np.array(a)) for n, a in dict(q=q, k=k, v=v, do=do, bias=bias, lse=lse,
                                                   delta=delta).items()}
    slopes = alibi_slopes(H) if alibi else None
    tseg = torch.from_numpy(seg) if has_seg else None
    got, seen = walk(t["q"], t["k"], t["v"], t["bias"], t["lse"], t["delta"], t["do"], causal,
                     slopes, tseg)
    plain = fa.flash_attention_bias_grad(t["q"], t["k"], t["v"], t["bias"], t["lse"], t["delta"],
                                         t["do"], causal, slopes, tseg)
    tol = 1e-5 * float(np.abs(want).max())
    for out in (got, plain):
        np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=tol)
    # the walk met every class: zero tiles and empty halves where causal or
    # segmented, full halves, and partial ones (at least at the ragged edge)
    assert (seen["zero tile"] > 0) == causal
    assert seen[FULL] > 0 and seen[PARTIAL] > 0
    assert (seen[EMPTY] > 0) == (causal or has_seg)


@pytest.mark.parametrize("Bb,Hb", [(1, H), (B, 1), (1, 1), (B, H)])
def test_pairs_follow_the_pallas_grid(Bb, Hb):
    """The pairs a slab sums, in order, are the Pallas grid's innermost
    steps that write that slab (``_bias_grad_call``'s b_of/h_of)."""
    if Bb == 1:
        b_of, h_of = (lambda t: t % B), (lambda t: t // B)
    else:
        b_of, h_of = (lambda t: t // H), (lambda t: t % H)
    for bo in range(Bb):
        for ho in range(Hb):
            grid = [(b_of(t), h_of(t)) for t in range(B * H)
                    if ((b_of(t) if Bb > 1 else 0), (h_of(t) if Hb > 1 else 0)) == (bo, ho)]
            assert pairs(bo, ho, Bb, Hb) == grid


def test_tile_sizes_follow_head_dim():
    """128 query rows by 64 keys at head dim 64, by 32 at head dim 128."""
    assert fa.bias_grad_tile(64) == 64 and fa.bias_grad_tile(128) == 32
