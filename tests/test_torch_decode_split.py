"""The decode kernel's schedule (``csrc/decode_attention.cu``) as a plain
fp32 torch mirror: query rows in tiles of 64 (a sequence's rows times the G
heads of a kv head), key tiles of 64 (32 in the fp32 forms) owned by split
t mod 8 of a cluster of 8, an online-softmax partial (m, l, acc) per split,
and the partials merged in split order. Held, in fp32, against the port's
plain versions within 2e-6 and against the JAX package's Pallas
``_decode_kernel`` / ``_paged_decode_kernel`` in interpret mode within 2e-5
(ALiBi against the plain version only: the Pallas kernel takes no slopes);
and on the invariant the kernel keeps: a row's bits depend on its q, its
frontier and its sequence's bytes alone, not on rows_per_seq, its
tile-mates, Smax or paged against contiguous."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import decoding as jdec
from deepspeed_tpu.ops.pallas.decode_attention import (decode_attention_kernel,
                                                        paged_decode_attention_kernel)
from deepspeed_tpu_torch.ops.cuda import decode_attention as dec

TILE_BF16, TILE_FP32 = 64, 32  # keys a tile: the bf16 forms, the fp32 forms
SPLIT = 8  # blocks of a cluster
ROWS = 64  # query rows a block holds
SMAX, HD = 1024, 64
EDGES = [63, 64, 511, 512, -1, 0, SMAX - 1]  # tile and split edges, padded, first, last


def _empty(G: int, hd: int):
    return (torch.full((G,), -math.inf), torch.zeros(G), torch.zeros(G, hd))


def tile_update(state, q, kt, vt, t, tile, frontier, n_row, scale, slopes):
    """One block's online softmax over key tile t (kt, vt [tile, hd]) for the
    G query heads q [G, hd] of one row at ``frontier`` seeing n_row keys."""
    m, l, acc = state
    kpos = torch.arange(t * tile, (t + 1) * tile)
    s = (q[:, None, :] * kt[None]).sum(-1) * scale
    if slopes is not None:
        s = s - slopes[:, None] * (frontier - kpos)[None].float()
    s = torch.where(kpos[None] < n_row, s, -math.inf)
    m_new = torch.maximum(m, s.max(-1).values)
    m_safe = torch.where(m_new == -math.inf, 0.0, m_new)
    corr = torch.exp(m - m_safe)
    p = torch.exp(s - m_safe[:, None])
    return m_new, l * corr + p.sum(-1), acc * corr[:, None] + p @ vt


def merge(parts):
    """The splits' partials in rank order: rescaled by exp(m_s - m), one
    division by l, zeros where l == 0 (an empty split weighs 0)."""
    ms = torch.stack([m for m, _, _ in parts])
    mx = ms.max(0).values
    w = torch.where(ms == -math.inf, 0.0, torch.exp(ms - mx))
    l, o = torch.zeros_like(mx), torch.zeros_like(parts[0][2])
    for s, (_, ls, acc) in enumerate(parts):
        l = l + ls * w[s]
        o = o + acc * w[s][:, None]
    return torch.where(l[:, None] == 0, 0.0, o / torch.where(l == 0, 1.0, l)[:, None])


def mirror(q, k, v, frontier, rows_per_seq=1, k_scale=None, v_scale=None, slopes=None,
           page_table=None, tile=TILE_BF16, trace=None):
    """The kernel's function by its schedule, in fp32. q [rows,1,H,hd]; k/v
    a dense cache [B,Smax,KV,hd] (scales [B,KV,Smax]) or, with
    ``page_table`` [B,mp], a pool [P+1,ps,KV,hd] (scales [P+1,KV,ps]); int8
    values are dequantized float(q) * scale rounded to q's dtype. ``trace``
    collects (sequence, row tile, kv head, split, key tile) as walked."""
    rows, _, H, hd = q.shape
    KV = k.shape[2]
    G, R = H // KV, rows_per_seq
    scale = 1.0 / math.sqrt(hd)
    fr = torch.as_tensor(frontier).reshape(-1).expand(rows).tolist()
    if page_table is not None:
        ps = k.shape[1]
        smax = page_table.shape[1] * ps

        def locate(n, pos):
            return page_table[n, pos // ps].long(), pos % ps
    else:
        smax = k.shape[1]

        def locate(n, pos):
            return torch.full_like(pos, n), pos

    def key_tile(n, kvh, t, n_max):
        pos = torch.arange(t * tile, (t + 1) * tile)
        live = pos < n_max
        blk, off = locate(n, pos.clamp(max=n_max - 1))
        kt, vt = k[blk, off, kvh].float(), v[blk, off, kvh].float()
        if k_scale is not None:
            kt = (kt * k_scale[blk, kvh, off][:, None]).to(q.dtype).float()
            vt = (vt * v_scale[blk, kvh, off][:, None]).to(q.dtype).float()
        return torch.where(live[:, None], kt, 0.0), torch.where(live[:, None], vt, 0.0)

    out = torch.zeros(rows, H, hd)
    per_tile = ROWS // G
    for n in range(rows // R):
        for rt, r0 in enumerate(range(0, R, per_tile)):
            members = range(n * R + r0, n * R + min(R, r0 + per_tile))
            n_row = {r: min(max(fr[r] + 1, 0), smax) for r in members}
            n_max = max(n_row.values())
            if n_max == 0:
                continue  # a row tile all padding: zeros
            n_tiles = -(-n_max // tile)
            for kvh in range(KV):
                tiles = [key_tile(n, kvh, t, n_max) for t in range(n_tiles)]
                heads = slice(kvh * G, (kvh + 1) * G)
                sl = None if slopes is None else slopes[heads].float()
                for r in members:
                    qr = q[r, 0, heads].float()
                    parts = []
                    for s in range(SPLIT):
                        state = _empty(G, hd)
                        for t in range(s, n_tiles, SPLIT):
                            if trace is not None and r == members[0]:
                                trace.append((n, rt, kvh, s, t))
                            state = tile_update(state, qr, *tiles[t], t, tile, fr[r],
                                                n_row[r], scale, sl)
                        parts.append(state)
                    out[r, heads] = merge(parts)
    return out.reshape(rows, 1, H, hd)


def _case(seed, B, H, KV, hd=HD, smax=SMAX):
    r = np.random.RandomState(seed)
    q = r.randn(B, 1, H, hd).astype(np.float32)
    k = r.randn(B, smax, KV, hd).astype(np.float32)
    v = r.randn(B, smax, KV, hd).astype(np.float32)
    return q, k, v


def _int8(k):
    """int8 values and scales by the JAX package's quantizer: (values, the
    port's [..,KV,S] scales, the JAX package's [..,KV,S,SL] scales)."""
    kq, ks = (np.array(a) for a in jdec._quantize_kv(jnp.asarray(k)))
    ks_j = np.ascontiguousarray(np.swapaxes(ks, 1, 2))
    return kq, np.ascontiguousarray(ks_j[..., 0]), ks_j


def _paged(seed, N, mp, ps, KV, hd, frontier):
    """Pools with shuffled pages and NULL tails past each frontier."""
    r = np.random.RandomState(seed)
    P = N * mp
    k = r.randn(P + 1, ps, KV, hd).astype(np.float32)
    v = r.randn(P + 1, ps, KV, hd).astype(np.float32)
    perm = r.permutation(P).astype(np.int32)
    table = np.full((N, mp), P, np.int32)
    for n, f in enumerate(frontier):
        used = -(-(f + 1) // ps) if f >= 0 else 0
        table[n, :used] = perm[n * mp:n * mp + used]
    return k, v, table


T = torch.from_numpy


@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("hd", [64, 128])
def test_mirror_matches_plain_and_pallas(G, hd):
    H = 8
    q, k, v = _case(G + hd, len(EDGES), H, H // G, hd)
    fr = np.asarray(EDGES, np.int32)
    got = mirror(T(q), T(k), T(v), T(fr))
    torch.testing.assert_close(got, dec.decode_attention_plain(T(q), T(k), T(v), T(fr)),
                               atol=2e-6, rtol=0)
    want = np.asarray(decode_attention_kernel(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              jnp.asarray(fr), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    assert (got[fr < 0] == 0).all()


@pytest.mark.parametrize("tile", [TILE_BF16, TILE_FP32])
def test_mirror_int8_matches_plain_and_pallas(tile):
    q, k, v = _case(7, len(EDGES), 8, 2)
    kq, ks, ks_j = _int8(k)
    vq, vs, vs_j = _int8(v)
    fr = np.asarray(EDGES, np.int32)
    args = (T(q), T(kq), T(vq), T(fr))
    got = mirror(*args, k_scale=T(ks), v_scale=T(vs), tile=tile)
    torch.testing.assert_close(got, dec.decode_attention_plain(*args, T(ks), T(vs)),
                               atol=2e-6, rtol=0)
    want = np.asarray(decode_attention_kernel(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(fr),
        k_scale=jnp.asarray(ks_j), v_scale=jnp.asarray(vs_j), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("int8", [False, True])
def test_mirror_paged_matches_plain_and_pallas(int8):
    N, mp, ps, H, KV = 5, 16, 16, 8, 2
    fr = np.asarray([63, 64, -1, 0, 255], np.int32)
    k, v, table = _paged(3, N, mp, ps, KV, HD, fr)
    q = np.random.RandomState(4).randn(N, 1, H, HD).astype(np.float32)
    kw, pallas_kw = {}, {}
    if int8:
        k, ks, ks_j = _int8(k)
        v, vs, vs_j = _int8(v)
        kw = dict(k_scale=T(ks), v_scale=T(vs))
        pallas_kw = dict(k_scale=jnp.asarray(ks_j), v_scale=jnp.asarray(vs_j))
    got = mirror(T(q), T(k), T(v), T(fr), page_table=T(table), **kw)
    plain = dec.paged_decode_attention_plain(T(q), T(k), T(v), T(fr), T(table), **kw)
    torch.testing.assert_close(got, plain, atol=2e-6, rtol=0)
    want = np.asarray(paged_decode_attention_kernel(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(fr),
        jnp.asarray(table), interpret=True, **pallas_kw))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("tile", [TILE_BF16, TILE_FP32])
def test_mirror_alibi_window_matches_plain(tile):
    """ALiBi slopes over a window of 5 rows a sequence at scattered
    frontiers: the plain version is the reference (the Pallas kernel takes
    no slopes)."""
    H, KV, R = 8, 8, 5
    q, k, v = _case(9, 2 * R, H, KV)
    k, v = k[:2], v[:2]
    fr = T(np.asarray([120, 511, 512, 0, -1, 63, 64, 1023, 700, 5], np.int32))
    slopes = torch.tensor([2.0 ** (-8 * (i + 1) / H) for i in range(H)])
    got = mirror(T(q), T(k), T(v), fr, rows_per_seq=R, slopes=slopes, tile=tile)
    want = dec.decode_attention_plain(T(q), T(k), T(v), fr, rows_per_seq=R, slopes=slopes)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=0)


@pytest.mark.parametrize("int8", [False, True])
def test_row_bits_independent_of_window_tile_mates_smax_and_pages(int8):
    """Each row of a 20-row window (two row tiles at G = 4, scattered
    frontiers, padded rows) is bitwise the same row decoded alone, with
    other tile-mates, over a larger Smax holding the same bytes, and through
    page tables."""
    H, KV, R, ps = 8, 2, 20, 16
    q, k, v = _case(11, R, H, KV)
    k, v = k[:1], v[:1]
    fr = np.asarray([63, 64, 0, 511, 512, 1023, -1, 100, 700, 63, 65, 127, 128, 129, 300,
                     511, 512, 513, 1000, 2], np.int32)
    kw = {}
    if int8:
        k, ks, _ = _int8(k)
        v, vs, _ = _int8(v)
        kw = dict(k_scale=T(ks), v_scale=T(vs))
    win = mirror(T(q), T(k), T(v), T(fr), rows_per_seq=R, **kw)
    # Smax 1280 holding the same bytes (and a different tail)
    pad = np.random.RandomState(12).randn(1, 256, KV, HD).astype(np.float32)
    if int8:
        k2, v2 = np.concatenate([k, k[:, :256]], 1), np.concatenate([v, v[:, :256]], 1)
        kw2 = dict(k_scale=T(np.concatenate([ks, ks[..., :256]], -1)),
                   v_scale=T(np.concatenate([vs, vs[..., :256]], -1)))
    else:
        k2, v2, kw2 = np.concatenate([k, pad], 1), np.concatenate([v, -pad], 1), {}
    big = mirror(T(q), T(k2), T(v2), T(fr), rows_per_seq=R, **kw2)
    # the same bytes through shuffled page tables
    mp = SMAX // ps
    perm = np.random.RandomState(13).permutation(mp).astype(np.int32)
    inv = np.argsort(perm)
    kp, vp = k[0].reshape(mp, ps, KV, HD)[inv], v[0].reshape(mp, ps, KV, HD)[inv]
    kwp = {}
    if int8:
        kwp = {name: T(np.ascontiguousarray(
                   sc[0].reshape(KV, mp, ps).transpose(1, 0, 2)[inv]))
               for name, sc in (("k_scale", ks), ("v_scale", vs))}
    paged = mirror(T(q), T(np.ascontiguousarray(kp)), T(np.ascontiguousarray(vp)), T(fr),
                   rows_per_seq=R, page_table=T(perm[None]), **kwp)
    for r in range(R):
        alone = mirror(T(q[r:r + 1]), T(k), T(v), T(fr[r:r + 1]), **kw)
        mates = mirror(T(np.roll(q, -r, 0)), T(k), T(v), T(np.roll(fr, -r)),
                       rows_per_seq=R, **kw)[0]
        for other in (alone[0], mates, big[r], paged[r]):
            assert torch.equal(win[r], other), f"row {r} at frontier {fr[r]}"
    assert (win[fr < 0] == 0).all()


def test_masked_tile_and_empty_split_are_noops():
    """A key tile wholly past a row's frontier leaves (m, l, acc) bitwise as
    they were (correction exactly 1, P exactly 0), and an empty split merges
    with weight 0."""
    r = np.random.RandomState(14)
    q = T(r.randn(4, HD).astype(np.float32))
    kt = [T(r.randn(TILE_BF16, HD).astype(np.float32)) for _ in range(3)]
    vt = [T(r.randn(TILE_BF16, HD).astype(np.float32)) for _ in range(3)]
    scale = 1.0 / math.sqrt(HD)
    state = _empty(4, HD)
    state = tile_update(state, q, kt[0], vt[0], 0, TILE_BF16, 100, 101, scale, None)
    state = tile_update(state, q, kt[1], vt[1], 1, TILE_BF16, 100, 101, scale, None)
    after = tile_update(state, q, kt[2], vt[2], 2, TILE_BF16, 100, 101, scale, None)
    assert all(torch.equal(a, b) for a, b in zip(state, after))
    empty = _empty(4, HD)
    assert all(torch.equal(a, b) for a, b in zip(
        empty, tile_update(empty, q, kt[2], vt[2], 2, TILE_BF16, 100, 101, scale, None)))
    assert torch.equal(merge([state, empty]), merge([state]))
    assert torch.equal(merge([empty, state, empty]), merge([state]))
    assert (merge([empty, empty]) == 0).all()


def test_tile_ownership_is_absolute():
    """Split s walks key tiles s, s + 8, ... up to its row tile's furthest
    frontier, each tile once; a padded row tile walks none."""
    H, KV, R = 8, 2, 20  # G = 4: two row tiles of 16 and 4 rows
    q, k, v = _case(15, R, H, KV)
    fr = np.full(R, -1, np.int32)
    fr[:16] = np.arange(16) * 60  # furthest 900: 15 tiles of 64
    trace = []
    mirror(T(q), T(k[:1]), T(v[:1]), T(fr), rows_per_seq=R, trace=trace)
    assert {(rt, kvh) for _, rt, kvh, _, _ in trace} == {(0, 0), (0, 1)}
    tiles = sorted(t for _, _, kvh, _, t in trace if kvh == 0)
    assert tiles == list(range(15))
    assert all(t % SPLIT == s for _, _, _, s, t in trace)


def test_frontier_taken_as_is_when_already_int32():
    """The wrapper's frontiers: a contiguous int32 [rows] tensor on the
    device is passed on with no cast or copy; anything else is cast."""
    cl = torch.tensor([3, 5, 7], dtype=torch.int32)
    same, ptr = dec._frontier(cl, 3, cl.device)
    assert same is cl and ptr == cl.data_ptr()
    cast, _ = dec._frontier(cl.long(), 3, cl.device)
    assert cast.dtype == torch.int32 and torch.equal(cast, cl)
    spread, _ = dec._frontier(torch.tensor([4], dtype=torch.int32), 3, cl.device)
    assert torch.equal(spread, torch.full((3,), 4, dtype=torch.int32))
