"""Decode attention over a page pool, and the paged cache pieces.

The paged kernel's plain version (what ``csrc/decode_attention.cu``'s paged
form computes) against the Pallas ``paged_decode_attention_kernel`` in
interpret mode: shuffled physical pages, the NULL page, ragged frontiers and
a frontier of -1 (zeros), bf16-free fp32 at atol 2e-5, and the int8 form with
JAX's SCALE_LANES copies carried to the port's one scale. ``rows_per_seq``
rows a sequence equal single-row calls, the paged plain version equals the
dense one over the gathered view bit for bit, and the pool's writes, the
copy-on-write and the verify-window gather give the JAX package's bytes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import decoding as jdec
from deepspeed_tpu.ops.pallas.decode_attention import paged_decode_attention_kernel
from deepspeed_tpu_torch.models import decoding as pdec
from deepspeed_tpu_torch.models.convert import cache_from_numpy
from deepspeed_tpu_torch.ops.cuda import decode_attention as dec

from torch_bridge import tiny_pair

N, MP, PS, H, KV, HD = 3, 4, 8, 4, 2, 64
P = N * MP  # pool pages; page P is the NULL page


def _case(seed=0, int8=False):
    """q [N,1,H,hd], pools (JAX layout), page table with shuffled pages and
    NULL tails, frontiers: ragged, one of them -1."""
    r = np.random.RandomState(seed)
    q = r.randn(N, 1, H, HD).astype(np.float32)
    k = r.randn(P + 1, PS, KV, HD).astype(np.float32)
    v = r.randn(P + 1, PS, KV, HD).astype(np.float32)
    frontier = np.array([5, 29, -1], np.int32)
    perm = r.permutation(P).astype(np.int32)
    table = np.full((N, MP), P, np.int32)
    for n, f in enumerate(frontier):
        used = -(-(f + 1) // PS) if f >= 0 else 0
        table[n, :used] = perm[n * MP:n * MP + used]
    if not int8:
        return q, (k, v), None, table, frontier
    kq, ks = (np.array(a) for a in jdec._quantize_kv(jnp.asarray(k)))
    vq, vs = (np.array(a) for a in jdec._quantize_kv(jnp.asarray(v)))
    # [P+1, ps, KV, SL] -> the pool scale layout [P+1, KV, ps, SL]
    scales = tuple(np.ascontiguousarray(np.swapaxes(s, 1, 2)) for s in (ks, vs))
    return q, (kq, vq), scales, table, frontier


def _pallas(q, pools, scales, table, frontier):
    kw = {}
    if scales is not None:
        kw = dict(k_scale=jnp.asarray(scales[0]), v_scale=jnp.asarray(scales[1]))
    return np.asarray(paged_decode_attention_kernel(
        jnp.asarray(q), jnp.asarray(pools[0]), jnp.asarray(pools[1]),
        jnp.asarray(frontier), jnp.asarray(table), interpret=True, **kw))


def _port_args(pools, scales, table, frontier):
    t = torch.from_numpy
    sc = () if scales is None else tuple(t(np.ascontiguousarray(s[..., 0])) for s in scales)
    return t(pools[0]), t(pools[1]), t(frontier), t(table), sc


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_paged_plain_matches_pallas(int8, seed):
    q, pools, scales, table, frontier = _case(seed, int8)
    kp, vp, fr, pt, sc = _port_args(pools, scales, table, frontier)
    before = dict(dec.launches)
    got = dec.paged_decode_attention(torch.from_numpy(q), kp, vp, fr, pt, *sc)
    assert dec.launches == before  # CPU tensors take the plain version
    want = _pallas(q, pools, scales, table, frontier)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    assert (got[2] == 0).all() and (want[2] == 0).all()  # frontier -1


@pytest.mark.parametrize("int8", [False, True])
def test_rows_per_seq_equals_single_rows(int8):
    """R rows of a sequence at their own frontiers: each row is the
    single-row call at that frontier (and a frontier of -1 gives zeros)."""
    _, pools, scales, table, _ = _case(2, int8)
    R = 5
    r = np.random.RandomState(3)
    q = torch.from_numpy(r.randn(N * R, 1, H, HD).astype(np.float32))
    fr = torch.tensor([3, 4, 5, -1, -1, 20, 21, 22, 23, 24, -1, -1, -1, -1, -1],
                      dtype=torch.int32)
    kp, vp, _, pt, sc = _port_args(pools, scales, table, np.zeros(N, np.int32))
    rows = dec.paged_decode_attention(q, kp, vp, fr, pt, *sc, rows_per_seq=R)
    for i in range(N * R):
        one = dec.paged_decode_attention(q[i:i + 1], kp, vp, fr[i:i + 1],
                                         pt[i // R:i // R + 1], *sc)
        np.testing.assert_allclose(rows[i:i + 1].numpy(), one.numpy(), atol=1e-6)
    assert (rows[fr < 0] == 0).all()


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("R", [1, 4])
def test_paged_plain_is_dense_plain_on_gathered_view(int8, R):
    _, pools, scales, table, _ = _case(4, int8)
    kp, vp, _, pt, sc = _port_args(pools, scales, table, np.zeros(N, np.int32))
    q = torch.from_numpy(np.random.RandomState(5).randn(N * R, 1, H, HD)
                         .astype(np.float32))
    fr = torch.from_numpy(np.random.RandomState(6).randint(-1, 30, N * R)
                          .astype(np.int32))
    paged = dec.paged_decode_attention_plain(q, kp, vp, fr, pt, *sc, rows_per_seq=R)
    dense_sc = tuple(dec.gather_page_scales(s, pt) for s in sc)
    dense = dec.decode_attention(q, dec.gather_pages(kp, pt), dec.gather_pages(vp, pt),
                                 fr, *dense_sc, rows_per_seq=R)
    assert torch.equal(paged, dense)


def test_dense_rows_plain_depends_on_each_sequence_alone():
    """Each sequence's cache is cut to its own furthest frontier: its rows
    are the same bits whatever the cache's capacity (the contiguous arena
    and the pool's view differ in length) and whatever the other sequences
    of the call hold."""
    r = np.random.RandomState(7)
    q = torch.from_numpy(r.randn(4, 1, H, HD).astype(np.float32))
    k = torch.from_numpy(r.randn(2, 40, KV, HD).astype(np.float32))
    v = torch.from_numpy(r.randn(2, 40, KV, HD).astype(np.float32))
    fr = torch.tensor([3, 17, 9, -1], dtype=torch.int32)
    short = dec.decode_attention_plain(q, k[:, :24], v[:, :24], fr, rows_per_seq=2)
    long = dec.decode_attention_plain(q, k, v, fr, rows_per_seq=2)
    assert torch.equal(short, long)
    alone = dec.decode_attention_plain(q[:2], k[:1], v[:1], fr[:2], rows_per_seq=2)
    assert torch.equal(alone, long[:2])
    np.testing.assert_allclose(
        long.numpy(), torch.cat([dec.cached_attention_plain(q[i:i + 1], k[i // 2:i // 2 + 1],
                                                            v[i // 2:i // 2 + 1], int(fr[i]))
                                 if fr[i] >= 0 else torch.zeros(1, 1, H, HD)
                                 for i in range(4)]).numpy(), atol=1e-6)


@pytest.mark.parametrize("int8", [False, True])
def test_paged_cache_layout_and_writes_match_jax(int8):
    """init_paged_cache, the chunk scatter through the page tables (padded
    tails onto the NULL page) and the copy-on-write give the JAX package's
    bytes; the JAX arena carries over through cache_from_numpy."""
    jm, _, pm, _ = tiny_pair(seed=0)
    jcfg, pcfg = jm.config, pm.config
    pages, ps = 6, 4
    jc = jdec.init_paged_cache(jcfg, pages, ps, jnp.float32, quantized=int8)
    pc = pdec.init_paged_cache(pcfg, pages, ps, torch.float32, quantized=int8)
    assert {k: tuple(v.shape) for k, v in pc.items()} == {
        k: (tuple(v.shape[:-1]) if k.endswith("scale") else tuple(v.shape))
        for k, v in jc.items()}
    r = np.random.RandomState(8)
    table = np.array([[3, 0, pages, pages], [5, 1, 2, pages]], np.int32)
    start = np.array([2, 5], np.int32)
    new = r.randn(2, 6, jcfg.kv_heads, jcfg.hd).astype(np.float32)
    jt, js = jnp.asarray(table), jnp.asarray(start)
    pt, pstart = torch.from_numpy(table), torch.from_numpy(start)
    if int8:
        jq, jscale = jdec._quantize_kv(jnp.asarray(new))
        pq, pscale = pdec._quantize_kv(torch.from_numpy(new))
        jk = jdec._paged_write(jc["k"][0], jq, js, jt)
        jks = jdec._paged_write_scale(jc["k_scale"][0], jscale, js, jt)
        pdec._paged_write(pc["k"][0], pq, pstart, pt)
        pdec._paged_write_scale(pc["k_scale"][0], pscale, pstart, pt)
        np.testing.assert_array_equal(pc["k_scale"][0][:pages].numpy(),
                                      np.asarray(jks)[:pages, ..., 0])
    else:
        jk = jdec._paged_write(jc["k"][0], jnp.asarray(new), js, jt)
        pdec._paged_write(pc["k"][0], torch.from_numpy(new), pstart, pt)
    # the NULL page takes several padded writes: its bytes are unspecified
    np.testing.assert_array_equal(pc["k"][0][:pages].numpy(), np.asarray(jk)[:pages])
    # copy-on-write: slot 0 copies page 1 onto its frontier page (0), slot 1
    # (no COW) self-copies
    jfull = {k: (v.at[0].set(jk) if k == "k" else v) for k, v in jc.items()}
    ported = cache_from_numpy({k: np.asarray(v) for k, v in jfull.items()})
    cow = np.array([1, -1], np.int32)
    start2 = np.array([4, 9], np.int32)
    jout = jdec.paged_cow_copy(jfull, jt, jnp.asarray(start2), jnp.asarray(cow))
    pdec.paged_cow_copy(ported, pt, torch.from_numpy(start2), torch.from_numpy(cow))
    for key in ported:
        want = np.asarray(jout[key])
        want = want[..., 0] if key.endswith("scale") else want
        np.testing.assert_array_equal(ported[key].numpy(), want)


def test_gather_verify_window_matches_jax():
    r = np.random.RandomState(9)
    logits = r.randn(4, 6, 11).astype(np.float32)
    num_new = np.array([6, 3, 0, 1], np.int32)
    spec_len = np.array([2, 0, 0, 0], np.int32)
    for md in (0, 2):
        want = np.asarray(jdec.gather_verify_window(jnp.asarray(logits), jnp.asarray(num_new),
                                                    jnp.asarray(spec_len), md))
        # the rows the serving step passes to forward_with_cache as head_rows
        idx = pdec.verify_window_rows(torch.from_numpy(num_new), torch.from_numpy(spec_len),
                                      md, logits.shape[1]).numpy()
        np.testing.assert_array_equal(np.take_along_axis(logits, idx[:, :, None], 1), want)
