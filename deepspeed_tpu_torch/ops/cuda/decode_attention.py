"""Decode attention over a KV cache: the CUDA kernels
``csrc/decode_attention.cu`` and their plain versions.

Replaces ``deepspeed_tpu/ops/pallas/decode_attention.py:_decode_kernel``
(line 76) and ``_paged_decode_kernel`` (line 111), with ``_tile_update`` at
line 35, reached through ``decode_attention_kernel`` (line 160) and
``paged_decode_attention_kernel`` (line 243) from ``decode_attention``
(line 323): the dense form over a bf16, fp16 or fp32 cache, and the int8
form (``has_scales=True``) over an int8 cache with fp32 scales, one per
(token, kv head); each over a contiguous cache ([B, Smax, KV, hd] layers) or
through per-sequence page tables over a shared page pool
([P + 1, page_size, KV, hd] layers, scales [P + 1, KV, page_size]). The int8
forms dequantize each K/V value as it lands in shared memory, float(q) *
scale rounded to q's dtype, the TPU kernel's order (``_tile_update:42-43``).

fp16 queries take the fp16 instantiations (``csrc/decode_attention_f16.cu``,
the ``dst_*_f16`` entries): an fp16 cache, an int8 one, or a bf16 one (the
"mixed" form: ``kv_cache_dtype="bf16"`` on an fp16 engine), whose values are
rounded to fp16 as each tile lands, the TPU kernel's ``k.astype(q.dtype)``
(``_tile_update:44-48``). P is rounded once to fp16 before P V, as the TPU
kernel rounds p to the cache's dtype (line 64); the bf16 forms keep P as two
bf16 terms. An fp16 form's launches count under its bf16 name plus ``_f16``
(``decode_attention_alibi_f16``), the mixed form's plus ``_mixed_f16``.

``rows_per_seq = R`` runs R query rows per sequence in one launch, row r
reading sequence r // R at its own frontier: the serving engine's [N, W]
step puts each slot's W window rows through one kernel call, where the JAX
package runs that window as XLA's masked softmax (``models/decoding.py``
lines 365-444), row for row the same function. A negative frontier (a
padded row) attends nothing and gives zeros, as the TPU kernels do.

``slopes`` (fp32 [H], BLOOM's ALiBi) subtract slope * (frontier - key
position) from each score before the mask, the function the JAX package's
XLA path computes for every ALiBi step after a fresh prefill
(``models/decoding.py`` lines 424-438; its Pallas decode kernel has no
slope). Every form takes them; ``slopes=None`` leaves a score's arithmetic as
it was.

Bound on the H100: bytes, the K and V rows up to each sequence's furthest
frontier, once, over 3.35 TB/s; at the serving shapes a launch is latency.
The kernel holds up to 64 query rows a block (a sequence's rows times the G
query heads of a kv head), so one K/V tile serves every row of a window and
every head of the group, scored and applied on the tensor cores (mma.sync,
bf16 or fp16 in, fp32 out; the fp32 forms on CUDA cores). The key tiles are split
over a cluster of 8 blocks, tile t to block t mod 8, and the blocks merge
their fp32 partials (max, sum, output) through distributed shared memory in
rank order: one launch, no atomics. Tile size, cluster size and ownership
are fixed over absolute key positions, and a tile past a row's frontier
leaves that row exactly as it was, so a row's bits depend on its q, its
frontier and its sequence's bytes alone: a window row equals single-token
decode, paged equals contiguous. The paged form changes only where a key
position's row is read from.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from .flash_attention import form_suffix, slopes_ptr

KERNEL_NAMES = ("decode_attention", "decode_attention_int8", "paged_decode_attention",
                "paged_decode_attention_int8")
# kernel launches since the last reset; the ALiBi form, the fp16 forms
# ("_f16") and the bf16 cache under fp16 q ("_mixed_f16") count apart
launches = {name + form + dt: 0 for name in KERNEL_NAMES for form in ("", "_alibi")
            for dt in ("", "_f16") + (() if name.endswith("int8") else ("_mixed_f16",))}
# calls of the plain attention on CUDA tensors since the last reset: a
# serving run that should take the kernels keeps it at 0
plain_on_cuda = {"decode_attention_plain": 0}

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
MAX_GROUP = 8  # query heads per kv head the kernel holds


def dequantize_cache(cache: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 cache [B,Smax,KV,hd] times its scales [B,KV,Smax], in fp32."""
    return cache.float() * scale.transpose(1, 2)[..., None]


def _attend_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                  qpos: torch.Tensor, k_scale=None, v_scale=None,
                  slopes=None) -> torch.Tensor:
    """q [B,S,H,hd] at positions ``qpos`` [B or 1, S] against k/v [B,Smax,KV,hd]:
    each query sees the cache positions at or before its own; a negative
    position sees none and gives zeros. With ALiBi ``slopes`` [H] each score
    gets slope * -|kpos - qpos| first. fp32 softmax, output in q's dtype."""
    if q.is_cuda:
        plain_on_cuda["decode_attention_plain"] += 1
    hd, H = q.shape[3], q.shape[2]
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    if k_scale is not None:
        k_cache = dequantize_cache(k_cache, k_scale).to(q.dtype)
        v_cache = dequantize_cache(v_cache, v_scale).to(q.dtype)
    elif k_cache.dtype != q.dtype:  # a bf16 cache under fp16 q: q's dtype first
        k_cache, v_cache = k_cache.to(q.dtype), v_cache.to(q.dtype)
    kf = k_cache.float().repeat_interleave(H // KV, dim=2)
    vf = v_cache.float().repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (1.0 / math.sqrt(hd))
    kpos = torch.arange(Smax, device=q.device)[None, None, None, :]
    if slopes is not None:
        rel = -(kpos - qpos[:, None, :, None]).abs().float()
        s = s + slopes.float().to(q.device)[None, :, None, None] * rel
    s = torch.where(kpos <= qpos[:, None, :, None], s, NEG_INF)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vf)
    out = torch.where(qpos[:, :, None, None] >= 0, out, 0.0)
    return out.to(q.dtype)


def cached_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, cache_len,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attend S new queries against a cache that already holds them.

    q [B,S,H,hd]; k/v_cache [B,Smax,KV,hd]; cache_len an int or a per-row
    [B] tensor: query s of row b sits at position cache_len[b] + s and sees
    every cache position at or before it. An int8 cache comes with its
    scales [B,KV,Smax] and is dequantized as the decode kernel does it,
    float(q) * scale rounded to q's dtype; a cache of another float dtype
    (bf16 under fp16 q) is rounded to q's dtype first, as the kernel does.
    fp32 softmax; returns [B,S,H,hd] in q's dtype. For S = 1 this is the
    decode kernel's function.

    For S > 1 new tokens against a cache already holding tokens (a
    speculative verify window) the JAX package runs plain XLA
    (``models/decoding.py`` lines 413-444), not a Pallas kernel, and this is
    its counterpart on the CPU. On the card a window runs the decode kernel
    instead, one row per window token with ``rows_per_seq``
    (``models/decoding.py:_window_rows``): this function's fp32 einsum and
    the kernel's online softmax round differently, and over 32 layers that
    moved a greedy token of Llama-3-8B on the H100. The XLA path keeps the
    dequantized rows in fp32; rounding them to q's dtype, as the decode
    kernel does, keeps this function's window rows on the values
    single-token decode sees (in fp32 the two are the same). ``slopes``: ALiBi, as
    the module says."""
    S = q.shape[1]
    qpos = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1) \
        + torch.arange(S, device=q.device)[None, :]
    return _attend_plain(q, k_cache, v_cache, qpos, k_scale, v_scale, slopes)


def decode_rows_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                      frontier: torch.Tensor, k_scale=None, v_scale=None,
                      rows_per_seq: int = 1, slopes=None) -> torch.Tensor:
    """The kernel's function for R = ``rows_per_seq`` rows a sequence:
    q [N*R,1,H,hd] rows, row r of sequence r // R with its own frontier
    ``frontier`` [N*R] (negative: zeros). Each sequence's cache is cut to
    its own furthest frontier first (one host read), so a sequence's rows
    depend on its own bytes only: not on the cache's capacity, nor on the
    other sequences of the call."""
    rows, _, H, hd = q.shape
    N = k_cache.shape[0]
    R = int(rows_per_seq)
    if rows != N * R:
        raise ValueError(f"decode attention: {rows} query rows != {N} sequences x {R}")
    fr = torch.as_tensor(frontier, device=q.device).reshape(-1).expand(rows).reshape(N, R)
    qs = q.reshape(N, R, H, hd)
    out = torch.zeros_like(qs)
    for n, top in enumerate(fr.amax(dim=1).tolist()):
        if top < 0:
            continue  # every row padded: zeros
        m = min(top + 1, k_cache.shape[1])
        scales = ((k_scale[n:n + 1, :, :m], v_scale[n:n + 1, :, :m])
                  if k_scale is not None else (None, None))
        out[n] = _attend_plain(qs[n:n + 1], k_cache[n:n + 1, :m], v_cache[n:n + 1, :m],
                               fr[n:n + 1], *scales, slopes)[0]
    return out.reshape(rows, 1, H, hd)


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, cache_len,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           rows_per_seq: int = 1,
                           slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The decode kernel's function in plain PyTorch (q [rows,1,H,hd])."""
    if q.shape[1] != 1:
        raise ValueError(f"decode attention is single-token, got {q.shape[1]}")
    if rows_per_seq != 1:
        return decode_rows_plain(q, k_cache, v_cache, cache_len, k_scale, v_scale,
                                 rows_per_seq, slopes)
    return cached_attention_plain(q, k_cache, v_cache, cache_len, k_scale, v_scale,
                                  slopes)


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Per-sequence contiguous view [N, mp*ps, KV, hd] of a page pool
    [P+1, ps, KV, hd] through the page tables [N, mp]: the bytes a
    contiguous cache holds at every mapped position."""
    N, mp = page_table.shape
    view = pool[page_table.long()]  # [N, mp, ps, KV, hd]
    return view.reshape(N, mp * pool.shape[1], *pool.shape[2:])


def gather_page_scales(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """[P+1, KV, ps] scale pool → the dense [N, KV, mp*ps] scale layout."""
    N, mp = page_table.shape
    view = pool[page_table.long()].transpose(1, 2)  # [N, KV, mp, ps]
    return view.reshape(N, pool.shape[1], mp * pool.shape[2])


def paged_decode_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, cache_len,
                                 page_table: torch.Tensor,
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None,
                                 rows_per_seq: int = 1,
                                 slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The paged kernel's function in plain PyTorch: the dense plain version
    over the pages gathered into per-sequence views."""
    scales = ((gather_page_scales(k_scale, page_table),
               gather_page_scales(v_scale, page_table))
              if k_scale is not None else (None, None))
    return decode_attention_plain(q, gather_pages(k_pool, page_table),
                                  gather_pages(v_pool, page_table), cache_len,
                                  *scales, rows_per_seq=rows_per_seq, slopes=slopes)


def _check_common(name, q, k, v, k_scale, v_scale, tensors):
    """The checks both forms share; returns (H, KV, hd, int8, mixed): mixed
    is a bf16 cache under fp16 q."""
    _, one, H, hd = q.shape
    KV = k.shape[2]
    int8 = k_scale is not None
    if one != 1:
        raise ValueError(f"{name}: single-token rows, got {one} tokens")
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{name}: q and the cache must be on one CUDA device")
    if q.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"{name}: q dtype {q.dtype}, want bf16, fp16 or fp32")
    want = ((torch.int8,) if int8 else (q.dtype,) + (
        (torch.bfloat16,) if q.dtype == torch.float16 else ()))
    if k.dtype not in want or v.dtype != k.dtype:
        raise ValueError(
            f"{name}: cache dtype {k.dtype}/{v.dtype}, want one of {want} for q "
            f"{q.dtype}{' with scales' if int8 else ''}"
        )
    if k.shape[3] != hd or v.shape != k.shape:
        raise ValueError(f"{name}: cache {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if hd not in HEAD_DIMS or KV == 0 or H % KV or H // KV > MAX_GROUP:
        raise ValueError(
            f"{name}: head_dim {hd} not in {HEAD_DIMS}, or group "
            f"{H}/{KV} not an integer up to {MAX_GROUP}"
        )
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: the head dim must be contiguous")
    item = k.element_size()
    if any(t.data_ptr() % 16 or any(st * item % 16 for st in t.stride()[:3])
           for t in (k, v)):
        raise ValueError(f"{name}: cache rows must start 16-byte aligned")
    if int8 and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
                 or k_scale.stride(-1) != 1 or v_scale.stride(-1) != 1):
        raise ValueError(f"{name}: scales must be fp32 with the positions contiguous")
    return H, KV, hd, int8, k.dtype == torch.bfloat16 and q.dtype == torch.float16


def _entry(lib, name: str, q: torch.Tensor, k: torch.Tensor, int8: bool, mixed: bool):
    """(C entry, its dtype code, the launch counter's dtype suffix) of the
    form for q's dtype: the fp16 entries (``_f16``) take the cache's storage
    code, the others q's."""
    if q.dtype == torch.float16:
        code = _build.dtype_code(torch.float16 if int8 else k.dtype)
        return getattr(lib, f"dst_{name}_f16"), code, "_mixed_f16" if mixed else "_f16"
    return getattr(lib, f"dst_{name}"), _build.dtype_code(q.dtype), ""


def _frontier(cache_len, rows: int, device):
    """Per-row int32 frontiers on the device: (tensor, pointer). A contiguous
    int32 [rows] tensor on the device is taken as it is, with no kernel."""
    if (cache_len.dtype == torch.int32 and cache_len.device == device
            and cache_len.numel() == rows and cache_len.is_contiguous()):
        return cache_len, cache_len.data_ptr()
    cl = cache_len.to(device=device, dtype=torch.int32).reshape(-1)
    cl = cl.expand(rows).contiguous()
    return cl, cl.data_ptr()


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     rows_per_seq: int = 1,
                     slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B*R,1,H,hd] against one cache layer k/v_cache [B,Smax,KV,hd]
    whose positions up to each row's frontier already hold the new tokens;
    row r reads sequence r // R (R = ``rows_per_seq``). ``cache_len`` is an
    int for every row, or an int tensor of each row's frontier ([B*R], or [B]
    when R = 1). An int8 cache comes with its fp32 scales [B,KV,Smax] (one
    layer of the [L,B,KV,Smax] scale caches, read in place); ``slopes`` are
    ALiBi's fp32 [H]. q is bf16, fp16 or fp32; the cache q's dtype, int8
    with scales, or bf16 under fp16 q. Returns [B*R,1,H,hd] in q's dtype.

    CPU tensors take :func:`decode_attention_plain`; CUDA tensors launch the
    kernel, or raise on what it does not take."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len, k_scale,
                                      v_scale, rows_per_seq, slopes)
    lib = _build.library()
    rows = q.shape[0]
    B, Smax = k_cache.shape[0], k_cache.shape[1]
    tensors = (q, k_cache, v_cache) + ((k_scale, v_scale) if k_scale is not None else ())
    H, KV, hd, int8, mixed = _check_common("decode_attention", q, k_cache, v_cache,
                                           k_scale, v_scale, tensors)
    if rows_per_seq < 1 or rows != B * rows_per_seq:
        raise ValueError(
            f"decode_attention: {rows} query rows != {B} sequences x "
            f"rows_per_seq {rows_per_seq}"
        )
    if int8 and (k_scale.shape != (B, KV, Smax) or v_scale.shape != (B, KV, Smax)):
        raise ValueError(f"decode_attention: scales must be [{B}, {KV}, {Smax}]")
    sl = slopes_ptr("decode_attention", slopes, q)
    name = "decode_attention_int8" if int8 else "decode_attention"
    fn, code, dt = _entry(lib, name, q, k_cache, int8, mixed)
    cl_ptr, cl_scalar, cl = None, 0, None
    if isinstance(cache_len, torch.Tensor):
        cl, cl_ptr = _frontier(cache_len, rows, q.device)
    else:
        cl_scalar = int(cache_len)
    out = torch.empty((rows, 1, H, hd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    common = (cl_ptr, cl_scalar, rows, Smax, H, KV, hd, rows_per_seq,
              q.stride(0), q.stride(2), *k_cache.stride()[:3], *v_cache.stride()[:3])
    if int8:
        status = fn(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), out.data_ptr(), *common,
            *k_scale.stride()[:2], *v_scale.stride()[:2],
            sl, 1.0 / math.sqrt(hd), code, stream,
        )
    else:
        status = fn(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
            *common, sl, 1.0 / math.sqrt(hd), code, stream,
        )
    _build.check(status, name + dt)
    launches[name + form_suffix(slopes) + dt] += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, cache_len,
                           page_table: torch.Tensor,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           rows_per_seq: int = 1,
                           slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [N*R,1,H,hd] against one layer of a page pool k/v_pool
    [P+1,ps,KV,hd] through the page tables ``page_table`` [N, mp] (int32
    physical page per logical page; unmapped entries name the NULL page P,
    which no frontier reaches). Row r reads sequence r // R at its frontier
    ``cache_len`` (an int tensor, [N*R], or [N] when R = 1). An int8 pool
    comes with its fp32 scale pools [P+1,KV,ps]; ``slopes`` are ALiBi's fp32
    [H]. Returns [N*R,1,H,hd].

    CPU tensors take :func:`paged_decode_attention_plain`; CUDA tensors
    launch the kernel, or raise on what it does not take. The page table's
    entries are not read on the host: each must name a page of the pool."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, cache_len, page_table,
                                            k_scale, v_scale, rows_per_seq, slopes)
    lib = _build.library()
    rows = q.shape[0]
    P1, ps = k_pool.shape[0], k_pool.shape[1]
    N, mp = page_table.shape
    tensors = (q, k_pool, v_pool, page_table) + (
        (k_scale, v_scale) if k_scale is not None else ())
    H, KV, hd, int8, mixed = _check_common("paged_decode_attention", q, k_pool, v_pool,
                                           k_scale, v_scale, tensors)
    if rows_per_seq < 1 or rows != N * rows_per_seq:
        raise ValueError(
            f"paged_decode_attention: {rows} query rows != {N} sequences x "
            f"rows_per_seq {rows_per_seq}"
        )
    if page_table.dtype != torch.int32 or not page_table.is_contiguous():
        raise ValueError("paged_decode_attention: page_table must be contiguous int32")
    if int8 and (k_scale.shape != (P1, KV, ps) or v_scale.shape != (P1, KV, ps)):
        raise ValueError(f"paged_decode_attention: scales must be [{P1}, {KV}, {ps}]")
    if not isinstance(cache_len, torch.Tensor):
        cache_len = torch.tensor([int(cache_len)])
    cl, cl_ptr = _frontier(cache_len, rows, q.device)
    sl = slopes_ptr("paged_decode_attention", slopes, q)
    name = "paged_decode_attention_int8" if int8 else "paged_decode_attention"
    fn, code, dt = _entry(lib, name, q, k_pool, int8, mixed)
    out = torch.empty((rows, 1, H, hd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    common = (cl_ptr, page_table.data_ptr(), rows, mp, ps, H, KV, hd, rows_per_seq,
              q.stride(0), q.stride(2), *k_pool.stride()[:3], *v_pool.stride()[:3])
    if int8:
        status = fn(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), out.data_ptr(), *common,
            *k_scale.stride()[:2], *v_scale.stride()[:2],
            sl, 1.0 / math.sqrt(hd), code, stream,
        )
    else:
        status = fn(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), out.data_ptr(),
            *common, sl, 1.0 / math.sqrt(hd), code, stream,
        )
    _build.check(status, name + dt)
    launches[name + form_suffix(slopes) + dt] += 1
    return out
