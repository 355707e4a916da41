"""Single-token decode attention: the CUDA kernel ``csrc/decode_attention.cu``
and its plain version.

Replaces ``deepspeed_tpu/ops/pallas/decode_attention.py:_decode_kernel``
(line 76, with ``_tile_update`` at line 35), reached through
``decode_attention_kernel`` (line 160) from ``decode_attention`` (line 323):
the dense form over a bf16 or fp32 cache, and the int8 form
(``has_scales=True``) over an int8 cache with fp32 scales, one per
(token, kv head), in the port's [B, KV, Smax] layer layout. The int8 form
dequantizes each K/V value as it lands in shared memory, float(q) * scale
rounded to q's dtype, the TPU kernel's order (``_tile_update:42-43``).

Bound on the H100: bytes, the K and V rows up to each row's frontier over
3.35 TB/s. One 128-thread block per (kv head, batch row) shares every K/V tile
among the G query heads of the group and loops over key tiles up to the row's
own frontier, carrying the fp32 online softmax in the block (the TPU kernel
carried it across a sequential grid axis, which Hopper does not have). The
cache layer is read in place through its strides. At B = 1 only KV blocks
run (8 of 132 SMs for Llama-3-8B): split-K is the later fix.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

# kernel launches since the last reset
launches = {"decode_attention": 0, "decode_attention_int8": 0}

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
MAX_GROUP = 8  # query heads per kv head the kernel holds


def dequantize_cache(cache: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 cache [B,Smax,KV,hd] times its scales [B,KV,Smax], in fp32."""
    return cache.float() * scale.transpose(1, 2)[..., None]


def cached_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, cache_len,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attend S new queries against a cache that already holds them.

    q [B,S,H,hd]; k/v_cache [B,Smax,KV,hd]; cache_len an int or a per-row
    [B] tensor: query s of row b sits at position cache_len[b] + s and sees
    every cache position at or before it. An int8 cache comes with its
    scales [B,KV,Smax] and is dequantized as the decode kernel does it,
    float(q) * scale rounded to q's dtype. fp32 softmax; returns [B,S,H,hd]
    in q's dtype. For S = 1 this is the decode kernel's function.

    For S > 1 new tokens against a cache already holding tokens (a
    speculative verify window) the JAX package runs plain XLA
    (``models/decoding.py`` lines 413-444), not a Pallas kernel, and this is
    its counterpart on the CPU and for windows of several sequences. On the
    card a window of one sequence runs the decode kernel instead, one row per
    window token (``models/decoding.py:_decode_rows``): this function's
    fp32 einsum and the kernel's online softmax round differently, and over
    32 layers that moved a greedy token of Llama-3-8B on the H100. The XLA
    path keeps the dequantized rows in fp32; rounding them to q's dtype, as
    the decode kernel does, keeps this function's window rows on the values
    single-token decode sees (in fp32 the two are the same)."""
    B, S, H, hd = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    if k_scale is not None:
        k_cache = dequantize_cache(k_cache, k_scale).to(q.dtype)
        v_cache = dequantize_cache(v_cache, v_scale).to(q.dtype)
    kf = k_cache.float().repeat_interleave(H // KV, dim=2)
    vf = v_cache.float().repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (1.0 / math.sqrt(hd))
    kpos = torch.arange(Smax, device=q.device)[None, None, None, :]
    qpos = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1, 1, 1) \
        + torch.arange(S, device=q.device)[None, None, :, None]
    s = torch.where(kpos <= qpos, s, NEG_INF)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vf)
    return out.to(q.dtype)


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, cache_len,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The decode kernel's function in plain PyTorch (q [B,1,H,hd])."""
    if q.shape[1] != 1:
        raise ValueError(f"decode attention is single-token, got {q.shape[1]}")
    return cached_attention_plain(q, k_cache, v_cache, cache_len, k_scale, v_scale)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B,1,H,hd] against one cache layer k/v_cache [B,Smax,KV,hd] whose
    position ``cache_len`` (int, or int [B] tensor) already holds the new
    token. An int8 cache comes with its fp32 scales [B,KV,Smax] (one layer
    of the [L,B,KV,Smax] scale caches, read in place). Returns [B,1,H,hd].

    CPU tensors take :func:`decode_attention_plain`; CUDA tensors launch the
    kernel, or raise on what it does not take."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len, k_scale, v_scale)
    lib = _build.library()
    B, one, H, hd = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    int8 = k_scale is not None
    if one != 1:
        raise ValueError(f"decode_attention: single-token, got {one} tokens")
    tensors = (q, k_cache, v_cache) + ((k_scale, v_scale) if int8 else ())
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("decode_attention: q and the cache must be on one CUDA device")
    want = torch.int8 if int8 else q.dtype
    if k_cache.dtype != want or v_cache.dtype != want:
        raise ValueError(
            f"decode_attention: cache dtype {k_cache.dtype}, want {want} "
            f"for q {q.dtype}{' with scales' if int8 else ''}"
        )
    if int8 and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
                 or k_scale.shape != (B, KV, Smax) or v_scale.shape != (B, KV, Smax)
                 or k_scale.stride(-1) != 1 or v_scale.stride(-1) != 1):
        raise ValueError(
            f"decode_attention: scales must be fp32 [{B}, {KV}, {Smax}] with "
            "the sequence contiguous"
        )
    if k_cache.shape != (B, Smax, KV, hd) or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"decode_attention: cache {tuple(k_cache.shape)} does not match q "
            f"{tuple(q.shape)}"
        )
    if hd not in HEAD_DIMS or KV == 0 or H % KV or H // KV > MAX_GROUP:
        raise ValueError(
            f"decode_attention: head_dim {hd} not in {HEAD_DIMS}, or group "
            f"{H}/{KV} not an integer up to {MAX_GROUP}"
        )
    if any(t.stride(-1) != 1 for t in (q, k_cache, v_cache)):
        raise ValueError("decode_attention: the head dim must be contiguous")
    item = k_cache.element_size()
    if any(t.data_ptr() % 16 or any(st * item % 16 for st in t.stride()[:3])
           for t in (k_cache, v_cache)):
        raise ValueError("decode_attention: cache rows must start 16-byte aligned")
    code = _build.dtype_code(q.dtype)
    cl_ptr, cl_scalar, cl = None, 0, None
    if isinstance(cache_len, torch.Tensor):
        cl = cache_len.to(device=q.device, dtype=torch.int32).reshape(-1)
        cl = cl.expand(B).contiguous()
        cl_ptr = cl.data_ptr()
    else:
        cl_scalar = int(cache_len)
    out = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if int8:
        status = lib.dst_decode_attention_int8(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), out.data_ptr(),
            cl_ptr, cl_scalar, B, Smax, H, KV, hd,
            q.stride(0), q.stride(2), *k_cache.stride()[:3], *v_cache.stride()[:3],
            *k_scale.stride()[:2], *v_scale.stride()[:2],
            1.0 / math.sqrt(hd), code, stream,
        )
        name = "decode_attention_int8"
    else:
        status = lib.dst_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
            cl_ptr, cl_scalar, B, Smax, H, KV, hd,
            q.stride(0), q.stride(2), *k_cache.stride()[:3], *v_cache.stride()[:3],
            1.0 / math.sqrt(hd), code, stream,
        )
        name = "decode_attention"
    _build.check(status, name)
    launches[name] += 1
    return out
