"""Single-token decode attention: the CUDA kernel ``csrc/decode_attention.cu``
and its plain version.

Replaces ``deepspeed_tpu/ops/pallas/decode_attention.py:_decode_kernel``
(line 76, with ``_tile_update`` at line 35), reached through
``decode_attention_kernel`` (line 160) from ``decode_attention`` (line 323):
the dense form, bf16 or fp32 cache, no int8 scales.

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

import torch

from . import _build

launches = {"decode_attention": 0}  # kernel launches since the last reset

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
MAX_GROUP = 8  # query heads per kv head the kernel holds


def cached_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, cache_len) -> torch.Tensor:
    """Attend S new queries against a cache that already holds them.

    q [B,S,H,hd]; k/v_cache [B,Smax,KV,hd]; cache_len an int or a per-row
    [B] tensor: query s of row b sits at position cache_len[b] + s and sees
    every cache position at or before it. fp32 softmax; returns [B,S,H,hd]
    in q's dtype. For S = 1 this is the decode kernel's function."""
    B, S, H, hd = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
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
                           v_cache: torch.Tensor, cache_len) -> torch.Tensor:
    """The decode kernel's function in plain PyTorch (q [B,1,H,hd])."""
    if q.shape[1] != 1:
        raise ValueError(f"decode attention is single-token, got {q.shape[1]}")
    return cached_attention_plain(q, k_cache, v_cache, cache_len)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len) -> torch.Tensor:
    """q [B,1,H,hd] against one cache layer k/v_cache [B,Smax,KV,hd] whose
    position ``cache_len`` (int, or int [B] tensor) already holds the new
    token. Returns [B,1,H,hd].

    CPU tensors take :func:`decode_attention_plain`; CUDA tensors launch the
    kernel, or raise on what it does not take."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len)
    lib = _build.library()
    B, one, H, hd = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    if one != 1:
        raise ValueError(f"decode_attention: single-token, got {one} tokens")
    if not all(t.is_cuda and t.device == q.device for t in (q, k_cache, v_cache)):
        raise ValueError("decode_attention: q and the cache must be on one CUDA device")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(
            f"decode_attention: cache dtype {k_cache.dtype} differs from q "
            f"{q.dtype}"
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
    item = q.element_size()
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
    status = lib.dst_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        cl_ptr, cl_scalar, B, Smax, H, KV, hd,
        q.stride(0), q.stride(2), *k_cache.stride()[:3], *v_cache.stride()[:3],
        1.0 / math.sqrt(hd), code,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "decode_attention")
    launches["decode_attention"] += 1
    return out
