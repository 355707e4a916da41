"""Flash attention forward: the CUDA kernel ``csrc/flash_attention_fwd.cu``
and its plain version.

Replaces ``deepspeed_tpu/ops/pallas/flash_attention.py:_fwd_kernel``
(line 175), driven by ``_flash_fwd`` (line 334) from ``flash_attention``
(line 1011), in the serving prefill's form: causal, GQA, no segment ids,
bias or ALiBi.

Bound on the H100: operations for long prompts, 4 * D flops per visible
(query, key) pair over 989 TFLOP/s bf16. The kernel runs one 4-warp block per
(64-row query tile, head, batch row) with mma.sync bf16 tensor-core products,
an fp32 online softmax in registers and a key loop that stops at the
diagonal. It reads the model layout [B, S, H, D] through strides (no
transposes) and masks ragged S itself, so every prompt bucket runs through
it, where the TPU entry fell back to XLA without a 128-aligned tile.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from . import _build

launches = 0  # kernel launches since the last reset

NEG_INF = -1e30  # the JAX package's mask value (finite: a fully masked row stays finite)
HEAD_DIMS = (64, 128)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference GQA attention in fp32: (out [B,S,H,D] in q's dtype,
    lse [B,H,S] fp32). q [B,S,H,D]; k, v [B,S,KV,D]."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    if H % KV:
        raise ValueError(f"heads {H} not a multiple of kv heads {KV}")
    kf = k.float().repeat_interleave(H // KV, dim=2)
    vf = v.float().repeat_interleave(H // KV, dim=2)
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    if causal:
        above = torch.ones(S, k.shape[1], dtype=torch.bool,
                           device=q.device).triu(1)
        s = s.masked_fill(above, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vf)
    return out.to(q.dtype), lse


def _check_strides(name: str, t: torch.Tensor) -> None:
    if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]) \
            or t.data_ptr() % 16:
        raise ValueError(
            f"flash_attention_fwd: {name} needs a contiguous last dim, "
            "strides divisible by 8 and a 16-byte aligned start"
        )


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B,S,H,D], lse [B,H,S] fp32) for q [B,S,H,D], k/v [B,S,KV,D].

    CPU tensors take :func:`flash_attention_plain`; CUDA tensors launch the
    kernel (bf16, head_dim 64 or 128), or raise on what it does not take."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    global launches
    lib = _build.library()
    B, S, H, D = q.shape
    KV = k.shape[2]
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("flash_attention_fwd: q, k, v must be on one CUDA device")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError(
            f"flash_attention_fwd: the kernel takes bfloat16, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if k.shape != (B, S, KV, D) or v.shape != k.shape:
        raise ValueError(
            f"flash_attention_fwd: k/v {tuple(k.shape)}/{tuple(v.shape)} do "
            f"not match q {tuple(q.shape)}"
        )
    if D not in HEAD_DIMS or H % KV:
        raise ValueError(
            f"flash_attention_fwd: head_dim {D} not in {HEAD_DIMS} or heads "
            f"{H} not a multiple of kv heads {KV}"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_strides(name, t)
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    status = lib.dst_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, S, H, KV, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        1.0 / math.sqrt(D), int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "flash_attention_fwd")
    launches += 1
    return out, lse
