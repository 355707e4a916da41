"""LayerNorm forward and backward: the CUDA kernels ``csrc/layernorm.cu`` and
``csrc/layernorm_bwd.cu`` and their plain versions.

The forward replaces ``deepspeed_tpu/ops/pallas/layernorm.py:_fwd_kernel``
(line 25), reached through ``_run_fwd`` (line 65) from ``layernorm`` (line
112); the backward replaces ``_bwd_kernel`` (line 37), reached through
``_run_bwd`` (line 83) from the custom VJP.

Bound on the H100: bytes. Forward 2 * rows * D * itemsize, backward
3 * rows * D * itemsize (x and g read, dx written) over 3.35 TB/s. Both take
the mean first and the variance as the mean of (x - mean)^2, as the TPU
kernel does; both read x in its own dtype (bf16, fp16 or fp32), compute in fp32 and
write x's dtype, which fuses the fp32 casts the JAX model wraps around the
TPU kernel, so each result is the fp32 result rounded once. The forward
shares ``csrc/norm_fwd.cuh`` with the RMSNorm forward (a team of warps a row,
the row in registers, persistent teams; the sum order fixed by D). The backward
runs a warp (up to 8 for the widest rows) per row; its dscale and dbias are
summed per block in fp32 partial rows and merged column strip by column
strip in a second pass, with no atomics: two runs give the same bits.

fp16 x with an fp16 scale and bias (the fp16 GPT-2 and BLOOM models' pair)
takes the fp16 forms, the entries ``dst_layernorm_{fwd,bwd}_f16`` of
``csrc/layernorm_f16.cu`` and ``csrc/layernorm_bwd_f16.cu`` (the same kernels,
dx rounded to nearest: an overflow stays inf), counted as
``layernorm_fwd_f16`` / ``layernorm_bwd_f16``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .rmsnorm import _check, _f16

# kernel launches since the last reset; "_f16": the fp16 forms
launches = {"layernorm_fwd": 0, "layernorm_bwd": 0, "layernorm_fwd_f16": 0,
            "layernorm_bwd_f16": 0}


def layernorm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """(x - mean) * rsqrt(mean((x - mean)^2) + eps) * scale + bias in fp32,
    returned in x's dtype."""
    x32 = x.float()
    xc = x32 - x32.mean(dim=-1, keepdim=True)
    var = xc.square().mean(dim=-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps) * scale.float() + bias.float()).to(x.dtype)


def layernorm_bwd_plain(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                        eps: float = 1e-5
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx in x's dtype, dscale fp32 [D], dbias fp32 [D]) for the upstream
    gradient g of :func:`layernorm_plain`; the TPU kernel's formula in fp32,
    dx = rstd * (gs - mean(gs) - xhat * mean(gs * xhat)) with gs = g * scale."""
    D = x.shape[-1]
    x32, g32 = x.float().reshape(-1, D), g.float().reshape(-1, D)
    xc = x32 - x32.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(xc.square().mean(dim=-1, keepdim=True) + eps)
    xhat = xc * rstd
    gs = g32 * scale.float()
    m1 = gs.mean(dim=-1, keepdim=True)
    m2 = (gs * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd * (gs - m1 - xhat * m2)).to(x.dtype).reshape(x.shape)
    return dx, (g32 * xhat).sum(dim=0), g32.sum(dim=0)


def layernorm_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim of x [..., D] with scale and bias [D] (one
    dtype).

    A CPU tensor takes :func:`layernorm_plain`; a CUDA tensor launches the
    kernel, or raises on what the kernel does not take."""
    if x.device.type == "cpu":
        return layernorm_plain(x, scale, bias, eps)
    lib = _build.library()
    D = _check("layernorm_fwd", x, scale, bias)
    out = torch.empty_like(x)
    ptrs = (x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            x.numel() // D if D else 0, D, eps)
    if x.dtype == torch.float16:
        status = lib.dst_layernorm_fwd_f16(*ptrs, _build.stream_handle(x))
    else:
        status = lib.dst_layernorm_fwd(*ptrs, _build.dtype_code(x.dtype),
                                       _build.dtype_code(scale.dtype), _build.stream_handle(x))
    _build.check(status, "layernorm_fwd")
    launches["layernorm_fwd" + _f16(x)] += 1
    return out


def layernorm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                  eps: float = 1e-5
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx [..., D] in x's dtype, dscale [D] fp32, dbias [D] fp32) of
    LayerNorm for the upstream gradient g (x's shape and dtype).

    A CPU tensor takes :func:`layernorm_bwd_plain`; a CUDA tensor launches the
    kernel (D at most 1024 * 16 / itemsize), or raises."""
    if x.device.type == "cpu":
        return layernorm_bwd_plain(x, scale, g, eps)
    lib = _build.library()
    D = _check("layernorm_bwd", x, scale)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device \
            or not g.is_contiguous() or g.data_ptr() % 16:
        raise ValueError(
            f"layernorm_bwd: g {tuple(g.shape)} {g.dtype} must match x "
            f"{tuple(x.shape)} {x.dtype}, contiguous and 16-byte aligned"
        )
    if D * x.element_size() > 1024 * 16:
        raise ValueError(f"layernorm_bwd: D={D} over the kernel's row limit")
    rows = x.numel() // D if D else 0
    code = _build.dtype_code(x.dtype)
    dx = torch.empty_like(x)
    part = torch.empty((2 * lib.dst_layernorm_bwd_nblocks(rows, D, code), D),
                       dtype=torch.float32, device=x.device)
    dscale = torch.zeros((D,), dtype=torch.float32, device=x.device)
    dbias = torch.zeros((D,), dtype=torch.float32, device=x.device)
    ptrs = (x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr(), part.data_ptr(),
            dscale.data_ptr(), dbias.data_ptr(), rows, D, float(eps))
    if x.dtype == torch.float16:
        status = lib.dst_layernorm_bwd_f16(*ptrs, _build.stream_handle(x))
    else:
        status = lib.dst_layernorm_bwd(*ptrs, code, _build.dtype_code(scale.dtype),
                                       _build.stream_handle(x))
    _build.check(status, "layernorm_bwd")
    launches["layernorm_bwd" + _f16(x)] += 1
    return dx, dscale, dbias
