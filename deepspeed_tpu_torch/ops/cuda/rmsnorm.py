"""RMSNorm forward and backward: the CUDA kernels ``csrc/rmsnorm.cu`` and
``csrc/rmsnorm_bwd.cu`` and their plain versions.

The forward replaces ``deepspeed_tpu/ops/pallas/rmsnorm.py:_fwd_kernel``
(line 23), reached through ``_run_fwd`` (line 64) from ``rmsnorm`` (line 110);
the backward replaces ``_bwd_kernel`` (line 30), reached through ``_run_bwd``
(line 80) from the custom VJP.

Bound on the H100: bytes. Forward 2 * rows * D * itemsize, backward
3 * rows * D * itemsize (x and g read, dx written) over 3.35 TB/s. Both read
x in its own dtype (bf16 or fp32, or fp16 with an fp16 scale: the fp16
forms, the entries ``dst_rmsnorm_{fwd,bwd}_f16`` of ``csrc/rmsnorm_f16.cu``
and ``csrc/rmsnorm_bwd_f16.cu``, picked here by x's dtype as the flash
wrapper picks its fp16 entries, counted as ``rmsnorm_fwd_f16`` /
``rmsnorm_bwd_f16``), compute in fp32 and write x's dtype; that fuses the fp32 casts the JAX model wraps around the TPU kernel, so each
result is the fp32 result rounded once. The forward shares
``csrc/norm_fwd.cuh`` with the LayerNorm forward (a team of warps a row, the
row in registers, persistent teams); its sum order is fixed by D, so a row's
bits do not depend on the rows beside it. The backward holds its rows in the
same team layout and sum order; its dscale is summed by each lane over its
rows, by each block over its teams into an fp32 partial row, and by a second
pass over the partial rows: an order fixed by rows and D, with no atomics.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

# kernel launches since the last reset; "_f16": the fp16 forms (fp16 x and scale)
launches = {"rmsnorm_fwd": 0, "rmsnorm_bwd": 0, "rmsnorm_fwd_f16": 0, "rmsnorm_bwd_f16": 0}


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * scale in fp32, returned in x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_bwd_plain(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                      eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx in x's dtype, dscale fp32 [D]) for the upstream gradient g of
    :func:`rmsnorm_plain`; the TPU kernel's formula in fp32."""
    D = x.shape[-1]
    x32, g32 = x.float().reshape(-1, D), g.float().reshape(-1, D)
    rstd = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    xhat = x32 * rstd
    gs = g32 * scale.float()
    dot = (gs * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd * (gs - xhat * dot)).to(x.dtype).reshape(x.shape)
    return dx, (g32 * xhat).sum(dim=0)


def _f16(x: torch.Tensor) -> str:
    """The launch counter's suffix of x's form: "_f16" for fp16."""
    return "_f16" if x.dtype == torch.float16 else ""


def _check(name: str, x: torch.Tensor, *weights: torch.Tensor) -> int:
    """Raise on what the kernels do not take; returns D. Each weight (scale,
    bias) must start on a whole vector of its values: the forward kernels
    load the values that meet one 16-byte vector of x at once."""
    if x.dtype == torch.float16 and any(t.dtype != torch.float16 for t in weights):
        raise ValueError(f"{name}: fp16 x takes an fp16 scale (and bias): the fp16 "
                         f"model's pair")
    D = x.shape[-1]
    vec = 16 // x.element_size()
    if not x.is_cuda or not x.is_contiguous() or x.data_ptr() % 16 or D % vec:
        raise ValueError(
            f"{name}: x must be a contiguous CUDA tensor, 16-byte aligned, with "
            f"a last dim divisible by {vec}"
        )
    device = x.get_device()
    for t in weights:
        if t.get_device() != device or t.dim() != 1 or t.shape[0] != D \
                or not t.is_contiguous() or t.dtype != weights[0].dtype \
                or t.data_ptr() % min(16, vec * t.element_size()):
            raise ValueError(
                f"{name}: scale (and bias) must be contiguous [{D}] of one dtype on "
                f"x's device, aligned to {min(16, vec * t.element_size())} bytes"
            )
    return D


def rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim of x [..., D] with scale [D].

    A CPU tensor takes :func:`rmsnorm_plain`; a CUDA tensor launches the
    kernel, or raises on what the kernel does not take."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    lib = _build.library()
    D = _check("rmsnorm_fwd", x, scale)
    out = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    if x.dtype == torch.float16:
        status = lib.dst_rmsnorm_fwd_f16(x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                                         rows, D, eps, _build.stream_handle(x))
    else:
        status = lib.dst_rmsnorm_fwd(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, D, eps,
            _build.dtype_code(x.dtype), _build.dtype_code(scale.dtype),
            _build.stream_handle(x),
        )
    _build.check(status, "rmsnorm_fwd")
    launches["rmsnorm_fwd" + _f16(x)] += 1
    return out


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx [..., D] in x's dtype, dscale [D] fp32) of RMSNorm for the
    upstream gradient g (x's shape and dtype).

    A CPU tensor takes :func:`rmsnorm_bwd_plain`; a CUDA tensor launches the
    kernel (D at most 2048 * 16 / itemsize: 32 KB a row), or raises."""
    if x.device.type == "cpu":
        return rmsnorm_bwd_plain(x, scale, g, eps)
    lib = _build.library()
    D = _check("rmsnorm_bwd", x, scale)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device \
            or not g.is_contiguous() or g.data_ptr() % 16:
        raise ValueError(
            f"rmsnorm_bwd: g {tuple(g.shape)} {g.dtype} must match x "
            f"{tuple(x.shape)} {x.dtype}, contiguous and 16-byte aligned"
        )
    if D * x.element_size() > 2048 * 16:
        raise ValueError(f"rmsnorm_bwd: D={D} over the kernel's row limit")
    rows = x.numel() // D if D else 0
    code = _build.dtype_code(x.dtype)
    dx = torch.empty_like(x)
    part = torch.empty((lib.dst_rmsnorm_bwd_nblocks(rows, D, code), D),
                       dtype=torch.float32, device=x.device)
    dscale = torch.empty((D,), dtype=torch.float32, device=x.device)  # written whole
    ptrs = (x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr(), part.data_ptr(),
            dscale.data_ptr(), rows, D, float(eps))
    if x.dtype == torch.float16:
        status = lib.dst_rmsnorm_bwd_f16(*ptrs, _build.stream_handle(x))
    else:
        status = lib.dst_rmsnorm_bwd(*ptrs, code, _build.dtype_code(scale.dtype),
                                     _build.stream_handle(x))
    _build.check(status, "rmsnorm_bwd")
    launches["rmsnorm_bwd" + _f16(x)] += 1
    return dx, dscale
