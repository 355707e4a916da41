"""RMSNorm forward: the CUDA kernel ``csrc/rmsnorm.cu`` and its plain version.

Replaces ``deepspeed_tpu/ops/pallas/rmsnorm.py:_fwd_kernel`` (line 23),
reached through ``_run_fwd`` (line 64) from ``rmsnorm`` (line 110).

Bound on the H100: bytes, 2 * rows * D * itemsize over 3.35 TB/s. The kernel
reads x in its own dtype (bf16 or fp32), computes in fp32 and writes x's dtype,
one 256-thread block per row; that fuses the fp32 casts the JAX model wraps
around the TPU kernel, so its result is the fp32 result rounded once.
"""

from __future__ import annotations

import torch

from . import _build

launches = 0  # kernel launches since the last reset


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * scale in fp32, returned in x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim of x [..., D] with scale [D].

    A CPU tensor takes :func:`rmsnorm_plain`; a CUDA tensor launches the
    kernel, or raises on what the kernel does not take."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    global launches
    lib = _build.library()
    D = x.shape[-1]
    vec = 16 // x.element_size()
    if not (x.is_cuda and scale.device == x.device):
        raise ValueError("rmsnorm_fwd: x and scale must be on one CUDA device")
    if scale.shape != (D,) or not scale.is_contiguous():
        raise ValueError(f"rmsnorm_fwd: scale must be contiguous [{D}]")
    if not x.is_contiguous() or x.data_ptr() % 16 or D % vec:
        raise ValueError(
            "rmsnorm_fwd: x must be contiguous, 16-byte aligned, with a last "
            f"dim divisible by {vec}"
        )
    out = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    status = lib.dst_rmsnorm_fwd(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, D, float(eps),
        _build.dtype_code(x.dtype), _build.dtype_code(scale.dtype),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "rmsnorm_fwd")
    launches += 1
    return out
