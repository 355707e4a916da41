"""Normalization ops: the dispatch between the RMSNorm and LayerNorm kernels
and the plain expressions.

Counterpart of ``deepspeed_tpu/ops/normalization.py``. Under a
:class:`kernel_rmsnorm_scope` that is on (the inference engine enters one
under kernel injection on a CUDA device, the training engine when
``tpu_kernels.fused_rmsnorm`` resolves on), :func:`rmsnorm` and
:func:`layernorm` go to the kernel wrappers, which launch the CUDA kernels for
CUDA tensors and take their plain versions for CPU tensors. One scope covers
both norms, as the JAX package's one ``tpu_kernels.fused_rmsnorm`` knob covers
rmsnorm and layernorm: a model uses one of them. Where a gradient is wanted,
the call goes through :class:`RMSNormFunction` or :class:`LayerNormFunction`,
whose backward is the backward kernel; without one (serving, under
``no_grad``/``inference_mode``) the forward wrapper is called directly, with
no autograd bookkeeping. Off the scope it is the plain expression,
differentiated by torch, as the JAX package runs XLA off-kernel.
"""

from __future__ import annotations

import torch

from .cuda.layernorm import layernorm_bwd, layernorm_fwd, layernorm_plain
from .cuda.rmsnorm import rmsnorm_bwd, rmsnorm_fwd, rmsnorm_plain

_scope_stack: list = []


class kernel_rmsnorm_scope:
    """Scoped kernel selection, so two engines with different choices in one
    process do not fight."""

    def __init__(self, flag: bool):
        self.flag = bool(flag)

    def __enter__(self):
        _scope_stack.append(self.flag)
        return self

    def __exit__(self, *exc):
        _scope_stack.pop()


class RMSNormFunction(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient (the
    counterpart of the Pallas rmsnorm's custom VJP)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, scale)
        return rmsnorm_fwd(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, g.contiguous(), ctx.eps)
        return dx, dscale.to(scale.dtype), None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim in fp32, returned in x's dtype."""
    if _scope_stack and _scope_stack[-1]:
        if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
            return RMSNormFunction.apply(x, scale, eps)
        return rmsnorm_fwd(x, scale, eps)
    return rmsnorm_plain(x, scale, eps)


class LayerNormFunction(torch.autograd.Function):
    """The LayerNorm forward kernel, with the backward kernel (dx, dscale,
    dbias) as its gradient (the counterpart of the Pallas layernorm's custom
    VJP)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, scale)
        return layernorm_fwd(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale, dbias = layernorm_bwd(x, scale, g.contiguous(), ctx.eps)
        return dx, dscale.to(scale.dtype), dbias.to(scale.dtype), None


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim in fp32, returned in x's dtype."""
    if _scope_stack and _scope_stack[-1]:
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, scale, bias)):
            return LayerNormFunction.apply(x, scale, bias, eps)
        return layernorm_fwd(x, scale, bias, eps)
    return layernorm_plain(x, scale, bias, eps)
