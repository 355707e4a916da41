"""Attention op registry.

Counterpart of ``deepspeed_tpu/ops/attention.py``. Two implementations:
``plain`` (GQA attention with an fp32 softmax, the counterpart of
``xla_attention``, differentiated by torch) and ``flash`` (the CUDA flash
kernels' wrappers, which take their plain versions for CPU tensors; with a
gradient wanted, :class:`FlashAttentionFunction` pairs the forward kernel with
the dq and dk/dv kernels). ``auto`` resolves per device: flash for CUDA
tensors, plain elsewhere, as the JAX package resolves flash on a TPU and XLA
elsewhere. :class:`attention_impl` scopes a choice. ``alibi_slopes`` (fp32
[H], BLOOM) adds -slope * |q - k| to every score in either implementation; it
takes no gradient (JAX ``ops/attention.py:80-130``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .cuda.flash_attention import (flash_attention_bwd, flash_attention_fwd,
                                   flash_attention_plain, strides_ok)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    alibi_slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B,S,H,hd], k/v [B,S,KV,hd] → [B,S,H,hd] in q's dtype; fp32 softmax."""
    return flash_attention_plain(q, k, v, causal, alibi_slopes)[0]


class FlashAttentionFunction(torch.autograd.Function):
    """The forward kernel, saving (out, lse); the backward runs the dq
    kernel, then the dk/dv kernel (the counterpart of the Pallas flash
    attention's custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, slopes):
        out, lse = flash_attention_fwd(q, k, v, causal, slopes)
        ctx.causal = causal
        ctx.slopes = slopes
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if do.device.type != "cpu" and not strides_ok(do):
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, ctx.causal,
                                         ctx.slopes)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    alibi_slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, causal, alibi_slopes)
    return flash_attention_fwd(q, k, v, causal, alibi_slopes)[0]


_IMPLS: Dict[str, Callable] = {"plain": plain_attention, "flash": flash_attention}
_override_stack: list = []


class attention_impl:
    """Scoped implementation choice: ``with attention_impl("flash"): ...``."""

    def __init__(self, name: str):
        if name != "auto" and name not in _IMPLS:
            raise KeyError(f"unknown attention impl {name!r}; have {sorted(_IMPLS)}")
        self.name = name

    def __enter__(self):
        _override_stack.append(self.name)
        return self

    def __exit__(self, *exc):
        _override_stack.pop()


def resolve_attention_impl(device: torch.device) -> str:
    """The implementation that runs now for tensors on ``device``."""
    name = _override_stack[-1] if _override_stack else "auto"
    if name != "auto":
        return name
    return "flash" if device.type == "cuda" else "plain"


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True,
              alibi_slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _IMPLS[resolve_attention_impl(q.device)](q, k, v, causal=causal,
                                                    alibi_slopes=alibi_slopes)
