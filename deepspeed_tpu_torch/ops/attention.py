"""Attention op registry.

Counterpart of ``deepspeed_tpu/ops/attention.py``. Two implementations:
``plain`` (GQA attention with an fp32 softmax, the counterpart of
``xla_attention``, differentiated by torch) and ``flash`` (the CUDA flash
kernels' wrappers, which take their plain versions for CPU tensors; with a
gradient wanted, :class:`FlashAttentionFunction` pairs the forward kernel with
the dq and dk/dv kernels and, for a bias that wants one, the bias gradient).
``auto`` resolves per device: flash for CUDA tensors, plain elsewhere, as the
JAX package resolves flash on a TPU and XLA elsewhere. :class:`attention_impl`
scopes a choice, a registered name or a callable with the attention signature
(the training engine's block-sparse implementation, JAX ``_resolve``, line
59). Every implementation takes the JAX op's terms (``ops/attention.py:80-130``):
``alibi_slopes`` (fp32 [H], BLOOM) adds -slope * |q - k| to every score and
takes no gradient; ``bias`` is a dense additive bias ([B|1, H|1, S, S] for
flash, which raises on any other shape); ``segment_ids`` [B, S] keeps each
query to the keys of its own segment (packed sequences).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from .cuda.flash_attention import (check_bias, flash_attention_bwd, flash_attention_fwd,
                                   flash_attention_plain, strides_ok)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bias: Optional[torch.Tensor] = None,
                    segment_ids: Optional[torch.Tensor] = None,
                    alibi_slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B,S,H,hd], k/v [B,S,KV,hd] → [B,S,H,hd] in q's dtype; fp32 softmax."""
    return flash_attention_plain(q, k, v, causal, alibi_slopes, bias, segment_ids)[0]


class FlashAttentionFunction(torch.autograd.Function):
    """The forward kernel, saving (out, lse); the backward runs the dq
    kernel, then the dk/dv kernel (the counterpart of the Pallas flash
    attention's custom VJP), and the bias's gradient only when autograd asks
    for one. The saved bias is the caller's tensor, not a copy."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, slopes, segment_ids, layout):
        out, lse = flash_attention_fwd(q, k, v, causal, slopes, bias, segment_ids, layout)
        ctx.causal, ctx.slopes, ctx.segment_ids, ctx.layout = (causal, slopes,
                                                               segment_ids, layout)
        ctx.save_for_backward(q, k, v, out, lse, bias)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, bias = ctx.saved_tensors
        if do.device.type != "cpu" and not strides_ok(do):
            do = do.contiguous()
        bias_grad = bias is not None and ctx.needs_input_grad[3]
        dq, dk, dv, *dbias = flash_attention_bwd(
            q, k, v, out, lse, do, ctx.causal, ctx.slopes, bias, ctx.segment_ids,
            ctx.layout, bias_grad)
        return dq, dk, dv, (dbias[0] if bias_grad else None), None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bias: Optional[torch.Tensor] = None,
                    segment_ids: Optional[torch.Tensor] = None,
                    alibi_slopes: Optional[torch.Tensor] = None,
                    layout: Optional[np.ndarray] = None) -> torch.Tensor:
    """The flash kernels (their plain versions for CPU tensors), with a
    block-sparse ``layout`` where one is given; raises on a bias that is not
    [B|1, H|1, S, S], where the JAX entry falls back to XLA."""
    if bias is not None:
        check_bias("flash_attention", bias, q)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (q, k, v, bias)):
        return FlashAttentionFunction.apply(q, k, v, bias, causal, alibi_slopes,
                                            segment_ids, layout)
    return flash_attention_fwd(q, k, v, causal, alibi_slopes, bias, segment_ids,
                               layout)[0]


_IMPLS: Dict[str, Callable] = {"plain": plain_attention, "flash": flash_attention}
_override_stack: list = []


class attention_impl:
    """Scoped implementation choice: ``with attention_impl("flash"): ...``,
    or a callable with the attention signature."""

    def __init__(self, name: Union[str, Callable]):
        if isinstance(name, str) and name != "auto" and name not in _IMPLS:
            raise KeyError(f"unknown attention impl {name!r}; have {sorted(_IMPLS)}")
        self.name = name

    def __enter__(self):
        _override_stack.append(self.name)
        return self

    def __exit__(self, *exc):
        _override_stack.pop()


def resolve_attention_impl(device: torch.device) -> Union[str, Callable]:
    """The implementation that runs now for tensors on ``device``: a
    registered name, or the scoped callable."""
    name = _override_stack[-1] if _override_stack else "auto"
    if name != "auto":
        return name
    return "flash" if device.type == "cuda" else "plain"


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, bias: Optional[torch.Tensor] = None,
              segment_ids: Optional[torch.Tensor] = None,
              alibi_slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    impl = resolve_attention_impl(q.device)
    fn = impl if callable(impl) else _IMPLS[impl]
    return fn(q, k, v, causal=causal, bias=bias, segment_ids=segment_ids,
              alibi_slopes=alibi_slopes)
