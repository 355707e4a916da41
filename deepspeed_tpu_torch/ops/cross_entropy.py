"""Vocab-chunked cross-entropy as a ``torch.autograd.Function``.

Counterpart of ``deepspeed_tpu/ops/cross_entropy.py`` (``chunked_masked_ce``,
line 176): the [tokens, V] logit matrix never materialises. The forward keeps
an online logsumexp over vocab chunks (full chunks plus one ragged tail, so V
need not divide by the chunk); the backward recomputes each chunk's logits
from the saved hidden states and the saved lse. The JAX package has no Pallas
kernel here (the chunk products are plain matmuls XLA tiles), so the chunk
products are ``torch.matmul``.

Departure by design: a bf16 chunk product returns bf16, so the chunk logits
are rounded to bf16 before the fp32 cast, where the JAX einsum accumulates
and returns fp32 (as the dense head does, ``models/transformer.lm_head_logits``).
fp32 inputs agree.

Scope-gated like the kernels: the training engine enters
:class:`fused_ce_scope` from ``tpu_kernels.fused_ce`` / ``ce_chunk``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

_scope_stack: list = []


class fused_ce_scope:
    """Scoped enable (no global mutation), entered by the training engine."""

    def __init__(self, flag: bool, chunk: int = 4096):
        self.val = (bool(flag), int(chunk))

    def __enter__(self):
        _scope_stack.append(self.val)
        return self

    def __exit__(self, *exc):
        _scope_stack.pop()


def fused_ce_config() -> Tuple[bool, int]:
    """(enabled, chunk) for the current scope."""
    return _scope_stack[-1] if _scope_stack else (False, 4096)


def _pieces(V: int, chunk: int) -> List[Tuple[int, int]]:
    """(start, size) of the full chunks and the ragged tail."""
    return [(s, min(chunk, V - s)) for s in range(0, V, chunk)]


def _chunk_logits(y2: torch.Tensor, head: torch.Tensor, start: int,
                  size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    hc = head[:, start:start + size].to(y2.dtype)
    return (y2 @ hc).float(), hc


class ChunkedNLL(torch.autograd.Function):
    """Per-token -log p(label) [N] fp32 for hidden y2 [N, d] (compute dtype),
    head [d, V] (the fp32 master; each chunk is cast to y2's dtype) and
    labels [N] in [0, V)."""

    @staticmethod
    def forward(ctx, y2, head, labels, chunk):
        N = y2.shape[0]
        m = torch.full((N,), -1e30, dtype=torch.float32, device=y2.device)
        s = torch.zeros((N,), dtype=torch.float32, device=y2.device)
        gold = torch.zeros((N,), dtype=torch.float32, device=y2.device)
        for start, size in _pieces(head.shape[1], chunk):
            lc, _ = _chunk_logits(y2, head, start, size)
            m_new = torch.maximum(m, lc.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(lc - m_new[:, None]).sum(-1)
            m = m_new
            in_c = (labels >= start) & (labels < start + size)
            idx = (labels - start).clamp(0, size - 1)
            gold = torch.where(in_c, lc.gather(1, idx[:, None])[:, 0], gold)
        lse = m + torch.log(s)
        ctx.chunk = chunk
        ctx.save_for_backward(y2, head, labels, lse)
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        y2, head, labels, lse = ctx.saved_tensors
        gf = g.float()
        dy = torch.zeros(y2.shape, dtype=torch.float32, device=y2.device)
        dhead = torch.empty(head.shape, dtype=torch.float32, device=head.device)
        rows = torch.arange(y2.shape[0], device=y2.device)
        for start, size in _pieces(head.shape[1], ctx.chunk):
            lc, hc = _chunk_logits(y2, head, start, size)
            dl = torch.exp(lc - lse[:, None])  # softmax over the full vocab
            in_c = (labels >= start) & (labels < start + size)
            idx = (labels - start).clamp(0, size - 1)
            dl[rows, idx] -= in_c.float()
            dl = (dl * gf[:, None]).to(y2.dtype)
            dy += (dl @ hc.t()).float()
            dhead[:, start:start + size] = (y2.t() @ dl).float()
        return dy.to(y2.dtype), dhead.to(head.dtype), None, None


def chunked_masked_ce(y: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                      chunk: int = 4096, denom=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked mean NLL over [..., S] tokens; labels < 0 ignored (HF -100).

    y [..., S, d]; head [d, V] (the fp32 master: the cast to the compute dtype
    happens inside the chunk products). Returns (ce, total_valid_tokens) with
    the semantics of ``models.transformer.masked_ce`` (``denom`` given: the
    NLL sum over it)."""
    d = y.shape[-1]
    labels2 = labels.reshape(-1)
    mask = (labels2 >= 0).float()
    nll = ChunkedNLL.apply(y.reshape(-1, d), head, labels2.clamp(min=0), int(chunk))
    if denom is None:
        denom = mask.sum().clamp(min=1.0)
    return (nll * mask).sum() / denom, denom
