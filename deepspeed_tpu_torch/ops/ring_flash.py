"""Ring flash attention: the flash kernels' offset form around the sp ring.

Counterpart of ``deepspeed_tpu/ops/pallas/ring_flash.py`` (``_offsets`` line
63, ``_rf_fwd`` line 83, ``_rf_bwd`` line 120, ``ring_flash_attention_local``
line 178), which has no ``pallas_call`` of its own. Each hop runs the flash
forward (``ops/cuda/flash_attention.py``; its plain version on CPU tensors)
on the visiting key/value chunk with the global position offsets
[i * S_loc, blk * S_loc] of the local query chunk i and of the chunk blk it
holds at that hop, so the causal and ALiBi terms are exact across hops, and
the hops' partial (out, lse) merge by logsumexp in fp32. The backward follows
FlashAttention-2's final-lse recompute ring-style: every hop recomputes p
from the saved final lse, its dq kernel is handed the final output (so the
delta it writes is the ring's), dq accumulates locally in fp32, and the dk/dv
accumulators travel with their kv chunk, with one more rotation home at the
end. The slopes take no gradient (zero, as in the JAX package).

The hops' transport is a :class:`Ring`: the sp-ring members this process
holds and a ``shift`` that moves each member's payload to the next member.
``Ring.over(group)`` is one member, the process's rank in an sp process group
(``comm.ring_shift``: ``batch_isend_irecv``); ``Ring.loopback(n)`` holds all n
members in one process and rotates their list, for the tests and for a
one-process check on the card. Layouts are the model's, [B, S_loc, H|KV, D].

Bound on the H100: each hop is a flash kernel launch at the chunk's shape
(the kernels' notes in ``csrc/flash_attention_fwd.cu`` and
``csrc/flash_attention_bwd.cu``); the merge moves the fp32 accumulator
[B, S_loc, H, D] once per hop, and the ring moves k, v (and, backward, the
fp32 dk, dv) once per hop.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from ..comm.collectives import (group_rank, group_size, ring_shift,
                                ring_shift_differentiable)
from .cuda.flash_attention import (NEG_INF, flash_attention_bwd_dkv, flash_attention_bwd_dq,
                                   flash_attention_fwd, strides_ok)


class Ring:
    """The sp ring's transport: ``size`` members, of which this process
    holds ``members`` (their ring indices), and ``shift(payloads)`` taking
    one tuple of tensors per held member and returning, per held member, the
    tuple its predecessor sent. ``shift_grad`` is the same move for floating
    tensors whose gradient must flow back against the ring."""

    def __init__(self, size: int, members: Sequence[int], shift: Callable,
                 shift_grad: Callable):
        self.size, self.members = size, list(members)
        self.shift, self.shift_grad = shift, shift_grad

    @classmethod
    def over(cls, group) -> "Ring":
        """This process's rank in the sp process group ``group``."""
        def move(payloads, fn=ring_shift):
            return [tuple(fn(payloads[0], group))]

        return cls(group_size(group), [group_rank(group)], move,
                   lambda payloads: move(payloads, ring_shift_differentiable))

    @classmethod
    def loopback(cls, size: int) -> "Ring":
        """All ``size`` members in this process: a shift rotates the list."""
        def rotate(payloads):
            return [payloads[-1], *payloads[:-1]]

        return cls(size, range(size), rotate, rotate)


def hop_offsets(i: int, blk: int, S_loc: int):
    """(qoff, koff): global positions of the local query chunk ``i`` and of
    the key chunk ``blk`` visiting it (JAX ``_offsets``)."""
    return (i * S_loc, blk * S_loc)


def _seg(seg_q, segb):
    return None if seg_q is None else (seg_q, segb)


def ring_flash_fwd(ring: Ring, qs, ks, vs, seg_q, seg_k, slopes, causal: bool):
    """Per held member: (out [B,S_loc,H,D] in q's dtype, lse [B,H,S_loc]
    fp32) of attention over the whole ring (JAX ``_rf_fwd``)."""
    sp, S_loc = ring.size, qs[0].shape[1]
    has_seg = seg_q is not None
    out_acc = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    lse_acc = [torch.full((q.shape[0], q.shape[2], S_loc), NEG_INF, dtype=torch.float32,
                          device=q.device) for q in qs]
    kv = [(k, v, seg_k[j]) if has_seg else (k, v) for j, (k, v) in enumerate(zip(ks, vs))]
    for s in range(sp):
        for j, i in enumerate(ring.members):
            kb, vb, *segb = kv[j]
            o, lse = flash_attention_fwd(
                qs[j], kb, vb, causal, slopes, None,
                _seg(seg_q[j] if has_seg else None, segb[0] if has_seg else None), None,
                offsets=hop_offsets(i, (i - s) % sp, S_loc))
            # the associative flash merge of the (out, lse) partials
            lse_new = torch.logaddexp(lse_acc[j], lse)
            w_acc = torch.exp(lse_acc[j] - lse_new).transpose(1, 2)[..., None]
            w_hop = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
            out_acc[j] = out_acc[j] * w_acc + o.float() * w_hop
            lse_acc[j] = lse_new
        if s < sp - 1:
            kv = ring.shift(kv)
    return [a.to(q.dtype) for a, q in zip(out_acc, qs)], lse_acc


def ring_flash_bwd(ring: Ring, qs, ks, vs, seg_q, seg_k, slopes, causal: bool, outs,
                   lses, dos):
    """Per held member: (dq, dk, dv) in the inputs' dtypes (JAX ``_rf_bwd``)."""
    sp, S_loc = ring.size, qs[0].shape[1]
    has_seg = seg_q is not None
    dq_acc = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    kv = [(k, v, seg_k[j]) if has_seg else (k, v) for j, (k, v) in enumerate(zip(ks, vs))]
    # the dk/dv accumulators travel with their kv chunk, so every (q_i, kv_j)
    # pair contributes once, on q_i's member
    dkv = [(torch.zeros(k.shape, dtype=torch.float32, device=k.device),
            torch.zeros(v.shape, dtype=torch.float32, device=v.device))
           for k, v in zip(ks, vs)]
    for s in range(sp):
        for j, i in enumerate(ring.members):
            kb, vb, *segb = kv[j]
            kw = dict(segment_ids=_seg(seg_q[j] if has_seg else None,
                                       segb[0] if has_seg else None),
                      offsets=hop_offsets(i, (i - s) % sp, S_loc))
            dq_s, delta = flash_attention_bwd_dq(qs[j], kb, vb, outs[j], lses[j], dos[j],
                                                 causal, slopes, **kw)
            dk_s, dv_s = flash_attention_bwd_dkv(qs[j], kb, vb, lses[j], delta, dos[j],
                                                 causal, slopes, **kw)
            dq_acc[j] += dq_s.float()
            dkv[j] = (dkv[j][0] + dk_s.float(), dkv[j][1] + dv_s.float())
        if s < sp - 1:
            kv = ring.shift(kv)
            dkv = ring.shift(dkv)
    # after the last hop, chunk (i + 1)'s accumulator sits on member i: one
    # more rotation delivers every accumulator home
    dkv = ring.shift(dkv)
    return ([a.to(q.dtype) for a, q in zip(dq_acc, qs)],
            [a.to(k.dtype) for (a, _), k in zip(dkv, ks)],
            [a.to(v.dtype) for (_, a), v in zip(dkv, vs)])


class RingFlashFunction(torch.autograd.Function):
    """The ring's forward, saving (out, lse) per member; the backward runs
    the ring's backward. Tensors arrive flat: n queries, n keys, n values."""

    @staticmethod
    def forward(ctx, ring, causal, slopes, seg_q, seg_k, n, *qkv):
        qs, ks, vs = qkv[:n], qkv[n:2 * n], qkv[2 * n:]
        outs, lses = ring_flash_fwd(ring, qs, ks, vs, seg_q, seg_k, slopes, causal)
        ctx.ring, ctx.causal, ctx.slopes, ctx.seg_q, ctx.seg_k, ctx.n = (
            ring, causal, slopes, seg_q, seg_k, n)
        ctx.save_for_backward(*qkv, *outs, *lses)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *dos):
        n = ctx.n
        saved = ctx.saved_tensors
        qs, ks, vs = saved[:n], saved[n:2 * n], saved[2 * n:3 * n]
        outs, lses = saved[3 * n:4 * n], saved[4 * n:]
        dos = [d.contiguous() if d.device.type != "cpu" and not strides_ok(d) else d
               for d in dos]
        dq, dk, dv = ring_flash_bwd(ctx.ring, qs, ks, vs, ctx.seg_q, ctx.seg_k, ctx.slopes,
                                    ctx.causal, outs, lses, dos)
        return (None, None, None, None, None, None, *dq, *dk, *dv)


def ring_flash_attention_local(qs: List[torch.Tensor], ks: List[torch.Tensor],
                               vs: List[torch.Tensor], seg_q: Optional[list] = None,
                               seg_k: Optional[list] = None,
                               slopes: Optional[torch.Tensor] = None, *, causal: bool,
                               ring: Ring) -> List[torch.Tensor]:
    """Ring flash attention for the members ``ring`` holds: one q [B,S_loc,H,D],
    k/v [B,S_loc,KV,D] (and, with segments, int32 [B,S_loc] query and key
    ids) per held member, in ``ring.members`` order; returns one output per
    member. Differentiable in q, k, v."""
    n = len(ring.members)
    if not (len(qs) == len(ks) == len(vs) == n):
        raise ValueError(f"ring_flash_attention_local: {n} members, got {len(qs)} q, "
                         f"{len(ks)} k, {len(vs)} v")
    if (seg_q is None) != (seg_k is None):
        raise ValueError("ring_flash_attention_local: give both query and key segment ids "
                         "or neither")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (*qs, *ks, *vs)):
        return list(RingFlashFunction.apply(ring, causal, slopes, seg_q, seg_k, n,
                                            *qs, *ks, *vs))
    return ring_flash_fwd(ring, qs, ks, vs, seg_q, seg_k, slopes, causal)[0]
