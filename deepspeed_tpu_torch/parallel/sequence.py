"""Sequence parallelism: DeepSpeed-Ulysses and ring attention.

Counterpart of ``deepspeed_tpu/parallel/sequence.py`` (``set_sp_mode`` line
38, ``get_sp_mode`` line 47, ``ulysses_attention`` line 64, ``_kv_head_axes``
line 102, ``_ring_attention_local`` line 128, ``ring_attention`` line 200,
``sp_attention`` line 285). Each rank of the sp group holds one chunk of the
sequence, [B, S/sp, ...]; attention is the only place the chunks meet.

- **Ulysses** is DeepSpeed's explicit ``_SeqAllToAll`` pair
  (deepspeed/sequence/layer.py), where the JAX package states it as two
  sharding constraints: an all-to-all turns the sequence-chunked q, k, v
  into head-chunked ones over the whole sequence (rank r takes query heads
  [r H/sp, (r+1) H/sp) and their kv heads; kv heads are first repeated when
  sp does not divide them, the Ulysses-GQA replication of ``_kv_head_axes``),
  any attention implementation runs unmodified on the rank's heads (ALiBi
  slopes and a dense bias cut to them, segment ids gathered whole), and the
  reverse all-to-all brings the output back to sequence chunks.
- **Ring** keeps q, k, v sequence-chunked and rotates the k/v chunks round
  the sp ring: with the flash implementation through the kernels' offset
  form (``ops/ring_flash.py``), otherwise as the dense online-softmax ring,
  plain torch differentiated by autograd. Peak memory per rank is O(S/sp).
"""

from __future__ import annotations

import math

import torch

from ..comm.collectives import all_gather, all_to_all
from ..models.sharding import current_topology
from ..ops.attention import attention, resolve_attention_impl
from ..ops.ring_flash import Ring, ring_flash_attention_local
from ..utils.logging import log_dist

_SP_MODE = "ulysses"  # process default; engines attach sp_mode to their topology

VALID_MODES = ("ulysses", "ring")


def set_sp_mode(mode: str) -> None:
    """Set the process-wide default. Engines override per topology
    (``topology.sp_mode``), so two engines with different modes don't fight."""
    global _SP_MODE
    if mode not in VALID_MODES:
        raise ValueError(f"sequence_parallel mode {mode!r} (ulysses|ring)")
    _SP_MODE = mode


def get_sp_mode() -> str:
    topo = current_topology()
    mode = getattr(topo, "sp_mode", None) if topo is not None else None
    return mode or _SP_MODE


def kv_repeats(kv_heads: int, sp: int) -> int:
    """How many times each kv head is repeated so that sp divides the kv
    heads (1 when it already does): the replication ``_kv_head_axes`` falls
    back to when kv_heads < sp, here made explicit so that rank r's kv heads
    are exactly those its query heads read."""
    return 1 if kv_heads % sp == 0 else sp // math.gcd(kv_heads, sp)


def ulysses_attention(q, k, v, *, causal=True, bias=None, segment_ids=None,
                      alibi_slopes=None, topo=None):
    """DS-Ulysses: all-to-all sequence → heads, attention over the whole
    sequence on this rank's heads, all-to-all back. q [B, S_loc, H, hd],
    k/v [B, S_loc, KV, hd] (this rank's chunk); ``segment_ids`` [B, S_loc];
    ``bias`` over the whole sequence [B|1, H|1, S, S]; ``alibi_slopes`` [H]."""
    topo = topo or current_topology()
    group, sp, r = topo.group("sp"), topo.sp_size, topo.coord("sp")
    H, KV = q.shape[2], k.shape[2]
    if H % sp:
        raise ValueError(f"ulysses: {H} query heads do not split over sp={sp}")
    rep = kv_repeats(KV, sp)
    if rep > 1:
        k, v = (t.repeat_interleave(rep, dim=2) for t in (k, v))
    q, k, v = (all_to_all(t, group, split_dim=2, concat_dim=1) for t in (q, k, v))
    heads = slice(r * H // sp, (r + 1) * H // sp)
    if segment_ids is not None:
        segment_ids = all_gather(segment_ids, group, dim=1)
    if alibi_slopes is not None:
        alibi_slopes = alibi_slopes[heads].contiguous()
    if bias is not None and bias.shape[1] > 1:
        bias = bias[:, heads]
    out = attention(q, k, v, causal=causal, bias=bias, segment_ids=segment_ids,
                    alibi_slopes=alibi_slopes)
    return all_to_all(out, group, split_dim=1, concat_dim=2)


def _ring_attention_local(ring: Ring, qs, ks, vs, seg_q, seg_k, slopes, *, causal: bool):
    """The dense online-softmax ring (JAX ``_ring_attention_local``), per held
    member: [B, S_loc, H|KV, hd] blocks, positions globalized from the ring
    index, an fp32 [B, H, S_loc, S_loc] logits tensor per hop. Plain torch,
    differentiated by autograd through the ring's gradient-carrying shift."""
    sp = ring.size
    B, Sq, H, hd = qs[0].shape
    reps = H // ks[0].shape[2]  # GQA: expand per hop, the ring carries KV heads
    scale = 1.0 / math.sqrt(hd)
    dev = qs[0].device
    ar = torch.arange(Sq, device=dev)
    state = []
    for q in qs:
        state.append((torch.full((B, H, Sq), -math.inf, device=dev),
                      torch.zeros(B, H, Sq, device=dev),
                      torch.zeros(B, Sq, H, hd, device=dev)))
    kv = list(zip(ks, vs))
    segs = list(seg_k) if seg_k is not None else None
    for s in range(sp):
        for j, i in enumerate(ring.members):
            m, l, acc = state[j]
            kb, vb = kv[j]
            qpos, kpos = i * Sq + ar, ((i - s) % sp) * Sq + ar
            ke = kb.repeat_interleave(reps, dim=2) if reps > 1 else kb
            ve = vb.repeat_interleave(reps, dim=2) if reps > 1 else vb
            logits = torch.einsum("bqhd,bkhd->bhqk", qs[j].float(), ke.float()) * scale
            if slopes is not None:
                rel = -(qpos[:, None].float() - kpos[None, :].float()).abs()
                logits = logits + slopes[None, :, None, None] * rel[None, None]
            valid = torch.ones(B, 1, Sq, Sq, dtype=torch.bool, device=dev)
            if causal:
                valid = valid & (kpos[None, None, None, :] <= qpos[None, None, :, None])
            if segs is not None:
                valid = valid & (seg_q[j][:, None, :, None] == segs[j][:, None, None, :])
            logits = logits.masked_fill(~valid, -math.inf)
            m_new = torch.maximum(m, logits.amax(-1))
            # rows with nothing visible so far keep m = -inf: guard inf - inf
            m_safe = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new), m_new)
            p = torch.exp(logits - m_safe[..., None]) * valid
            corr = torch.where(torch.isneginf(m), torch.zeros_like(m), torch.exp(m - m_safe))
            l = l * corr + p.sum(-1)
            acc = acc * corr.transpose(1, 2)[..., None] + torch.einsum(
                "bhqk,bkhd->bqhd", p, ve.float())
            state[j] = (m_new, l, acc)
        if s < sp - 1:
            kv = ring.shift_grad(kv)
            if segs is not None:
                segs = [t[0] for t in ring.shift([(t,) for t in segs])]
    return [(acc / l.clamp(min=1e-30).transpose(1, 2)[..., None]).to(q.dtype)
            for (_, l, acc), q in zip(state, qs)]


def ring_attention(q, k, v, *, causal=True, segment_ids=None, alibi_slopes=None,
                   topo=None):
    """Ring attention over the sp group (q/k/v arrive as this rank's
    sequence chunk [B, S_loc, H|KV, hd]). ALiBi rides as per-head slopes
    applied at global positions inside the ring; RoPE is already applied
    upstream at global positions. The flash implementation runs the ring
    flash (the kernels' offset form), any other the dense ring."""
    topo = topo or current_topology()
    if topo is None or topo.sp_size == 1:
        return attention(q, k, v, causal=causal, segment_ids=segment_ids,
                         alibi_slopes=alibi_slopes)
    ring = Ring.over(topo.group("sp"))
    seg = [segment_ids] if segment_ids is not None else None
    if resolve_attention_impl(q.device) == "flash":
        return ring_flash_attention_local([q], [k], [v], seg, seg, alibi_slopes,
                                          causal=causal, ring=ring)[0]
    return _ring_attention_local(ring, [q], [k], [v], seg, seg, alibi_slopes,
                                 causal=causal)[0]


_warned_fallback = set()


def sp_attention(q, k, v, *, causal=True, bias=None, segment_ids=None,
                 alibi_slopes=None):
    """Dispatch by the sp mode; called from the model's attention when the
    installed topology has sp > 1. A dense bias takes Ulysses in ring mode
    too (logged once): the ring has no dense-bias path."""
    if get_sp_mode() == "ring":
        if bias is None:
            return ring_attention(q, k, v, causal=causal, segment_ids=segment_ids,
                                  alibi_slopes=alibi_slopes)
        reason = "dense attention bias is unsupported on the ring path"
        if reason not in _warned_fallback:  # the memory profile changes: say so
            log_dist(f"warning: sequence_parallel mode 'ring' falling back to ulysses: "
                     f"{reason} (full sequence will be materialized per rank inside "
                     f"attention)")
            _warned_fallback.add(reason)
    return ulysses_attention(q, k, v, causal=causal, bias=bias, segment_ids=segment_ids,
                             alibi_slopes=alibi_slopes)
