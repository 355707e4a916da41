"""Speculative decoding: the draft proposal and the acceptance math.

Counterpart of the lockstep pieces of ``deepspeed_tpu/serving/spec.py``:
:func:`ngram_propose` and :func:`propose_drafts` (each in a host numpy form
and a tensor form), :func:`longest_accepted_prefix` and
:func:`clamp_advance_at_eos`. The inference engine's speculative loop
(``inference/engine.py``) calls them; the slot engine's batched verify comes
with continuous batching.

Acceptance is greedy and exact: a draft is accepted only when it equals the
token the verifier picks at its position, so the emitted tokens are the plain
greedy tokens; drafts change only how many verifier forwards a generation
needs.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = [
    "ngram_propose",
    "propose_drafts",
    "longest_accepted_prefix",
    "clamp_advance_at_eos",
]


def ngram_propose(buf, pos, k: int, n: int):
    """n-gram / prompt-lookup draft: ``k`` tokens proposed for positions
    ``pos+1 .. pos+k`` of a ``[T]`` token buffer.

    The most recent earlier occurrence of the ``n`` tokens ending at ``pos``
    supplies the continuation. With no match, the slice past ``pos`` is
    returned: the speculative loop keeps the previous window's verifier
    predictions there, free and plausible proposals. ``buf`` must hold at
    least ``pos + 1 + k`` tokens.

    A numpy buffer with an integer ``pos`` runs on the host and returns
    numpy; a tensor runs as tensor ops on its device with no host sync (the
    slice start is clamped into the buffer, as ``lax.dynamic_slice``
    does)."""
    if isinstance(buf, np.ndarray) and isinstance(pos, (int, np.integer)):
        buf = buf.astype(np.int32)
        idx = np.arange(buf.shape[0])
        match = (idx >= n - 1) & (idx < pos)
        for t in range(n):
            match &= np.roll(buf, t) == buf[pos - t]
        e = int(np.max(np.where(match, idx, -1)))
        start = e + 1 if e >= 0 else pos + 1
        return buf[start:start + k]
    buf = torch.as_tensor(buf)
    T = buf.shape[0]
    idx = torch.arange(T, device=buf.device)
    pos_t = torch.as_tensor(pos, device=buf.device)
    match = (idx >= n - 1) & (idx < pos_t)
    for t in range(n):
        match &= torch.roll(buf, t) == buf[pos_t - t]
    e = torch.where(match, idx, -1).max()
    start = torch.where(e >= 0, e + 1, pos_t + 1).clamp(0, T - k)
    return buf[start + torch.arange(k, device=buf.device)]


def propose_drafts(prompt: Sequence[int], tokens: Sequence[int],
                   draft_tail: Sequence[int], k: int, n: int) -> np.ndarray:
    """Host-side draft proposal for one sequence: ``k`` int tokens for the
    positions after its last committed token.

    The lookup buffer is the committed stream (prompt + generated tokens,
    the last of which is the token the next step feeds) with the previous
    verify's rejected targets appended as the no-match fallback run, the
    buffer layout of the speculative loop, through :func:`ngram_propose`."""
    committed = np.concatenate([
        np.asarray(prompt, np.int32).reshape(-1),
        np.asarray(tokens, np.int32).reshape(-1),
    ])
    pos = int(committed.size - 1)
    tail = np.asarray(list(draft_tail), np.int32)
    pad = max(pos + 1 + k - (committed.size + tail.size), 0)
    buf = np.concatenate([committed, tail, np.zeros(pad, np.int32)])
    return np.asarray(ngram_propose(buf, pos, k, n), np.int32)


def longest_accepted_prefix(match) -> torch.Tensor:
    """Accepted-draft count from a ``[..., k]`` bool match vector: the length
    of the leading all-True run (a draft is conditioned correctly only when
    every draft before it was accepted)."""
    match = torch.as_tensor(match)
    return torch.cumprod(match.to(torch.int32), dim=-1).sum(dim=-1)


def clamp_advance_at_eos(targets, adv, eos_id):
    """Clamp a window advance at the first emitted eos: of the ``adv``
    tokens about to be emitted from ``targets [..., k]``, an eos at emitted
    index ``j`` cuts the advance to ``j + 1``. Returns ``(adv, has_eos)``;
    ``eos_id`` may be -1 (no eos: token ids are non-negative). Batched
    (``targets [N, k]``, ``adv``/``eos_id`` ``[N]``) and scalar forms."""
    targets = torch.as_tensor(targets)
    k = targets.shape[-1]
    adv = torch.as_tensor(adv, device=targets.device)
    eos = torch.as_tensor(eos_id, device=targets.device)
    acc = torch.arange(k, device=targets.device) < adv[..., None]
    is_eos = (targets == eos[..., None]) & acc
    has_eos = is_eos.any(dim=-1)
    first = is_eos.to(torch.int32).argmax(dim=-1) + 1
    return torch.where(has_eos, first, adv), has_eos
