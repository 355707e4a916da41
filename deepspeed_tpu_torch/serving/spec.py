"""Speculative decoding: the draft proposal, the acceptance math and the
serving step's verify window.

Counterpart of ``deepspeed_tpu/serving/spec.py``: :func:`ngram_propose` and
:func:`propose_drafts` (each in a host numpy form and a tensor form),
:func:`longest_accepted_prefix` and :func:`clamp_advance_at_eos`, which the
inference engine's speculative loop (``inference/engine.py``) calls, and
:func:`verify_window` (``spec.py:162``), the sampling tail of the serving
engine's step. The serving engine runs it with ``max_draft = 0`` until its
speculative decode is ported (ROADMAP A4): one token per sampling slot.

Acceptance is greedy and exact: a draft is accepted only when it equals the
token the verifier picks at its position, so the emitted tokens are the plain
greedy tokens; drafts change only how many verifier forwards a generation
needs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = [
    "ngram_propose",
    "propose_drafts",
    "longest_accepted_prefix",
    "clamp_advance_at_eos",
    "verify_window",
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


def verify_window(win: torch.Tensor, tokens: torch.Tensor, seen: torch.Tensor,
                  num_new: torch.Tensor, spec_len: torch.Tensor, live,
                  rngs: Sequence[Optional[torch.Generator]], temperature, top_k,
                  top_p, rep_penalty, eos_id: torch.Tensor, max_draft: int):
    """The serving step's batched-ragged verification and sampling.

    Every live slot's row ends with a verify window: its committed token
    followed by ``spec_len`` drafts (``spec_len = 0`` is plain decode or the
    final prefill feed). For each of the ``max_draft + 1`` window positions
    this samples the target token, accepts the longest draft prefix that
    matches the targets, clamps the advance at an emitted eos, and leaves
    each slot's generator in the state after exactly ``n_emit`` samples.

    Device tensors (N = max_slots, W = token_budget, Kw = max_draft + 1):
      win [N, Kw, V] fp32 logits of the window rows
      (``models.decoding.verify_window_rows``), tokens [N, W], seen [N, V]
      (bool or uint8), num_new/spec_len/eos_id [N].
    Host values: live [N] bool (the slot samples this step), rngs [N] (each
    live slot's generator), temperature/top_k/top_p/rep_penalty [N].

    Greedy rows (temperature 0) take one batched argmax; each sampling row
    draws from its own generator, advanced only when that slot samples, so a
    request's tokens do not depend on the batch it rides in (the JAX
    package's per-slot key chain). The repetition penalty applies to every
    window position with the pre-step ``seen`` matrix; with no live
    penalized row it is skipped (it would be the identity).

    Returns ``(out_tokens [N, Kw] int32, n_emit [N] int32)`` on the device:
    ``out_tokens[:, :n_emit]`` are a slot's emitted tokens this step;
    ``n_emit`` is 0 for rows that do not sample."""
    from ..inference.engine import _sample, apply_repetition_penalty

    N, W = tokens.shape
    kw = max_draft + 1
    dev = win.device
    live = np.asarray(live, bool)
    live_t = torch.as_tensor(live, device=dev)
    temperature = np.asarray(temperature, np.float32)
    penalty = np.asarray(rep_penalty, np.float32)
    if (penalty[live] != 1.0).any():
        win = apply_repetition_penalty(
            win, seen.bool(), torch.as_tensor(penalty, device=dev)[:, None, None],
            active=live_t)
    sampled = [b for b in range(N) if live[b] and temperature[b] != 0.0]
    states = {b: [] for b in sampled}
    targets = []
    for j in range(kw):
        tok = (win[:, j] / 1e-6).argmax(dim=-1)
        for b in sampled:
            if kw > 1:
                states[b].append(rngs[b].get_state())
            tok[b] = _sample(win[b:b + 1, j], rngs[b], float(temperature[b]),
                             int(top_k[b]), float(top_p[b]))[0]
        targets.append(tok)
    out_tokens = torch.stack(targets, dim=1).to(torch.int32)  # [N, kw]
    # drafts ride in the row right after the committed token: window
    # position j's draft is tokens[base + 1 + j]
    base = (num_new - 1 - spec_len).long()
    draft_idx = (base[:, None] + 1 + torch.arange(max_draft, device=dev)[None, :]
                 ).clamp(0, W - 1)
    drafts = tokens.long().gather(1, draft_idx)
    in_window = torch.arange(max_draft, device=dev)[None, :] < spec_len[:, None]
    match = (drafts == out_tokens[:, :max_draft]) & in_window
    n_acc = longest_accepted_prefix(match)
    adv, _ = clamp_advance_at_eos(out_tokens, n_acc + 1, eos_id)
    n_emit = torch.where(live_t, adv, 0).to(torch.int32)
    if kw > 1 and sampled:
        # rewind each sampling slot's generator to the state after n_emit
        # samples: keys past the emitted run were never consumed
        emitted = n_emit.tolist()
        for b in sampled:
            if emitted[b] < kw:
                rngs[b].set_state(states[b][emitted[b]])
    return out_tokens, n_emit
