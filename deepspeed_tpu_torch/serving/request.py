"""Serving requests: lifecycle, sampling state, deterministic RNG.

Counterpart of ``deepspeed_tpu/serving/request.py``. A :class:`Request` is
what a client submits; the scheduler wraps it in a :class:`RequestState`
that tracks the status lifecycle

    QUEUED -> PREFILL -> DECODE -> DONE
        \\______________________-> EVICTED   (timeout / queue overflow)

plus the per-request random generator. Sampling is deterministic: a
request's sampled tokens depend only on its generator's seed, its prompt
and the weights, never on what else shares the batch. Where the JAX package
carries a threefry key per request, the port carries a ``torch.Generator``
on the engine's device, seeded from the same CRC32 of the request id, and
advanced only when the request samples.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


class RequestStatus(str, Enum):
    QUEUED = "queued"      # admitted, waiting for a slot
    PREFILL = "prefill"    # slot assigned, prompt chunks streaming in
    DECODE = "decode"      # prompt cached, generating tokens
    DONE = "done"          # eos or max_new_tokens reached
    EVICTED = "evicted"    # timed out / rejected; retry after backoff


# legal lifecycle edges (EVICTED is reachable from any live state)
_TRANSITIONS = {
    RequestStatus.QUEUED: {RequestStatus.PREFILL, RequestStatus.EVICTED},
    RequestStatus.PREFILL: {RequestStatus.DECODE, RequestStatus.DONE,
                            RequestStatus.EVICTED},
    RequestStatus.DECODE: {RequestStatus.DONE, RequestStatus.EVICTED},
    RequestStatus.DONE: set(),
    RequestStatus.EVICTED: {RequestStatus.QUEUED},  # resubmission
}


def request_seed(request_id, seed: int = 0) -> int:
    """The generator seed of a request: the CRC32 of its id (the JAX
    package's ``request_rng`` folds the same CRC into its base key) beside
    the base seed. Stable across processes, independent of submission
    order."""
    h = zlib.crc32(str(request_id).encode()) & 0x7FFFFFFF
    return (int(seed) << 31) | h


def request_rng(request_id, seed: int = 0, device=None) -> torch.Generator:
    """A fresh ``torch.Generator`` on ``device`` seeded by
    :func:`request_seed`."""
    return torch.Generator(device=device or "cpu").manual_seed(
        request_seed(request_id, seed))


@dataclass
class Request:
    """One generation request (the client surface). ``rng`` is a
    ``torch.Generator`` on the serving engine's device; the engine samples
    with a copy of it taken at submission, so the caller's generator is not
    advanced and a retried request starts from the same state."""

    request_id: str
    prompt: np.ndarray  # [S] int token ids
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    eos_token_id: int = -1
    rng: Optional[torch.Generator] = None  # default: request_rng(request_id)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError(f"request {self.request_id}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"request {self.request_id}: max_new_tokens must be >= 1"
            )
        self._rng_state = self.rng.get_state() if self.rng is not None else None

    def rng_key(self, device=None) -> torch.Generator:
        """A fresh generator in the request's initial state: a copy of
        ``rng`` as submitted, or :func:`request_rng` on ``device``."""
        if self.rng is None:
            return request_rng(self.request_id, device=device)
        g = torch.Generator(device=self.rng.device)
        g.set_state(self._rng_state)
        return g


@dataclass
class RequestState:
    """Scheduler-side view of one request: status, slot, progress,
    timing. All timestamps come from the scheduler's injected clock."""

    request: Request
    status: RequestStatus = RequestStatus.QUEUED
    slot: Optional[int] = None
    arrival_t: float = 0.0
    prefill_start_t: Optional[float] = None
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    prompt_pos: int = 0          # prompt tokens already fed (chunked prefill)
    tokens: List[int] = field(default_factory=list)  # generated tokens
    attempts: int = 0            # submissions (eviction backoff input)
    retry_after: Optional[float] = None  # set on eviction
    evict_reason: Optional[str] = None
    rng: Optional[torch.Generator] = None  # the CURRENT generator (advances
    #   as tokens sample); None until the engine first schedules the request,
    #   and again after an eviction rewinds it
    # ---- block-paged KV arena (scheduler-owned; empty on the contiguous
    # arena) ------------------------------------------------------------
    pages: List[int] = field(default_factory=list)  # physical page per
    #   logical page, in order; pages[:owned_from] are SHARED (read-only,
    #   prefix-cache refs) — a write into one triggers copy-on-write
    owned_from: int = 0          # first logical page this request owns
    cached_tokens: int = 0       # prompt tokens skipped via the prefix cache
    # ---- tiered KV (host spill; empty when serving.host_pages == 0) ----
    host_pages: Dict[int, Tuple[int, bool]] = field(default_factory=dict)
    #   logical page index -> (host store key, owned); the matching
    #   pages[li] is -1 while the entry exists
    last_planned: int = 0        # scheduler tick this slot last made
    #   progress (demotion victim ordering: coldest slot spills first)
    # ---- speculative decoding (serving/spec.py) -----------------------
    draft_tail: List[int] = field(default_factory=list)  # the previous
    #   verify window's REJECTED targets (next draft's no-match fallback)

    # ----------------------------------------------------------- lifecycle
    def transition(self, new: RequestStatus) -> None:
        if new not in _TRANSITIONS[self.status]:
            raise ValueError(
                f"request {self.request.request_id}: illegal transition "
                f"{self.status.value} -> {new.value}"
            )
        self.status = new

    @property
    def prompt_len(self) -> int:
        return int(self.request.prompt.size)

    @property
    def prompt_remaining(self) -> int:
        return self.prompt_len - self.prompt_pos

    @property
    def finished(self) -> bool:
        return self.status in (RequestStatus.DONE, RequestStatus.EVICTED)

    def output(self) -> np.ndarray:
        """[prompt + max_new_tokens] ids, eos-padded past the last real
        token — the same layout single-request ``generate`` returns."""
        req = self.request
        fill = req.eos_token_id if req.eos_token_id >= 0 else 0
        out = np.full(self.prompt_len + req.max_new_tokens, fill, np.int32)
        out[: self.prompt_len] = req.prompt
        gen = np.asarray(self.tokens, np.int32)
        out[self.prompt_len: self.prompt_len + gen.size] = gen
        return out
