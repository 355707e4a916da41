"""Continuous-batching serving engine: one fixed-shape step over slot-ragged KV.

Counterpart of ``deepspeed_tpu/serving/engine.py`` (``make_step_fn:339``,
``_book_seen:413``, ``make_paged_step_fn:431`` untiered, ``ServingEngine:521``)
and of DeepSpeed-MII / FastGen's continuous-batching engine. The lockstep
``InferenceEngine.generate`` runs one batch to its end; this engine is
slot-based:

- a KV arena holds one region per in-flight request: contiguous slots
  ``[L, max_slots, capacity, KV, hd]``, or (``serving.paged``) a block-paged
  pool ``[L, P+1, page_size, KV, hd]`` shared through per-slot page tables,
  with a prefix cache of finished requests' pages and copy-on-write when a
  slot diverges inside a shared page (int8 KV with its scales in both);
- per-slot frontiers (``start_pos``) replace the scalar cache length;
- every step has the fixed shape ``[max_slots, token_budget]`` and takes
  whatever mix of prompt chunks and decode tokens the scheduler packed
  (Dynamic SplitFuse); ``step_traces`` counts the distinct step shapes, and
  stays 1 whatever the arrivals (the JAX engine's one-compile contract;
  capturing the step in a CUDA graph is later work);
- sampling is per slot and deterministic per request (its own generator,
  temperature, top-k, top-p, penalty), so a request's tokens do not depend
  on the batch it rides in.

On the card every attention of the step runs the decode kernels with
``rows_per_seq = token_budget`` (contiguous or paged; padded rows attend
nothing), the norms the RMSNorm kernel, and the head runs on each slot's
sampled row only. The arena is updated in place.

Not ported yet, and refused with ``NotImplementedError`` naming the ROADMAP
item: ``serving.spec`` (slot-engine speculative decode),
``serving.host_pages`` (KV tiering) and the GPT-2/BLOOM families (their
``InferenceEngine.generate`` is ported), A4; ``serving.fleet``, A9; the
``steptrace`` and ``healthwatch`` arguments, A10. Also waiting:
``trace_export``, ``analytic_streams``, ``parity_pairs``, the page
export/import of the fleet handoff and ``trace_serving_step``.

An MoE model (Mixtral) serves at ep = 1 (``init_inference`` refuses
``ep_size > 1``): the step's MLP routes the real tokens of the step, padded
rows to no expert, with capacity from the token budget, and the step's
expert load counters (``ServingMetrics.on_moe``) come back in the step's one
host read.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ..config import DeepSpeedConfigError, ServingConfig, _parse_dc
from ..inference.engine import InferenceEngine, _align_cache, init_inference
from ..models.decoding import (forward_with_cache, init_cache, init_paged_cache,
                               paged_cow_copy, verify_window_rows)
from ..models.transformer import non_llama_features
from ..utils.logging import log_dist
from .metrics import ServingMetrics
from .request import Request, RequestState
from .scheduler import Scheduler, StepPlan
from .spec import verify_window


def book_seen(seen: torch.Tensor, tokens: torch.Tensor, num_new: torch.Tensor,
              spec_len: torch.Tensor, fresh: torch.Tensor) -> None:
    """The repetition-penalty ``seen`` matrix [N, V] (uint8), in place,
    before the forward, where the lockstep engine books tokens: fresh slots
    clear their row first, then every real fed token (not the drafts, the
    last ``spec_len`` of a row) is set. A max-scatter, so a padded duplicate
    of a token never clears what a real one set."""
    N, W = tokens.shape
    seen.masked_fill_(fresh[:, None], 0)
    valid = torch.arange(W, device=tokens.device)[None, :] < (num_new - spec_len)[:, None]
    idx = tokens.long().clamp(0, seen.shape[1] - 1)
    seen.scatter_reduce_(1, idx, valid.to(seen.dtype), reduce="amax")


class ServingEngine:
    """Request-level front end over one slot-ragged step.

    Drive it with :meth:`submit` and :meth:`step` (one scheduler plan and one
    device step a call), or :meth:`run_until_idle` to drain everything in
    flight. Pass ``engine=`` (an :class:`InferenceEngine`, whose weights the
    engine shares) or ``model=`` with ``init_inference`` keyword arguments
    (``device``, ``dtype``, ``replace_with_kernel_inject``, ...). ``clock``
    (the scheduler's and the metrics' time source) is injectable.

    The step computes in the engine's dtype: bf16 or fp16 on a card (fp16
    with or without ``quantize_bits``; ``dtype="int8"|"int4"`` means bf16
    compute), any float dtype on the CPU. The arena holds
    ``serving.kv_cache_dtype`` (or the engine's ``kv_cache_dtype``): "auto"
    (the compute dtype), "bf16" (under fp16 compute the decode kernels'
    mixed form) or "int8", contiguous or paged alike."""

    def __init__(self, model=None, serving=None,
                 engine: Optional[InferenceEngine] = None, clock=time.monotonic,
                 steptrace=None, healthwatch=None, **engine_kwargs):
        if serving is None:
            serving = ServingConfig()
        elif isinstance(serving, dict):
            serving = _parse_dc(ServingConfig, serving)
        serving.resolve_auto()
        serving.validate()
        later = []
        if serving.spec.enabled:
            later.append("serving.spec (slot-engine speculative decode, ROADMAP A4)")
        if int(serving.host_pages) > 0:
            later.append("serving.host_pages (KV tiering, ROADMAP A4)")
        if serving.fleet.enabled:
            later.append("serving.fleet (the replicated serving tier, ROADMAP A9)")
        if steptrace is not None or healthwatch is not None:
            later.append("steptrace / healthwatch (observability, ROADMAP A10)")
        source = engine if engine is not None else model
        family = non_llama_features(source.config) if source is not None else []
        if family:
            later.append("a GPT-2/BLOOM model (" + ", ".join(family) + "): "
                         "continuous batching of these families, ROADMAP A4")
        if later:
            raise NotImplementedError(
                "deepspeed_tpu_torch serving: not yet ported: " + "; ".join(later))
        self.serving = serving
        if engine is None:
            if model is None:
                raise ValueError("ServingEngine needs a model or an engine")
            if serving.kv_cache_dtype != "auto":
                engine_kwargs.setdefault("kv_cache_dtype", serving.kv_cache_dtype)
            engine_kwargs.setdefault("max_tokens", serving.max_tokens)
            engine = init_inference(model, **engine_kwargs)
        elif engine_kwargs:
            raise ValueError(
                f"ServingEngine: engine= given, so {sorted(engine_kwargs)} "
                "would be ignored; pass them to init_inference")
        self.engine = engine
        self.config = engine.config
        self.device = engine.device
        self.dtype = engine.dtype

        N, W = int(serving.max_slots), int(serving.token_budget)
        self.max_slots, self.token_budget = N, W
        self.max_draft = 0  # speculative decode is refused above
        self.max_tokens = min(int(serving.max_tokens), engine.max_tokens)
        self.paged = bool(serving.paged)
        if self.paged:
            self.page_size = int(serving.page_size)
            # logical pages per slot cover max_tokens + the W write margin
            self.pages_per_slot = serving.pages_per_slot(self.max_tokens)
            self.capacity = self.pages_per_slot * self.page_size
            self.num_pages = int(serving.num_pages) or N * self.pages_per_slot
            if self.num_pages < self.pages_per_slot:
                # liveness floor: after evicting everything else, one request
                # must still be able to run to max_tokens
                raise DeepSpeedConfigError(
                    f"serving.num_pages {self.num_pages} is below the liveness "
                    f"floor ceil((max_tokens + token_budget) / page_size) = "
                    f"{self.pages_per_slot}; one request could never finish")
        else:
            self.page_size = self.num_pages = self.pages_per_slot = None
            self.capacity = _align_cache(self.max_tokens + W)
        self.metrics = ServingMetrics(clock=clock)
        self.metrics.configure(N, num_pages=self.num_pages or 0)
        self.scheduler = Scheduler(
            max_slots=N, token_budget=W, queue_limit=serving.queue_limit,
            request_timeout_s=serving.request_timeout_s,
            eviction_backoff_s=serving.eviction_backoff_s,
            max_tokens=self.max_tokens, clock=clock, metrics=self.metrics,
            page_size=self.page_size if self.paged else None,
            num_pages=self.num_pages if self.paged else None,
            pages_per_slot=self.pages_per_slot if self.paged else None,
            prefix_cache=bool(serving.prefix_cache) if self.paged else False,
        )
        store = engine.kv_cache_storage_dtype
        if self.paged:
            self._caches = init_paged_cache(self.config, self.num_pages, self.page_size,
                                            store, self.device,
                                            quantized=engine.kv_cache_quantized)
        else:
            self._caches = init_cache(self.config, N, self.capacity, store, self.device,
                                      quantized=engine.kv_cache_quantized)
        self._seen = torch.zeros((N, self.config.vocab_size), dtype=torch.uint8,
                                 device=self.device)
        self._step_shapes: set = set()
        arena = (f"pages={self.num_pages}x{self.page_size}tok "
                 f"({self.pages_per_slot}/slot)" if self.paged
                 else f"capacity={self.capacity}/slot")
        kv = "int8" if engine.kv_cache_quantized else str(store).replace("torch.", "")
        log_dist(f"ServingEngine: slots={N}, "
                 f"token_budget={W}, {arena}, kv={kv}, device={self.device}")

    @property
    def step_traces(self) -> int:
        """Distinct step input shapes run so far: 1 after any arrival mix."""
        return len(self._step_shapes)

    @property
    def arena_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self._caches.values())

    # ------------------------------------------------------------- intake
    def submit(self, request: Request) -> RequestState:
        return self.scheduler.submit(request)

    # ------------------------------------------------------------- stepping
    def step(self) -> List[RequestState]:
        """One scheduler plan and one device step. Returns the requests
        that finished this step (their slots already recycled)."""
        plan = self.scheduler.plan()
        if plan is None:
            return []
        return self._run_plan(plan)

    def _run_plan(self, plan: StepPlan) -> List[RequestState]:
        N, W = self.max_slots, self.token_budget
        temp = np.zeros(N, np.float32)
        top_k = np.zeros(N, np.int32)
        top_p = np.ones(N, np.float32)
        penalty = np.ones(N, np.float32)
        eos = np.full(N, -1, np.int32)
        rngs: List[Optional[torch.Generator]] = [None] * N
        for w in plan.work:
            req = w.state.request
            temp[w.slot] = req.temperature
            top_k[w.slot] = req.top_k
            top_p[w.slot] = req.top_p
            penalty[w.slot] = req.repetition_penalty
            eos[w.slot] = req.eos_token_id
            if w.state.rng is None:
                w.state.rng = req.rng_key(self.device)
            rngs[w.slot] = w.state.rng
        spec_len = plan.spec_len if plan.spec_len is not None else np.zeros(N, np.int32)
        if self.paged:
            # idle rows have an all-NULL page-table row: their padded
            # W-wide writes land in the NULL page
            start_pos = plan.start_pos
            paged = (plan.page_table.reshape(-1), plan.cow_src)
        else:
            # idle rows still write a W-wide padded chunk: point it at the
            # dead tail [capacity - W, capacity), which frontiers never reach
            start_pos = np.where(plan.num_new > 0, plan.start_pos,
                                 self.capacity - W).astype(np.int32)
            paged = ()
        self._step_shapes.add((plan.tokens.shape, None if not self.paged
                               else plan.page_table.shape))
        # every int32 input of the step in one host-to-device copy
        parts = (plan.tokens.reshape(-1), plan.num_new, start_pos, spec_len, eos,
                 plan.fresh.astype(np.int32)) + paged
        flat = torch.from_numpy(np.concatenate(parts).astype(np.int32)).to(self.device)
        views = list(torch.split(flat, [p.size for p in parts]))
        tokens = views[0].reshape(N, W)
        num_new, start_t, spec_t, eos_t, fresh = views[1:6]
        live = plan.sample & (plan.num_new > 0)
        with self.engine._impl_ctx(), torch.inference_mode():
            book_seen(self._seen, tokens, num_new, spec_t, fresh.bool())
            page_table = None
            if self.paged:
                page_table = views[6].reshape(plan.page_table.shape)
                if (plan.cow_src >= 0).any():
                    paged_cow_copy(self._caches, page_table, start_t, views[7])
            valid = torch.arange(W, device=self.device)[None, :] < num_new[:, None]
            rows = verify_window_rows(num_new, spec_t, self.max_draft, W)
            win, _, moe = forward_with_cache(
                self.config, self.engine.params, tokens.long(), self._caches, start_t,
                page_table=page_table, token_valid=valid, head_rows=rows,
                return_moe_stats=True)
            out_tok, n_emit = verify_window(win, tokens, self._seen, num_new, spec_t,
                                            live, rngs, temp, top_k, top_p, penalty,
                                            eos_t, self.max_draft)
            host = [out_tok.reshape(-1), n_emit]
            if moe is not None:
                # the MoE counters ride the step's one host read: [E] slot
                # counts, then the drop fraction's fp32 bits
                host += [moe["tokens_per_expert"].to(torch.int32),
                         moe["drop_fraction"].float().reshape(1).view(torch.int32)]
        out = torch.cat(host).cpu().numpy()
        kw = out_tok.shape[1]
        toks, emit = out[:N * kw].reshape(N, kw), out[N * kw:N * kw + N]
        finished = self.scheduler.complete(plan, toks, None, n_emit=emit)
        self.metrics.on_step()
        if moe is not None:
            tail = out[N * kw + N:]
            self.metrics.on_moe(tail[:-1], float(tail[-1:].view(np.float32)[0]))
        return finished

    def run_until_idle(self, max_steps: int = 100_000) -> List[RequestState]:
        """Drain queue and slots; returns every request finished on the way
        (in DONE order). Timed-out requests surface through their states."""
        finished: List[RequestState] = []
        steps = 0
        while self.scheduler.has_work:
            if steps >= max_steps:
                raise RuntimeError(f"serving did not drain within {max_steps} steps")
            finished.extend(self.step())
            steps += 1
        return finished
