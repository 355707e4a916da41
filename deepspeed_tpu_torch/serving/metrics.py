"""Serving metrics: TTFT/TPOT, queue depth, occupancy, tokens/s.

Counterpart of ``deepspeed_tpu/serving/metrics.py:74 ServingMetrics``: the
serving-side telemetry DeepSpeed-MII exposes per deployment, cheap counters
updated by scheduler and engine hooks and a ``summary()`` table on demand.
The steptrace and healthwatch bridges and ``FleetMetrics`` come with the
observability and fleet ports (ROADMAP A10, A9).

Glossary (docs/serving.md):

- **TTFT** — time to first token: first sampled token minus arrival.
- **TPOT** — time per output token: (finish - first token) / (tokens - 1)
  for requests that produced more than one token. The denominator is
  TOKENS ACTUALLY EMITTED, never decode steps: with speculative decoding
  a step emits 1..k+1 tokens per slot and ``on_token`` fires once per
  emitted token, so spec-on TPOT (and tokens/s) stay honest.
- **queue depth** — requests admitted but not yet slotted (gauge).
- **slot occupancy** — in-flight requests / max_slots (gauge).
- **tokens/s** — sampled tokens over the engine-step window.
- **acceptance rate** — accepted draft tokens / proposed draft tokens
  (speculative decoding; 0.0 with spec off).
- **mean accepted tokens/step** — tokens emitted per verify window
  (accepted drafts + the bonus token); 1.0 means no draft ever accepted,
  > 1 is the speculative speedup multiplier on decode steps.
"""

from __future__ import annotations

import math
import time
from collections import defaultdict
from typing import Dict, List, Optional


def _finite(v, default: float = 0.0):
    """Sanitize one reported value: NaN/inf (or an unconvertible input)
    becomes ``default`` so the summary line and the CSV/monitor bridge
    NEVER carry a NaN — an empty window reports 0, not poison. Integer
    counters pass through unchanged (the snapshot JSON keeps its
    shape: ``"submitted": 3``, not ``3.0``)."""
    if isinstance(v, int):  # bool is an int too; both are finite
        return v
    try:
        f = float(v)
    except (TypeError, ValueError):
        return default
    return f if math.isfinite(f) else default


def percentile(values: List[float], p: float) -> float:
    """Nearest-rank percentile over the FINITE samples; 0.0 on an empty
    (or all-non-finite) window — the summary never dies and never
    reports NaN before the first request completes."""
    xs = sorted(v for v in values if isinstance(v, (int, float))
                and math.isfinite(v))
    if not xs:
        return 0.0
    idx = min(len(xs) - 1, max(0, int(round(p / 100.0 * (len(xs) - 1)))))
    return xs[idx]


class ServingMetrics:
    def __init__(self, clock=time.monotonic):
        self.clock = clock
        self._t0 = clock()
        # counters
        self.submitted = 0
        self.admitted = 0
        self.rejected = 0
        self.evicted = 0
        self.finished = 0
        self.steps = 0
        self.tokens_out = 0
        self.scheduled_tokens = 0     # real tokens fed (prefill + decode)
        # paged arena / prefix cache
        self.prefix_lookups = 0       # slot admissions that consulted it
        self.prefix_hits = 0          # admissions with >= 1 cached token
        self.cached_prompt_tokens = 0  # prompt tokens skipped via cache
        self.prompt_tokens_seen = 0   # prompt tokens over those lookups
        self.cow_copies = 0           # in-step copy-on-write page copies
        self.prefill_chunks = 0       # scheduled prompt chunks (a fully-
        #   cached prompt's lone final-token feed does not count)
        self.cached_tail_feeds = 0    # those excluded final-token feeds
        # tiered KV (serving.host_pages > 0)
        self.pages_spilled = 0        # HBM pages demoted to the host tier
        self.pages_promoted = 0       # host pages staged back under steps
        self.spill_bytes = 0          # at-rest (codec-compressed) bytes out
        self.promote_bytes = 0        # at-rest bytes decoded back in
        self.page_in_stall_s = 0.0    # host-side blob decode + staging
        #   time (the part of page-in NOT hidden under device math)
        self.host_prefix_hits = 0     # admissions that extended a prefix
        #   hit with >= 1 HOST-tier page (chains that survived eviction)
        self.host_cached_prompt_tokens = 0  # prompt tokens covered by
        #   those host-resident blocks (promoted instead of refed)
        # speculative decoding
        self.spec_steps = 0           # verify windows executed (slot-steps
        #   that carried >= 1 draft row)
        self.draft_tokens_proposed = 0
        self.draft_tokens_accepted = 0
        self.spec_tokens_out = 0      # tokens emitted by verify windows
        #   (accepted drafts + bonus tokens)
        # MoE serving (expert-parallel decode)
        self.moe_steps = 0            # steps that routed through experts
        self.moe_tokens_per_expert: List[int] = []  # cumulative histogram
        #   of capacity slots landed per expert (summed over layers)
        self.moe_routed_tokens = 0    # token-expert assignments kept
        self.moe_dropped_fraction = 0.0  # last step's dropped fraction
        #   (valid token-expert assignments that overflowed capacity)
        self.moe_a2a_bytes = 0        # cumulative expert-exchange wire
        #   bytes (the analytic moe_decode_a2a stream; 0 without ep)
        # gauges (last observed)
        self.queue_depth = 0
        self.slot_occupancy = 0.0
        self.pages_in_use = 0
        self.pages_free = 0
        self.arena_utilization = 0.0
        self.prefix_cache_entries = 0
        self.host_pages_resident = 0  # host-store keys alive (gauge)
        self._max_slots = 1
        self._num_pages = 0
        self._host_pages = 0
        # per-request samples
        self.ttft_s: List[float] = []
        self.tpot_s: List[float] = []
        self.queue_wait_s: List[float] = []
        self.evict_reasons: Dict[str, int] = defaultdict(int)

    # ------------------------------------------------- scheduler hooks
    def on_submit(self, state, now: float, queue_depth: int = 0) -> None:
        self.submitted += 1
        self.queue_depth = queue_depth

    def on_admit(self, state, now: float, queue_depth: int = 0) -> None:
        self.admitted += 1
        self.queue_depth = queue_depth
        self.queue_wait_s.append(now - state.arrival_t)

    def on_evict(self, state, now: float) -> None:
        # graceful admission rejection and timeout eviction both land
        # here; the reason string separates them
        self.evicted += 1
        if (state.evict_reason or "").startswith("queue full"):
            self.rejected += 1
        self.evict_reasons[state.evict_reason or "unknown"] += 1

    def on_plan(self, plan, now: float, queue_depth: int = 0,
                occupancy: int = 0) -> None:
        self.queue_depth = queue_depth
        self.slot_occupancy = occupancy / max(self._max_slots, 1)
        self.scheduled_tokens += plan.total_tokens

    def on_token(self, state, now: float) -> None:
        """One EMITTED token (fires once per token, not per step — a
        speculative verify window calls this 1..k+1 times, keeping
        tokens/s and TPOT divided by tokens actually emitted)."""
        self.tokens_out += 1

    def on_spec(self, state, proposed: int, accepted: int,
                emitted: int) -> None:
        """One executed verify window: ``proposed`` draft rows scheduled,
        ``accepted`` drafts matched the verifier's targets, ``emitted``
        = accepted + the bonus token (possibly eos-clamped)."""
        self.spec_steps += 1
        self.draft_tokens_proposed += int(proposed)
        self.draft_tokens_accepted += int(accepted)
        self.spec_tokens_out += int(emitted)

    def on_finish(self, state, now: float) -> None:
        self.finished += 1
        if state.first_token_t is not None:
            self.ttft_s.append(state.first_token_t - state.arrival_t)
            n = len(state.tokens)
            if n > 1 and state.finish_t is not None:
                self.tpot_s.append(
                    (state.finish_t - state.first_token_t) / (n - 1)
                )

    def on_prefix_lookup(self, cached_tokens: int, prompt_len: int,
                         host_tokens: int = 0) -> None:
        """One slot admission's cache consult. ``cached_tokens`` counts
        EVERY skipped prompt token (HBM-resident hit + host-tier
        extension); ``host_tokens`` is the host-tier share of it."""
        self.prefix_lookups += 1
        self.prompt_tokens_seen += int(prompt_len)
        if cached_tokens > 0:
            self.prefix_hits += 1
            self.cached_prompt_tokens += int(cached_tokens)
        if host_tokens > 0:
            self.host_prefix_hits += 1
            self.host_cached_prompt_tokens += int(host_tokens)

    def on_cow(self) -> None:
        self.cow_copies += 1

    def on_spill(self, nbytes: int = 0) -> None:
        """One page demoted HBM → host (at-rest, codec-compressed
        ``nbytes``); fired by PageSpiller.demote AFTER the put succeeded
        — a full-store failure mutates nothing and counts nothing."""
        self.pages_spilled += 1
        self.spill_bytes += int(_finite(nbytes))

    def on_page_in(self, pages: int = 1, nbytes: int = 0,
                   stall_s: float = 0.0) -> None:
        """One step's promotion staging: ``pages`` host pages decoded
        into the rotating staging buffer (``nbytes`` at rest),
        ``stall_s`` the host-side decode+staging time — the slice of
        page-in that is NOT hidden under the device step."""
        self.pages_promoted += int(pages)
        self.promote_bytes += int(_finite(nbytes))
        self.page_in_stall_s += float(_finite(stall_s))

    def on_prefill_chunk(self, cached_tail: bool = False) -> None:
        if cached_tail:
            self.cached_tail_feeds += 1
        else:
            self.prefill_chunks += 1

    def on_moe(self, tokens_per_expert, dropped_fraction,
               a2a_bytes: int = 0) -> None:
        """One MoE serving step's expert load-balance counters:
        ``tokens_per_expert`` is the step's [E] capacity-slot histogram
        (summed over layers), ``dropped_fraction`` the valid
        token-expert assignments that overflowed capacity, ``a2a_bytes``
        the analytic expert-exchange wire bytes. NaN-hardened like the
        TTFT percentiles — a poisoned device value can never reach the
        summary line or the serve/* bridge."""
        self.moe_steps += 1
        hist = [int(_finite(v)) for v in list(tokens_per_expert)]
        if len(self.moe_tokens_per_expert) != len(hist):
            self.moe_tokens_per_expert = [0] * len(hist)
        self.moe_tokens_per_expert = [
            a + b for a, b in zip(self.moe_tokens_per_expert, hist)
        ]
        self.moe_routed_tokens += sum(hist)
        self.moe_dropped_fraction = float(_finite(dropped_fraction))
        self.moe_a2a_bytes += int(_finite(a2a_bytes))

    @property
    def moe_load_imbalance(self) -> float:
        """max/mean of the cumulative tokens-per-expert histogram — 1.0
        is perfect balance, E is total collapse onto one expert; 0.0
        before any MoE step ran."""
        hist = self.moe_tokens_per_expert
        total = sum(hist)
        if not hist or total <= 0:
            return 0.0
        return max(hist) / (total / len(hist))

    def on_pages(self, pool, cache_entries: int = 0,
                 host_resident: int = 0) -> None:
        """Pool gauges from the scheduler's PagePool after a tick."""
        self.pages_free = pool.free_count
        self.pages_in_use = pool.num_pages - pool.free_count
        self.arena_utilization = self.pages_in_use / max(pool.num_pages, 1)
        self.prefix_cache_entries = int(cache_entries)
        self.host_pages_resident = int(host_resident)

    @property
    def prefix_hit_rate(self) -> float:
        """Cached prompt tokens over prompt tokens admitted (the token-
        weighted hit rate; 0.0 before any lookup)."""
        return (
            self.cached_prompt_tokens / self.prompt_tokens_seen
            if self.prompt_tokens_seen else 0.0
        )

    @property
    def host_prefix_hit_rate(self) -> float:
        """HOST-tier share of the token-weighted hit rate: prompt tokens
        covered by host-resident blocks (chains that survived HBM
        eviction) over prompt tokens admitted; 0.0 before any lookup."""
        return (
            self.host_cached_prompt_tokens / self.prompt_tokens_seen
            if self.prompt_tokens_seen else 0.0
        )

    @property
    def acceptance_rate(self) -> float:
        """Accepted draft tokens over proposed draft tokens (0.0 before
        any verify window ran)."""
        return (
            self.draft_tokens_accepted / self.draft_tokens_proposed
            if self.draft_tokens_proposed else 0.0
        )

    @property
    def mean_accepted_tokens_per_step(self) -> float:
        """Tokens emitted per verify window (accepted drafts + bonus);
        1.0 = no acceptance, 0.0 before any window ran."""
        return (
            self.spec_tokens_out / self.spec_steps if self.spec_steps
            else 0.0
        )

    # --------------------------------------------------- engine hooks
    def configure(self, max_slots: int, num_pages: int = 0,
                  host_pages: int = 0) -> None:
        self._max_slots = max(int(max_slots), 1)
        self._num_pages = max(int(num_pages), 0)
        self._host_pages = max(int(host_pages), 0)

    def on_step(self) -> None:
        self.steps += 1

    # ------------------------------------------------------ reporting
    @property
    def elapsed(self) -> float:
        return self.clock() - self._t0

    def tokens_per_s(self, window_s: Optional[float] = None) -> float:
        dur = self.elapsed if window_s is None else window_s
        return self.tokens_out / dur if dur > 0 else 0.0

    def snapshot(self) -> Dict[str, float]:
        snap = {
            "submitted": self.submitted,
            "admitted": self.admitted,
            "rejected": self.rejected,
            "evicted": self.evicted,
            "finished": self.finished,
            "steps": self.steps,
            "tokens_out": self.tokens_out,
            "scheduled_tokens": self.scheduled_tokens,
            "queue_depth": self.queue_depth,
            "slot_occupancy": self.slot_occupancy,
            "tokens_per_s": self.tokens_per_s(),
            "ttft_p50_s": percentile(self.ttft_s, 50),
            "ttft_p95_s": percentile(self.ttft_s, 95),
            "tpot_p50_s": percentile(self.tpot_s, 50),
            "tpot_p95_s": percentile(self.tpot_s, 95),
            "queue_wait_p95_s": percentile(self.queue_wait_s, 95),
            "prefix_hit_rate": self.prefix_hit_rate,
            "prefix_hits": self.prefix_hits,
            "cached_prompt_tokens": self.cached_prompt_tokens,
            "cow_copies": self.cow_copies,
            "prefill_chunks": self.prefill_chunks,
            "pages_in_use": self.pages_in_use,
            "arena_utilization": self.arena_utilization,
            "prefix_cache_entries": self.prefix_cache_entries,
            "spec_steps": self.spec_steps,
            "draft_tokens_proposed": self.draft_tokens_proposed,
            "draft_tokens_accepted": self.draft_tokens_accepted,
            "acceptance_rate": self.acceptance_rate,
            "mean_accepted_tokens_per_step":
                self.mean_accepted_tokens_per_step,
        }
        if (self._host_pages or self.pages_spilled or self.pages_promoted
                or self.host_pages_resident):
            snap.update({
                "pages_spilled": self.pages_spilled,
                "pages_promoted": self.pages_promoted,
                "spill_bytes": self.spill_bytes,
                "promote_bytes": self.promote_bytes,
                "page_in_stall_s": self.page_in_stall_s,
                "host_pages_resident": self.host_pages_resident,
                "host_prefix_hits": self.host_prefix_hits,
                "host_cached_prompt_tokens": self.host_cached_prompt_tokens,
                "host_prefix_hit_rate": self.host_prefix_hit_rate,
            })
        if self.moe_steps:
            snap.update({
                "moe_steps": self.moe_steps,
                "moe_routed_tokens": self.moe_routed_tokens,
                "moe_dropped_fraction": self.moe_dropped_fraction,
                "moe_load_imbalance": self.moe_load_imbalance,
                "moe_a2a_bytes": self.moe_a2a_bytes,
            })
            # the per-expert histogram rides the snapshot (and the
            # serve/* bridge) as bounded scalar keys — E is small
            snap.update({
                f"moe_tokens_expert_{i}": v
                for i, v in enumerate(self.moe_tokens_per_expert)
            })
        # empty-window hardening: every reported value is finite — no
        # NaN ever reaches the summary line or the CSV/monitor bridge
        return {k: _finite(v) for k, v in snap.items()}

    def summary(self) -> str:
        """comm_logger-style table."""
        s = self.snapshot()
        lines = [
            "serving metrics",
            f"{'requests':<18}submitted={self.submitted} "
            f"admitted={self.admitted} finished={self.finished} "
            f"rejected={self.rejected} evicted={self.evicted}",
            f"{'throughput':<18}{s['tokens_per_s']:.1f} tok/s over "
            f"{self.elapsed:.2f}s ({self.steps} steps, "
            f"{self.scheduled_tokens} scheduled tokens)",
            f"{'ttft':<18}p50={s['ttft_p50_s'] * 1e3:.1f}ms "
            f"p95={s['ttft_p95_s'] * 1e3:.1f}ms",
            f"{'tpot':<18}p50={s['tpot_p50_s'] * 1e3:.1f}ms "
            f"p95={s['tpot_p95_s'] * 1e3:.1f}ms",
            f"{'gauges':<18}queue_depth={self.queue_depth} "
            f"slot_occupancy={self.slot_occupancy:.2f}"

        ]
        if self._num_pages:
            lines.append(
                f"{'paged arena':<18}pages_in_use={self.pages_in_use}/"
                f"{self._num_pages} (util {self.arena_utilization:.2f}), "
                f"prefix hit rate {self.prefix_hit_rate:.2f} "
                f"({self.prefix_hits}/{self.prefix_lookups} requests, "
                f"{self.cached_prompt_tokens} tokens), "
                f"cow_copies={self.cow_copies}, "
                f"prefill_chunks={self.prefill_chunks} "
                f"(+{self.cached_tail_feeds} cached-tail feeds)"
            )
        if self._host_pages or self.pages_spilled or self.pages_promoted:
            lines.append(
                f"{'kv tiering':<18}spilled={self.pages_spilled} pages "
                f"({self.spill_bytes / (1 << 20):.2f} MiB at rest), "
                f"promoted={self.pages_promoted} "
                f"({self.promote_bytes / (1 << 20):.2f} MiB), "
                f"host_resident={self.host_pages_resident}/"
                f"{self._host_pages}, host prefix hit rate "
                f"{self.host_prefix_hit_rate:.2f} "
                f"({self.host_cached_prompt_tokens} tokens), "
                f"page_in_stall={self.page_in_stall_s * 1e3:.1f}ms"
            )
        if self.spec_steps:
            lines.append(
                f"{'speculative':<18}acceptance "
                f"{self.acceptance_rate:.2f} "
                f"({self.draft_tokens_accepted}/"
                f"{self.draft_tokens_proposed} drafts), mean accepted "
                f"tokens/step {self.mean_accepted_tokens_per_step:.2f} "
                f"over {self.spec_steps} verify windows"
            )
        if self.moe_steps:
            hist = "/".join(str(v) for v in self.moe_tokens_per_expert)
            lines.append(
                f"{'moe serving':<18}tokens/expert [{hist}] over "
                f"{self.moe_steps} steps, load imbalance "
                f"{self.moe_load_imbalance:.2f}, dropped "
                f"{self.moe_dropped_fraction:.3f}, a2a "
                f"{self.moe_a2a_bytes / (1 << 20):.2f} MiB"
            )
        if self.evict_reasons:
            reasons = ", ".join(
                f"{k}: {v}" for k, v in sorted(self.evict_reasons.items())
            )
            lines.append(f"{'evictions':<18}{reasons}")
        return "\n".join(lines)
