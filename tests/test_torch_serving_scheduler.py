"""The serving host plane against the JAX package's: chained page hashes,
the refcounted page pool, the prefix cache, and the SplitFuse scheduler,
which must emit the same StepPlan arrays step by step on a seeded trace with
an injected clock (contiguous and paged, with prefix sharing, forced eviction
under a small pool, and speculative drafts), and leave the same metrics."""

import numpy as np
import pytest

from deepspeed_tpu.serving import metrics as jmetrics
from deepspeed_tpu.serving import paging as jpaging
from deepspeed_tpu.serving import request as jrequest
from deepspeed_tpu.serving import scheduler as jsched
from deepspeed_tpu_torch.serving import metrics as pmetrics
from deepspeed_tpu_torch.serving import paging as ppaging
from deepspeed_tpu_torch.serving import request as prequest
from deepspeed_tpu_torch.serving import scheduler as psched


def test_chain_hashes_match_jax():
    r = np.random.RandomState(0)
    for n in (0, 7, 16, 50):
        toks = r.randint(0, 1000, n)
        assert ppaging.chain_hashes(toks, 8) == jpaging.chain_hashes(toks, 8)
        assert ppaging.chain_hash(3, toks) == jpaging.chain_hash(3, toks)
    hs = ppaging.chain_hashes(r.randint(0, 9, 40), 4)
    have = set(hs[:3])
    assert ppaging.longest_chain_walk(hs, have.__contains__) == \
        jpaging.longest_chain_walk(hs, have.__contains__) == 3


def test_page_pool_and_prefix_cache_match_jax():
    r = np.random.RandomState(1)
    pools = (ppaging.PagePool(40), jpaging.PagePool(40))
    caches = tuple(mod.PrefixCache(pool, 4) for mod, pool in
                   zip((ppaging, jpaging), pools))
    base = r.randint(0, 50, 11)
    for i in range(4):
        toks = np.concatenate([base, r.randint(0, 50, 3 + i)])
        got = []
        for pool, cache in zip(pools, caches):
            pages = [pool.alloc() for _ in range(-(-toks.size // 4))]
            cache.insert(toks, pages)
            for p in pages:
                pool.decref(p)
            got.append((cache.match(toks[:9]), cache.match(np.concatenate([base, [99]])),
                        len(cache), sorted(cache.held_pages), pool.free_count,
                        pool.live_count))
        assert got[0] == got[1]
    for pool, cache in zip(pools, caches):
        while cache.evict_lru():
            pass
        pool.check_leaks({})
    assert pools[0].free_count == pools[1].free_count == 40
    with pytest.raises(AssertionError):
        pools[0].decref(0)


def _trace(seed, V=40):
    """(arrival tick, request kwargs): prompts sharing prefixes, greedy and
    sampled, some with eos."""
    r = np.random.RandomState(seed)
    shared = r.randint(0, V, 13)
    out = []
    for i in range(9):
        tail = r.randint(0, V, r.randint(1, 20))
        prompt = np.concatenate([shared, tail]) if i % 3 == 0 else tail
        if i == 7:
            prompt = out[0][1]["prompt"]  # a repeat
        out.append((i // 2, dict(request_id=f"r{i}", prompt=prompt,
                                 max_new_tokens=int(r.randint(2, 9)),
                                 eos_token_id=(5 if i % 4 == 1 else -1),
                                 temperature=0.7 if i % 2 else 0.0)))
    return out


PLAN_FIELDS = ("tokens", "num_new", "start_pos", "fresh", "sample", "page_table",
               "cow_src", "spec_len")


@pytest.mark.parametrize("kind", ["contiguous", "paged", "paged_small_pool", "spec"])
def test_scheduler_plans_match_jax(kind):
    """Both schedulers, the same clock, the same emitted tokens fed back:
    every StepPlan array equal, every step, and the same metrics."""
    kw = dict(max_slots=3, token_budget=8, max_tokens=40, queue_limit=4,
              request_timeout_s=5.0)
    if kind != "contiguous":
        pps = -(-(40 + 8) // 4)
        kw.update(page_size=4, pages_per_slot=pps, prefix_cache=True,
                  num_pages=pps + 2 if kind == "paged_small_pool" else 3 * pps)
    if kind == "spec":
        kw["spec_max_draft"] = 2
    now = [0.0]
    clock = lambda: now[0]  # noqa: E731
    mets = (pmetrics.ServingMetrics(clock=clock), jmetrics.ServingMetrics(clock=clock))
    scheds = (psched.Scheduler(clock=clock, metrics=mets[0], **kw),
              jsched.Scheduler(clock=clock, metrics=mets[1], **kw))
    reqs = (prequest.Request, jrequest.Request)
    trace = _trace(seed=len(kind))
    rng = np.random.RandomState(2)
    states = ([], [])
    for tick in range(200):
        now[0] = tick * 0.25
        for t, req_kw in trace:
            if t == tick:
                for side in (0, 1):
                    states[side].append(scheds[side].submit(reqs[side](**req_kw)))
        plans = [s.plan() for s in scheds]
        if plans[0] is None:
            assert plans[1] is None
            if not any(s.has_work for s in scheds) and tick > trace[-1][0]:
                break
            continue
        for f in PLAN_FIELDS:
            a, b = getattr(plans[0], f), getattr(plans[1], f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=f"tick {tick} {f}")
        assert [(w.slot, w.n_tokens, w.sample, w.spec_len) for w in plans[0].work] == \
            [(w.slot, w.n_tokens, w.sample, w.spec_len) for w in plans[1].work]
        kw_ = 3 if kind == "spec" else 1
        nxt = rng.randint(0, 40, (3, kw_)).astype(np.int32)
        n_emit = np.array([rng.randint(1, int(s) + 2) for s in plans[0].spec_len], np.int32)
        fin = [s.complete(p, nxt, None, n_emit=n_emit) for s, p in zip(scheds, plans)]
        assert [st.request.request_id for st in fin[0]] == \
            [st.request.request_id for st in fin[1]]
        if kind != "contiguous":
            scheds[0].assert_page_invariants()
    else:
        pytest.fail("trace did not drain")
    for a, b in zip(*states):
        assert (a.status.value, a.tokens, a.cached_tokens, a.evict_reason) == \
            (b.status.value, b.tokens, b.cached_tokens, b.evict_reason)
    snap_p, snap_j = mets[0].snapshot(), mets[1].snapshot()
    assert snap_p == {k: snap_j[k] for k in snap_p}
    if kind == "paged":
        assert snap_p["prefix_hits"] >= 1 and snap_p["cow_copies"] >= 1
    if kind == "paged_small_pool":
        assert any(st.evict_reason == "page pool exhausted" for st in states[0])


def test_request_lifecycle_and_rng():
    r = prequest.Request("a", [1, 2, 3], max_new_tokens=4)
    st = prequest.RequestState(r)
    assert st.rng is None and st.prompt_remaining == 3
    with pytest.raises(ValueError, match="illegal transition"):
        st.transition(prequest.RequestStatus.DONE)
    st.transition(prequest.RequestStatus.PREFILL)
    st.tokens = [7, 8]
    np.testing.assert_array_equal(st.output(), [1, 2, 3, 7, 8, 0, 0])
    assert prequest._TRANSITIONS.keys() == jrequest._TRANSITIONS.keys()
    assert all({s.value for s in prequest._TRANSITIONS[k]}
               == {s.value for s in jrequest._TRANSITIONS[jrequest.RequestStatus(k.value)]}
               for k in prequest._TRANSITIONS)
    # the generator: seeded from the id's CRC32, fresh on every call, and a
    # caller's generator is copied, never advanced
    import torch
    a, b = r.rng_key(), prequest.request_rng("a")
    assert torch.equal(torch.rand(3, generator=a), torch.rand(3, generator=b))
    assert not torch.equal(torch.rand(3, generator=prequest.request_rng("b")),
                           torch.rand(3, generator=prequest.request_rng("a")))
    g = torch.Generator().manual_seed(5)
    rq = prequest.Request("c", [1], rng=g)
    first = torch.rand(2, generator=rq.rng_key())
    assert torch.equal(first, torch.rand(2, generator=rq.rng_key()))
    assert torch.equal(first, torch.rand(2, generator=g))
    with pytest.raises(ValueError):
        prequest.Request("d", [], max_new_tokens=1)
