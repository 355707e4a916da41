"""Continuous-batching serving: ``init_serving`` → ``ServingEngine`` in the
port against the JAX package's ``ServingEngine`` on the same staggered trace
from converted weights (fp32 greedy tokens equal per request, both arenas,
and equal to the port's lockstep ``generate``), and the port's own oracles:
paged == contiguous bitwise (greedy and sampled, bf16 storage and int8 KV),
prefix reuse with no prefill chunk, copy-on-write on a mid-page divergence,
the page-pool invariants after every step, forced eviction under pool
exhaustion, one step shape, a sampled request's tokens alone and in a mixed
batch, the verify window against JAX's, and the config's checks and
refusals."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.serving import Request as JRequest
from deepspeed_tpu.serving import ServingEngine as JServingEngine
from deepspeed_tpu.serving import spec as jspec
from deepspeed_tpu.serving.engine import _make_sample_one
from deepspeed_tpu_torch.config import DeepSpeedConfigError, ServingConfig
from deepspeed_tpu_torch.serving import Request, RequestStatus
from deepspeed_tpu_torch.serving import spec as pspec
from deepspeed_tpu_torch.serving.engine import ServingEngine

from torch_bridge import tiny_pair

V = 256  # tiny_pair's vocab
PROMPTS = (3, 12, 7, 21, 9)
NEWS = (6, 4, 8, 5, 3)


@pytest.fixture(scope="module")
def engines():
    jm, jp, pm, pp = tiny_pair(seed=0)
    jeng = deepspeed_tpu.init_inference(jm, dtype=jnp.float32, params=jp, max_tokens=64)
    peng = deepspeed_tpu_torch.init_inference(pm, dtype=torch.float32, params=pp,
                                              max_tokens=64, device="cpu")
    return jm, jeng, pm, pp, peng


def _serving(paged, **over):
    s = {"max_slots": 3, "token_budget": 8, "max_tokens": 64, "paged": paged,
         "page_size": 16}
    s.update(over)
    return s


def _prompts(seed=0):
    r = np.random.RandomState(seed)
    return [r.randint(0, V, size=(n,)) for n in PROMPTS]


def _drive(srv, make, prompts, news, check=None, **req_kw):
    """Two requests, two steps, then the rest: one staggered schedule for
    every engine; ``check`` runs after each step."""
    states = []

    def sub(i):
        kw = {k: (v[i] if isinstance(v, list) else v) for k, v in req_kw.items()}
        states.append(srv.submit(make(request_id=f"r{i}", prompt=prompts[i],
                                      max_new_tokens=news[i], **kw)))

    sub(0)
    sub(1)
    for _ in range(2):
        srv.step()
        if check:
            check(srv)
    for i in range(2, len(prompts)):
        sub(i)
    while srv.scheduler.has_work:
        srv.step()
        if check:
            check(srv)
    return states


def _invariants(srv):
    if srv.paged:
        srv.scheduler.assert_page_invariants()


@pytest.mark.parametrize("paged", [False, True])
def test_greedy_tokens_equal_jax_and_generate(engines, paged):
    _, jeng, _, _, peng = engines
    prompts = _prompts(0)
    # "auto" knobs pinned: with engine= the JAX engine does not read the
    # kv dtype, and nothing is left for resolve_auto_knobs to resolve
    jsrv = JServingEngine(engine=jeng, serving=_serving(
        paged, kv_cache_dtype="bf16", moe_a2a="stock", spec={"enabled": False}))
    want = _drive(jsrv, JRequest, prompts, NEWS)
    srv = deepspeed_tpu_torch.init_serving(serving=_serving(paged), engine=peng)
    got = _drive(srv, Request, prompts, NEWS, check=_invariants)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g.status is RequestStatus.DONE
        np.testing.assert_array_equal(g.output(), w.output(), err_msg=f"r{i}")
        lockstep = peng.generate(prompts[i][None, :], max_new_tokens=NEWS[i])
        np.testing.assert_array_equal(g.output(), lockstep[0].numpy(), err_msg=f"r{i}")
    assert srv.step_traces == 1


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_paged_equals_contiguous_bitwise(engines, kv):
    """Greedy, sampled (temperature, top-k, top-p), a repetition penalty and
    an eos in one batch; per-request generators given or from the id."""
    _, _, pm, pp, _ = engines
    eng = deepspeed_tpu_torch.init_inference(pm, dtype=torch.float32, params=pp,
                                             max_tokens=64, kv_cache_dtype=kv,
                                             device="cpu")
    prompts = _prompts(1)
    cases = dict(temperature=[0.0, 0.8, 0.7, 0.0, 1.0], top_k=[0, 10, 0, 0, 5],
                 top_p=[1.0, 1.0, 0.85, 1.0, 0.9],
                 repetition_penalty=[1.0, 1.0, 1.0, 1.3, 1.0],
                 eos_token_id=[-1, -1, -1, -1, 7],
                 rng=[None, torch.Generator().manual_seed(3), None, None, None])
    outs = {}
    for paged in (False, True):
        srv = ServingEngine(engine=eng, serving=_serving(paged))
        states = _drive(srv, Request, prompts, NEWS, check=_invariants, **cases)
        assert all(s.status is RequestStatus.DONE for s in states)
        assert srv.step_traces == 1
        outs[paged] = [s.output() for s in states]
    for i, (a, b) in enumerate(zip(outs[False], outs[True])):
        np.testing.assert_array_equal(a, b, err_msg=f"r{i}")


def test_prefix_reuse_and_copy_on_write(engines):
    """A repeated prompt feeds only its last token (no prefill chunk); a
    prompt diverging inside a shared page copies it; a third copy of the
    first prompt afterwards proves the shared pages were not written."""
    _, _, _, _, peng = engines
    srv = ServingEngine(engine=peng, serving=_serving(True, max_slots=2))
    prompt = np.random.RandomState(5).randint(0, V, size=(20,))
    want = peng.generate(prompt[None, :], max_new_tokens=6)[0].numpy()
    a = srv.submit(Request("a", prompt, max_new_tokens=6))
    srv.run_until_idle()
    np.testing.assert_array_equal(a.output(), want)
    chunks = srv.metrics.prefill_chunks
    b = srv.submit(Request("b", prompt, max_new_tokens=6))
    srv.run_until_idle()
    assert b.cached_tokens == prompt.size - 1
    assert srv.metrics.prefill_chunks == chunks  # the lone last-token feed only
    assert srv.metrics.cached_tail_feeds >= 1
    np.testing.assert_array_equal(b.output(), want)
    div = np.concatenate([prompt[:10], (prompt[10:] + 1) % V])
    cows = srv.metrics.cow_copies
    c = srv.submit(Request("c", div, max_new_tokens=5))
    srv.run_until_idle()
    assert c.cached_tokens == 10 and srv.metrics.cow_copies > cows
    np.testing.assert_array_equal(
        c.output(), peng.generate(div[None, :], max_new_tokens=5)[0].numpy())
    d = srv.submit(Request("d", prompt, max_new_tokens=6))
    srv.run_until_idle()
    np.testing.assert_array_equal(d.output(), want)
    srv.scheduler.assert_page_invariants()


def test_forced_eviction_under_pool_exhaustion(engines):
    _, _, _, _, peng = engines
    srv = ServingEngine(engine=peng, serving=_serving(True, num_pages=5))
    assert srv.num_pages == srv.pages_per_slot == 5  # the liveness floor
    r = np.random.RandomState(6)
    states = [srv.submit(Request(f"e{i}", r.randint(0, V, size=(30,)), max_new_tokens=20))
              for i in range(3)]
    while srv.scheduler.has_work:
        srv.step()
        srv.scheduler.assert_page_invariants()
    evicted = [s for s in states if s.status is RequestStatus.EVICTED]
    done = [s for s in states if s.status is RequestStatus.DONE]
    assert evicted and done
    assert all(s.evict_reason == "page pool exhausted" for s in evicted)
    for s in done:
        np.testing.assert_array_equal(
            s.output(), peng.generate(s.request.prompt[None, :], max_new_tokens=20)[0].numpy())
    with pytest.raises(DeepSpeedConfigError, match="liveness floor"):
        ServingEngine(engine=peng, serving=_serving(True, num_pages=4))


def test_queue_timeout_and_queue_limit_with_an_injected_clock(engines):
    """Admission through the engine on an injected clock: a full queue
    rejects gracefully, a request queued past request_timeout_s is evicted
    with a backoff hint, and the one in the slot still finishes."""
    _, _, _, _, peng = engines
    now = [0.0]
    srv = ServingEngine(engine=peng, clock=lambda: now[0], serving=_serving(
        False, max_slots=1, queue_limit=1, request_timeout_s=1.0))
    prompts = _prompts(3)
    a = srv.submit(Request("a", prompts[0], max_new_tokens=3))
    b = srv.submit(Request("b", prompts[1], max_new_tokens=3))
    c = srv.submit(Request("c", prompts[2], max_new_tokens=3))
    assert c.status is RequestStatus.EVICTED and c.evict_reason == "queue full"
    now[0] = 2.0
    srv.run_until_idle()
    assert b.status is RequestStatus.EVICTED and b.evict_reason == "queue timeout"
    assert b.retry_after > now[0]
    assert a.status is RequestStatus.DONE
    assert srv.metrics.rejected == 1 and srv.metrics.evicted == 2


def test_sampled_request_alone_equals_in_a_mixed_batch(engines):
    _, _, _, _, peng = engines
    prompts = _prompts(2)
    kw = dict(temperature=0.9, top_k=20, top_p=0.95)
    alone = ServingEngine(engine=peng, serving=_serving(True))
    x = alone.submit(Request("x", prompts[3], max_new_tokens=7, **kw))
    alone.run_until_idle()
    mixed = ServingEngine(engine=peng, serving=_serving(True))
    others = [mixed.submit(Request(f"o{i}", prompts[i], max_new_tokens=5,
                                   temperature=0.5 * (i % 2))) for i in range(3)]
    y = mixed.submit(Request("x", prompts[3], max_new_tokens=7, **kw))
    mixed.run_until_idle()
    assert all(o.status is RequestStatus.DONE for o in others)
    assert y.tokens == x.tokens


def test_verify_window_matches_jax():
    """The sampling tail on the same logits: greedy rows (with a penalty)
    give JAX's tokens, and the draft acceptance and eos clamp its n_emit."""
    r = np.random.RandomState(8)
    N, W, Vv, md = 4, 6, 17, 2
    logits = r.randn(N, W, Vv).astype(np.float32)
    tokens = r.randint(0, Vv, (N, W)).astype(np.int32)
    num_new = np.array([4, 1, 6, 0], np.int32)
    spec_len = np.array([2, 0, 1, 0], np.int32)
    live = np.array([True, True, True, False])
    seen = r.rand(N, Vv) < 0.3
    penalty = np.array([1.0, 1.5, 1.0, 1.0], np.float32)
    eos = np.array([-1, -1, 3, -1], np.int32)
    # make row 0's drafts the greedy targets so they are accepted
    for j in range(md + 1):
        logits[0, 1 + j, (j + 5) % Vv] = 50.0
    tokens[0, 2:4] = [5, 6]
    zeros = np.zeros(N, np.float32)
    jt, jn = jspec.verify_window(
        _make_sample_one(Vv), jnp.asarray(logits), jnp.asarray(tokens), jnp.asarray(seen),
        jnp.asarray(num_new), jnp.asarray(spec_len), jnp.asarray(live),
        jnp.zeros((N, 2), jnp.uint32), jnp.asarray(zeros), jnp.zeros(N, jnp.int32),
        jnp.ones(N), jnp.asarray(penalty), jnp.asarray(eos), md)[:2]
    t = torch.from_numpy
    idx = deepspeed_tpu_torch.models.decoding.verify_window_rows(
        t(num_new), t(spec_len), md, W)
    win = t(logits).gather(1, idx[:, :, None].expand(-1, -1, Vv))
    pt, pn = pspec.verify_window(win, t(tokens), t(seen), t(num_new), t(spec_len), live,
                                 [None] * N, zeros, np.zeros(N, np.int32), np.ones(N),
                                 penalty, t(eos), md)
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(pt.numpy()[live], np.asarray(jt)[live])
    assert pn.tolist()[0] == 3


def test_serving_config_checks_and_refusals(engines):
    _, _, pm, _, peng = engines
    cfg = ServingConfig(paged="auto", spec="auto").resolve_auto()
    assert cfg.paged is False and cfg.spec.enabled is False
    assert ServingConfig(max_tokens=1000, token_budget=64, page_size=16).pages_per_slot() == 67
    for bad in ({"max_slots": 0}, {"token_budget": 0}, {"kv_cache_dtype": "fp8"},
                {"page_size": 0}, {"num_pages": -1}, {"moe_a2a": "x"},
                {"paged": "yes"}, {"host_pages": 2, "paged": False},
                {"spec": {"enabled": True, "max_draft": 8}, "token_budget": 8}):
        with pytest.raises(DeepSpeedConfigError):
            ServingEngine(engine=peng, serving=bad)
    for kw, item in ((dict(serving={"spec": {"enabled": True}}), "A4"),
                     (dict(serving={"paged": True, "host_pages": 4}), "A4"),
                     (dict(serving={"fleet": {"enabled": True}}), "A9"),
                     (dict(steptrace={"enabled": True}), "A10"),
                     (dict(healthwatch={"enabled": True}), "A10")):
        with pytest.raises(NotImplementedError, match=item):
            deepspeed_tpu_torch.init_serving(engine=peng, **kw)
    with pytest.raises(ValueError, match="model or an engine"):
        ServingEngine(serving={})
    # model= builds its engine through init_inference, with the serving
    # section's kv dtype and max_tokens
    srv = deepspeed_tpu_torch.init_serving(pm, serving={"kv_cache_dtype": "int8",
                                                        "max_tokens": 48},
                                           device="cpu", dtype=torch.float32)
    assert srv.engine.kv_cache_quantized and srv.max_tokens == 48
    assert srv.capacity == 128  # max_tokens + token_budget, 128-aligned
