"""fp16 serving: ``init_inference(dtype=torch.float16)`` and ``ServingEngine``
in fp16 in the port (kernel injection on: on the CPU the kernels' plain
versions, the functions the card's fp16 forms compute) against the JAX
package's fp16 engines on the same fp32 masters (``params_from_numpy``), on
llama-tiny (hidden 256, so every projection packs), gpt2-tiny and
bloom-tiny (``tests/torch_bridge.py``, seeded noise on the biases and
scales) and mixtral-tiny.

- ``generate``: greedy tokens equal JAX's fp16 ``init_inference`` →
  ``generate``, or a row's first mismatch falls at a near tie (the port's
  top-2 logits there within LOGITS_ATOL); the no-cache forward's logits
  within LOGITS_ATOL = 4e-3: two fp16 ulps at the largest logit (|2.9|),
  the port's head rounding the logits to fp16 (ROADMAP C); measured
  5.3e-4 (Llama) to 9.5e-4 (BLOOM).
- ``quantize_bits`` 8 with the int8 KV cache, and 4, in fp16, likewise.
- Speculative decode in fp16 (the "ngram" draft over int8 weights, and the
  main fp16 weights as their own draft): tokens bitwise plain greedy's.
- ``ServingEngine`` in fp16 against JAX's ``ServingEngine`` over its fp16
  engine on one staggered trace ("auto" knobs pinned: ``moe_a2a``
  "stock", ``kv_cache_dtype`` explicit), contiguous and paged.
- Paged equals contiguous bitwise for fp16, int8 and bf16-storage KV.
- The engine's leaf dtypes in fp16.

About 20 s in one process on 8 CPU cores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import mixtral as jmixtral
from deepspeed_tpu.serving import Request as JRequest
from deepspeed_tpu.serving import ServingEngine as JServingEngine
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.models import TransformerModel
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.ops.quantizer import PackedWeight
from deepspeed_tpu_torch.serving import Request, RequestStatus
from deepspeed_tpu_torch.serving.engine import ServingEngine
from deepspeed_tpu_torch.utils.tree import tree_leaves

from torch_bridge import family_pair, port_config, tiny_pair

F16 = torch.float16
V, P, NEW = 256, 20, 12
LOGITS_ATOL = 4e-3
PACKED = dict(hidden_size=256, intermediate_size=512)


def _mixtral_pair():
    jm = jmixtral("mixtral-tiny", vocab_size=V, max_seq_len=512)
    jp = jm.init(jax.random.PRNGKey(0))
    pm = TransformerModel(port_config(jm.config))
    return jm, jp, pm, params_from_numpy(pm.config, jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def pairs():
    return {"llama": tiny_pair(seed=0, **PACKED), "gpt2": family_pair("gpt2"),
            "bloom": family_pair("bloom"), "mixtral": _mixtral_pair()}


def _engines(pair, **kw):
    """(JAX fp16 engine, the port's fp16 engine with kernel injection) on
    the pair's weights."""
    jm, jp, pm, pp = pair
    jeng = deepspeed_tpu.init_inference(jm, dtype=jnp.float16, params=jp, max_tokens=256, **kw)
    peng = deepspeed_tpu_torch.init_inference(pm, dtype=F16, params=pp, max_tokens=256,
                                              device="cpu", replace_with_kernel_inject=True,
                                              **kw)
    return jeng, peng


def _prompt(B=2, seed=0, n=P):
    return np.random.RandomState(seed).randint(0, V, size=(B, n))


def _same_or_near_tie(peng, want: np.ndarray, got: np.ndarray):
    """Greedy tokens equal, or each row's first mismatch at a near tie of
    the port's logits (its top-2 within LOGITS_ATOL)."""
    for b in range(want.shape[0]):
        diff = np.nonzero(want[b] != got[b])[0]
        if diff.size:
            j = int(diff[0])
            top2 = peng.forward(want[b:b + 1, :j])[0, -1].topk(2).values
            assert float(top2[0] - top2[1]) < LOGITS_ATOL, (b, j, top2.tolist())


def _check_against_jax(jeng, peng, seed=0):
    ids = _prompt(seed=seed)
    want = np.asarray(jeng.generate(ids, max_new_tokens=NEW))
    got = peng.generate(ids, max_new_tokens=NEW).numpy()
    _same_or_near_tie(peng, want, got)
    logits = peng.forward(want[:, :-1])
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())
    np.testing.assert_allclose(logits.numpy(), np.asarray(jeng.forward(want[:, :-1])),
                               atol=LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("model", ["llama", "gpt2", "bloom", "mixtral"])
def test_fp16_generate_matches_jax(pairs, model):
    _check_against_jax(*_engines(pairs[model]))


@pytest.mark.parametrize("model,bits,kv", [("llama", 8, "int8"), ("llama", 4, "auto"),
                                           ("mixtral", 8, "int8"), ("mixtral", 4, "auto")])
def test_fp16_quantized_matches_jax(pairs, model, bits, kv):
    jeng, peng = _engines(pairs[model], quantize_bits=bits, kv_cache_dtype=kv)
    wq = peng.params["layers"]["attn"]["wq"]
    assert isinstance(wq, PackedWeight) and wq.dtype == F16 and wq.bits == bits
    _check_against_jax(jeng, peng, seed=bits)


@pytest.mark.parametrize("draft", ["ngram", "self"])
def test_fp16_speculative_equals_plain_greedy(pairs, draft):
    """The "ngram" draft over int8 weights and the int8 KV cache on a
    repetitive prompt; the main fp16 weights drafting for themselves (every
    proposal accepted): the tokens are plain greedy's, bitwise."""
    _, _, pm, pp = pairs["llama"]
    kw = dict(dtype=F16, params=pp, max_tokens=256, device="cpu",
              replace_with_kernel_inject=True)
    if draft == "ngram":
        kw.update(quantize_bits=8, kv_cache_dtype="int8")
        ids = np.array([[11, 7, 3, 9, 5] * 6])
    else:
        ids = _prompt(B=1, seed=5)
    plain = deepspeed_tpu_torch.init_inference(pm, **kw)
    spec = deepspeed_tpu_torch.init_inference(
        pm, draft_model="ngram" if draft == "ngram" else pm,
        draft_params=None if draft == "ngram" else plain.params, **kw)
    want = plain.generate(ids, max_new_tokens=16)
    got = spec.generate(ids, max_new_tokens=16, num_draft_tokens=3)
    assert torch.equal(got, want)
    if draft == "self":
        assert spec.last_spec_rounds == 4  # ceil(15 / 4): every proposal accepted


PROMPTS, NEWS = (3, 12, 7, 21, 9), (6, 4, 8, 5, 3)


def _serving(paged, **over):
    return {"max_slots": 3, "token_budget": 8, "max_tokens": 64, "paged": paged,
            "page_size": 16, **over}


def _drive(srv, make, prompts, **req_kw):
    """Two requests, two steps, then the rest (one staggered schedule)."""
    states = []

    def sub(i):
        kw = {k: (v[i] if isinstance(v, list) else v) for k, v in req_kw.items()}
        states.append(srv.submit(make(request_id=f"r{i}", prompt=prompts[i],
                                      max_new_tokens=NEWS[i], **kw)))

    sub(0)
    sub(1)
    for _ in range(2):
        srv.step()
    for i in range(2, len(prompts)):
        sub(i)
    while srv.scheduler.has_work:
        srv.step()
        if srv.paged:
            srv.scheduler.assert_page_invariants()
    return states


def _prompts(seed=0):
    r = np.random.RandomState(seed)
    return [r.randint(0, V, size=(n,)) for n in PROMPTS]


@pytest.fixture(scope="module")
def llama_engines(pairs):
    jm, jp, pm, pp = pairs["llama"]
    jeng = deepspeed_tpu.init_inference(jm, dtype=jnp.float16, params=jp, max_tokens=64)
    peng = deepspeed_tpu_torch.init_inference(pm, dtype=F16, params=pp, max_tokens=64,
                                              device="cpu", replace_with_kernel_inject=True)
    return jeng, peng


@pytest.mark.parametrize("paged", [False, True])
def test_fp16_serving_matches_jax(llama_engines, paged):
    jeng, peng = llama_engines
    prompts = _prompts(0)
    jsrv = JServingEngine(engine=jeng, serving=_serving(
        paged, kv_cache_dtype="bf16", moe_a2a="stock", spec={"enabled": False}))
    want = [s.output() for s in _drive(jsrv, JRequest, prompts)]
    srv = deepspeed_tpu_torch.init_serving(serving=_serving(paged), engine=peng)
    states = _drive(srv, Request, prompts)
    assert all(s.status is RequestStatus.DONE for s in states)
    assert srv.step_traces == 1 and srv.dtype == F16
    assert srv._caches["k"].dtype == F16
    for w, g in zip(want, (s.output() for s in states)):
        _same_or_near_tie(peng, w[None, :], g[None, :])


@pytest.mark.parametrize("kv", ["auto", "int8", "bf16"])
def test_fp16_paged_equals_contiguous_bitwise(pairs, kv):
    """Greedy, sampled, a repetition penalty and an eos in one batch, fp16
    compute over fp16, int8 and bf16 (the mixed form's storage) KV."""
    _, _, pm, pp = pairs["llama"]
    eng = deepspeed_tpu_torch.init_inference(pm, dtype=F16, params=pp, max_tokens=64,
                                             kv_cache_dtype=kv, device="cpu",
                                             replace_with_kernel_inject=True)
    store = {"auto": F16, "int8": torch.int8, "bf16": torch.bfloat16}[kv]
    cases = dict(temperature=[0.0, 0.8, 0.7, 0.0, 1.0], top_k=[0, 10, 0, 0, 5],
                 top_p=[1.0, 1.0, 0.85, 1.0, 0.9],
                 repetition_penalty=[1.0, 1.0, 1.0, 1.3, 1.0],
                 eos_token_id=[-1, -1, -1, -1, 7])
    outs = {}
    for paged in (False, True):
        srv = ServingEngine(engine=eng, serving=_serving(paged))
        assert srv._caches["k"].dtype == store
        states = _drive(srv, Request, _prompts(1), **cases)
        assert all(s.status is RequestStatus.DONE for s in states)
        assert srv.step_traces == 1
        outs[paged] = [s.output() for s in states]
    for i, (a, b) in enumerate(zip(outs[False], outs[True])):
        np.testing.assert_array_equal(a, b, err_msg=f"r{i}")


def test_fp16_engine_leaf_dtypes(pairs):
    """fp16 compute: every floating leaf fp16, packed leaves' dtype fp16 (int8
    bytes, fp32 scales), the cache in its storage; ``dtype="int8"`` still
    means bf16 compute, as in JAX; a dtype the card's kernels do not take is
    refused there before any tensor is made."""
    _, _, pm, pp = pairs["llama"]
    dense = deepspeed_tpu_torch.init_inference(pm, dtype=F16, params=pp, device="cpu")
    assert all(t.dtype == F16 for t in tree_leaves(dense.params) if t.is_floating_point())
    packed = deepspeed_tpu_torch.init_inference(pm, dtype=F16, params=pp, quantize_bits=8,
                                                kv_cache_dtype="bf16", device="cpu")
    leaves = list(tree_leaves(packed.params))
    assert any(isinstance(w, PackedWeight) for w in leaves)
    for w in leaves:
        if isinstance(w, PackedWeight):
            assert (w.dtype, w.qdata.dtype, w.scale.dtype) == (F16, torch.int8, torch.float32)
        elif w.is_floating_point():
            assert w.dtype == F16
    assert packed.kv_cache_storage_dtype == torch.bfloat16 and packed.dtype == F16
    int8 = deepspeed_tpu_torch.init_inference(pm, dtype="int8", params=pp, device="cpu")
    assert int8.dtype == torch.bfloat16
    assert int8.params["layers"]["attn"]["wq"].dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="bfloat16 or float16"):
        InferenceEngine(pm, device=torch.device("cuda"), dtype=torch.float32)
