"""Mixtral through the port against the JAX package on ``mixtral-tiny``
(vocab 256: E = 4 experts, top-2, so ``eval_capacity`` drops no token and a
token's routing does not depend on its batch), the same weights in both
(the JAX init, bridged by ``params_from_numpy``):

- ``num_params`` equal to JAX for every preset;
- ``params_from_numpy`` carries MoE trees and the JAX engine's packed
  [L, E, d, n] expert banks byte for byte;
- fp32 logits of ``apply`` and of the cached forward within rtol 1e-4 /
  atol 1e-5 (fp32 sums in another order), the aux loss within rtol 1e-5;
- greedy ``generate`` tokens equal JAX's ``init_inference`` with bf16 weights
  and with int8 and int4 expert banks (fp32 compute), and with the int8 KV
  cache; speculative decode equal to plain greedy in the port;
- ``init_serving``: paged == contiguous bitwise, tokens equal to lockstep
  ``generate`` and to the JAX ``ServingEngine``'s, the MoE metrics equal to
  the stats the port's ``moe_serving_mlp`` returned in the run and to JAX's;
- the layer-by-layer init-and-pack gives the bytes of packing the same
  draws as a whole tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import decoding as jdec
from deepspeed_tpu.models import mixtral as jmixtral
from deepspeed_tpu.serving import Request as JRequest
from deepspeed_tpu.serving import ServingEngine as JServingEngine
from deepspeed_tpu_torch.inference.engine import init_layerwise, quantize_weights
from deepspeed_tpu_torch.models import TransformerModel, llama, mixtral
from deepspeed_tpu_torch.models import decoding as pdec
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.models.transformer import apply, param_specs
from deepspeed_tpu_torch.ops.quantizer import PackedWeight
from deepspeed_tpu_torch.serving import Request, RequestStatus
from deepspeed_tpu_torch.serving.engine import ServingEngine

from torch_bridge import port_config

V, P, NEW = 256, 20, 12
CASES = {
    "bf16": dict(dtype="bf16"),
    "int8": dict(quantize_bits=8),
    "int4": dict(quantize_bits=4),
    "int8-kv8": dict(quantize_bits=8, kv_cache_dtype="int8"),
}


@pytest.fixture(scope="module")
def pair():
    jm = jmixtral("mixtral-tiny", vocab_size=V, max_seq_len=512)
    jp = jm.init(jax.random.PRNGKey(0))
    pm = TransformerModel(port_config(jm.config))
    return jm, jp, pm, params_from_numpy(pm.config, jax.tree.map(np.asarray, jp))


def _prompt(B=2, seed=0, n=P):
    return np.random.RandomState(seed).randint(0, V, size=(B, n))


@pytest.mark.parametrize("size,over", [
    ("mixtral-tiny", {}), ("mixtral-8x7b", {}), ("mixtral-8x22b", {}),
    ("mixtral-tiny", dict(moe_use_residual=True)),
    ("mixtral-tiny", dict(activation="gelu", use_bias=True))])
def test_num_params_matches_jax(size, over):
    jcfg = jmixtral(size, **over).config
    pcfg = mixtral(size, **over).config
    assert pcfg == port_config(jcfg)
    assert pcfg.num_params() == jcfg.num_params()
    if size == "mixtral-8x7b" and not over:
        assert pcfg.num_params() == 46_702_792_704


def test_params_from_numpy_carries_moe_and_packed_trees(pair):
    jm, jp, pm, pp = pair
    specs = param_specs(pm.config)["layers"]["mlp"]
    assert set(specs) == {"router", "wi", "wg", "wo"}
    assert pp["layers"]["mlp"]["wi"].shape == (2, 4, 128, 256)
    assert pp["layers"]["mlp"]["router"].shape == (2, 128, 4)
    for bits in (8, 4):
        jeng = deepspeed_tpu.init_inference(jm, dtype=jnp.float32, params=jp,
                                            quantize_bits=bits)
        bridged = params_from_numpy(pm.config, jax.tree.map(np.asarray, jeng.params))
        ported = quantize_weights(pp, bits)
        for name in ("wi", "wg", "wo"):
            leaf, other = bridged["layers"]["mlp"][name], ported["layers"]["mlp"][name]
            assert isinstance(leaf, PackedWeight) and leaf.qdata.ndim == 5
            # int4 nibble-packs wo (two contraction blocks), not wi/wg (one)
            assert leaf.nibbles == other.nibbles == (bits == 4 and name == "wo")
            assert torch.equal(leaf.qdata, other.qdata), name
            assert torch.equal(leaf.scale, other.scale), name
        assert not isinstance(bridged["layers"]["mlp"]["router"], PackedWeight)


def test_fp32_logits_match_jax(pair):
    jm, jp, pm, pp = pair
    ids = _prompt(seed=1)
    jlog, jaux = jm.apply(jp, jnp.asarray(ids), dtype=jnp.float32)
    plog, paux = apply(pm.config, pp, torch.from_numpy(ids), return_aux=True)
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(paux), float(jaux), rtol=1e-5)
    # the cached forward: a 16-token prefill, then three single-token steps
    jc = jdec.init_cache(jm.config, 2, 128, jnp.float32)
    pc = pdec.init_cache(pm.config, 2, 128, torch.float32)
    for start, stop in ((0, 16), (16, 17), (17, 18), (18, 19)):
        chunk = ids[:, start:stop]
        jl, jc = jdec.forward_with_cache(jm.config, jp, jnp.asarray(chunk), jc, start,
                                         dtype=jnp.float32)
        pl, pc = pdec.forward_with_cache(pm.config, pp, torch.from_numpy(chunk), pc, start)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_greedy_tokens_match_jax(pair, name):
    jm, jp, pm, pp = pair
    kw = dict(CASES[name])
    bf16 = kw.pop("dtype", None) == "bf16"
    jeng = deepspeed_tpu.init_inference(jm, dtype=jnp.bfloat16 if bf16 else jnp.float32,
                                        params=jp, max_tokens=256, **kw)
    peng = deepspeed_tpu_torch.init_inference(
        pm, dtype=torch.bfloat16 if bf16 else torch.float32, params=pp, max_tokens=256,
        device="cpu", **kw)
    ids = _prompt(seed=2)
    want = np.asarray(jeng.generate(ids, max_new_tokens=NEW))
    got = peng.generate(ids, max_new_tokens=NEW)
    if not bf16:  # fp32 logits: no near-tie may decide a token
        top2 = peng.forward(got[:, :-1].numpy())[:, P - 1:].topk(2, dim=-1).values
        assert float((top2[..., 0] - top2[..., 1]).min()) > 1e-4
    np.testing.assert_array_equal(got.numpy(), want)


def test_speculative_decode_equals_plain_greedy(pair):
    """E = 4, top-2 drops no token, so the verify window routes each token
    as single-token decode does: drafted by its own weights every proposal
    is accepted, and with int8 expert banks and a draft of other (seeded)
    weights the tokens are still plain greedy's. On Mixtral-8x7B (E = 8) a
    verify window can drop tokens, and this is not promised."""
    _, _, pm, pp = pair
    ids = _prompt(B=1, seed=3)
    for bits in (None, 8):
        kw = dict(dtype=torch.float32, params=pp, max_tokens=256, device="cpu",
                  quantize_bits=bits)
        plain = deepspeed_tpu_torch.init_inference(pm, **kw)
        spec = deepspeed_tpu_torch.init_inference(
            pm, draft_model=pm, draft_params=plain.params if bits is None else None, **kw)
        want = plain.generate(ids, max_new_tokens=16)
        got = spec.generate(ids, max_new_tokens=16, num_draft_tokens=3)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        if bits is None:
            assert spec.last_spec_rounds == 4  # ceil(15 / 4): all accepted


PROMPTS, NEWS = (3, 12, 7, 21, 9), (6, 4, 8, 5, 3)


def _serving(paged):
    return {"max_slots": 3, "token_budget": 8, "max_tokens": 64, "paged": paged,
            "page_size": 16}


def _drive(srv, make, prompts):
    """Two requests, two steps, then the rest (one staggered schedule)."""
    states = [srv.submit(make(f"r{i}", prompts[i], max_new_tokens=NEWS[i]))
              for i in range(2)]
    for _ in range(2):
        srv.step()
    states += [srv.submit(make(f"r{i}", prompts[i], max_new_tokens=NEWS[i]))
               for i in range(2, len(prompts))]
    while srv.scheduler.has_work:
        srv.step()
    return states


def test_serving_matches_generate_jax_and_its_own_stats(pair, monkeypatch):
    jm, jp, pm, pp = pair
    r = np.random.RandomState(4)
    prompts = [r.randint(0, V, size=(n,)) for n in PROMPTS]
    peng = deepspeed_tpu_torch.init_inference(pm, dtype=torch.float32, params=pp,
                                              max_tokens=64, device="cpu")
    seen = []  # the per-layer stats of every step's moe_serving_mlp calls
    real = pdec.moe_serving_mlp

    def spy(*a, **k):
        out, st = real(*a, **k)
        seen.append({n: t.clone() for n, t in st.items()})
        return out, st

    monkeypatch.setattr(pdec, "moe_serving_mlp", spy)
    outs, metrics = {}, {}
    for paged in (False, True):
        seen.clear()
        srv = ServingEngine(engine=peng, serving=_serving(paged))
        states = _drive(srv, Request, prompts)
        assert all(s.status is RequestStatus.DONE for s in states)
        assert srv.step_traces == 1
        outs[paged] = [s.output() for s in states]
        m = srv.metrics
        L = pm.config.num_layers
        assert m.moe_steps == len(seen) // L and len(seen) % L == 0
        hist = torch.stack([st["tokens_per_expert"] for st in seen]).sum(0)
        assert m.moe_tokens_per_expert == hist.tolist()
        last = torch.stack([st["drop_fraction"] for st in seen[-L:]]).mean()
        assert m.moe_dropped_fraction == pytest.approx(float(last), abs=0)
        assert m.moe_dropped_fraction == 0.0  # E = 4, top-2: no drops
        metrics[paged] = m.moe_tokens_per_expert
    monkeypatch.undo()
    for i, (a, b) in enumerate(zip(outs[False], outs[True])):
        np.testing.assert_array_equal(a, b, err_msg=f"r{i}")  # paged == contiguous
        lockstep = peng.generate(prompts[i][None, :], max_new_tokens=NEWS[i])
        np.testing.assert_array_equal(a, lockstep[0].numpy(), err_msg=f"r{i}")
    assert metrics[False] == metrics[True]
    # the JAX slot engine on the same weights ("auto" knobs pinned)
    jeng = deepspeed_tpu.init_inference(jm, dtype=jnp.float32, params=jp, max_tokens=64)
    jsrv = JServingEngine(engine=jeng, serving=dict(
        _serving(True), kv_cache_dtype="bf16", moe_a2a="stock", spec={"enabled": False}))
    want = _drive(jsrv, JRequest, prompts)
    for i, (w, g) in enumerate(zip(want, outs[True])):
        np.testing.assert_array_equal(g, w.output(), err_msg=f"r{i}")
    assert jsrv.metrics.moe_tokens_per_expert == metrics[True]


@pytest.mark.parametrize("bits", [8, 4])
def test_layerwise_init_and_pack_equals_packing_the_tree(bits):
    cfg = mixtral("mixtral-tiny", vocab_size=V).config
    dense = init_layerwise(cfg, torch.Generator().manual_seed(5), torch.float32, "cpu")
    packed = init_layerwise(cfg, torch.Generator().manual_seed(5), torch.float32, "cpu",
                            bits)
    want = quantize_weights(dense, bits)
    for grp in ("attn", "mlp"):
        for name, leaf in packed["layers"][grp].items():
            other = want["layers"][grp][name]
            if isinstance(other, PackedWeight):
                assert isinstance(leaf, PackedWeight) and leaf.shape == other.shape
                assert leaf.nibbles == other.nibbles and leaf.bits == bits
                assert torch.equal(leaf.qdata, other.qdata), (grp, name)
                assert torch.equal(leaf.scale, other.scale), (grp, name)
            else:
                assert torch.equal(leaf, other), (grp, name)
    # the engine draws and packs layer by layer when it makes the weights
    eng = deepspeed_tpu_torch.init_inference(
        mixtral("mixtral-tiny", vocab_size=V), dtype=torch.float32, device="cpu",
        quantize_bits=bits, rng=torch.Generator().manual_seed(5))
    assert torch.equal(eng.params["layers"]["mlp"]["wi"].qdata,
                       packed["layers"]["mlp"]["wi"].qdata)
    assert torch.equal(eng.params["embed"]["tok"], packed["embed"]["tok"])


def test_refusals(pair):
    _, _, pm, _ = pair
    with pytest.raises(NotImplementedError, match="ep_size=2"):
        deepspeed_tpu_torch.init_inference(pm, ep_size=2, device="cpu")
    with pytest.raises(NotImplementedError, match="A7/A9"):
        deepspeed_tpu_torch.initialize(
            model=pm, device="cpu",
            config={"train_batch_size": 2, "moe": {"enabled": True, "ep_size": 2}})
    with pytest.raises(NotImplementedError, match="A7/A9"):
        deepspeed_tpu_torch.initialize(
            model=llama("llama-tiny"), device="cpu",
            config={"train_batch_size": 2, "moe": {"enabled": True, "ep_size": 2}})
