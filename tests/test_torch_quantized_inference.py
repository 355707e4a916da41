"""Weight-only quantized serving: the port's ``init_inference`` with int8 and
int4 weights (and the int8 KV cache) against the JAX engine on the same fp32
weights. Greedy tokens must be equal over 16 new tokens; the no-cache logits
agree within rtol 1e-4 / atol 1e-5 (fp32 sums in another order).

The config packs every projection: hidden 256, 4 heads of 64, 2 KV heads, FFN
512, so wk/wv have 128 columns and the contraction dim two blocks (int4
nibble-packs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.ops.quantizer import PackedWeight

from torch_bridge import tiny_pair

PACKED = dict(hidden_size=256, intermediate_size=512)
P, NEW = 20, 16
CASES = {
    "int8": dict(quantize_bits=8),
    "int4": dict(quantize_bits=4),
    "int8-kv8": dict(quantize_bits=8, kv_cache_dtype="int8"),
}


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=0, **PACKED)


@pytest.fixture(scope="module")
def jax_engines(pair):
    jm, jp, _, _ = pair
    return {name: deepspeed_tpu.init_inference(jm, dtype=jnp.float32, params=jp,
                                               max_tokens=256, **kw)
            for name, kw in CASES.items()}


def _prompt(seed=0):
    return np.random.RandomState(seed).randint(0, 256, size=(2, P))


@pytest.mark.parametrize("name", list(CASES))
def test_quantized_greedy_tokens_match_jax(pair, jax_engines, name):
    _, _, pm, pp = pair
    peng = deepspeed_tpu_torch.init_inference(pm, dtype=torch.float32, params=pp,
                                              max_tokens=256, device="cpu",
                                              **CASES[name])
    ids = _prompt()
    want = np.asarray(jax_engines[name].generate(ids, max_new_tokens=NEW))
    got = peng.generate(ids, max_new_tokens=NEW)
    logits = peng.forward(got[:, :-1].numpy())
    top2 = logits[:, P - 1:].topk(2, dim=-1).values
    assert float((top2[..., 0] - top2[..., 1]).min()) > 1e-4  # no near-ties
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(jax_engines[name].forward(want[:, :-1])),
                               rtol=1e-4, atol=1e-5)


def test_leaf_dtypes_after_init_inference(pair):
    """Packed leaves keep int8 qdata and fp32 scales through the engine's
    cast (a stray .to(dtype) would turn them bf16); norms and the head are
    cast, the six projections of every layer packed."""
    _, _, pm, pp = pair
    eng = deepspeed_tpu_torch.init_inference(pm, dtype="int8", params=pp,
                                             device="cpu")
    assert eng.dtype == torch.bfloat16
    layers = eng.params["layers"]
    for grp, names in (("attn", ("wq", "wk", "wv", "wo")), ("mlp", ("wi", "wg", "wo"))):
        for n in names:
            leaf = layers[grp][n]
            assert isinstance(leaf, PackedWeight), (grp, n)
            assert leaf.qdata.dtype == torch.int8 and leaf.scale.dtype == torch.float32
            assert leaf.bits == 8 and leaf.dtype == torch.bfloat16
    assert layers["ln1"]["scale"].dtype == torch.bfloat16
    assert eng.params["lm_head"].dtype == torch.bfloat16
    eng4 = deepspeed_tpu_torch.init_inference(pm, dtype="int4", params=pp,
                                              device="cpu", config={"matvec_max_rows": 12})
    wq = eng4.params["layers"]["attn"]["wq"]
    assert wq.bits == 4 and wq.nibbles and wq.qdata.shape == (2, 1, 128, 256)
    assert eng4.matvec_max_rows == 12


def test_jax_packed_tree_served_by_the_port(pair, jax_engines):
    """The weight bridge carries the JAX engine's own packed leaves (bytes,
    scales, bits, nibbles) into the port unchanged; the port serves them
    with the JAX engine's greedy tokens."""
    jm, _, pm, _ = pair
    jeng = jax_engines["int4"]
    tree = jax.tree.map(np.asarray, jeng.params)
    pp = params_from_numpy(pm.config, tree)
    wi = pp["layers"]["mlp"]["wi"]
    jwi = jeng.params["layers"]["mlp"]["wi"]
    assert isinstance(wi, PackedWeight) and wi.nibbles == jwi.nibbles
    np.testing.assert_array_equal(wi.qdata.numpy(), np.asarray(jwi.qdata))
    peng = deepspeed_tpu_torch.init_inference(pm, dtype=torch.float32, params=pp,
                                              max_tokens=256, device="cpu")
    ids = _prompt(seed=1)
    np.testing.assert_array_equal(peng.generate(ids, max_new_tokens=NEW).numpy(),
                                  np.asarray(jeng.generate(ids, max_new_tokens=NEW)))


def test_port_packing_of_the_same_weights_equals_the_bridged_bytes(pair, jax_engines):
    _, _, pm, pp = pair
    peng = deepspeed_tpu_torch.init_inference(pm, dtype=torch.float32, params=pp,
                                              quantize_bits=8, device="cpu")
    bridged = params_from_numpy(pm.config, jax.tree.map(np.asarray,
                                                        jax_engines["int8"].params))
    for grp in ("attn", "mlp"):
        for n, leaf in peng.params["layers"][grp].items():
            other = bridged["layers"][grp][n]
            assert torch.equal(leaf.qdata, other.qdata), (grp, n)
            assert torch.equal(leaf.scale, other.scale), (grp, n)
