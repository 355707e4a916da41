"""The port's MoE layer (``deepspeed_tpu_torch.moe.sharded_moe``) against the
JAX package's on the same seeded numpy inputs, fp32: the gating tables and
masks exactly (integer tables, one-hot masks and selected gates are exact;
renormalised weights and the losses within rtol 1e-6), with and without the
null-expert ``valid`` mask, under forced capacity overflow and with tied
logits; ``eval_capacity``; ``moe_layer`` at eval in both dispatch forms and
with the residual branch, and ``moe_serving_mlp`` under ``token_valid``,
outputs within rtol 1e-5 / atol 1e-6 (fp32 sums in another order); what
``moe_layer`` refuses."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import mixtral as jmixtral
from deepspeed_tpu.moe import sharded_moe as jmoe
from deepspeed_tpu_torch.models import TransformerModel
from deepspeed_tpu_torch.moe import sharded_moe as pmoe
from deepspeed_tpu_torch.ops.quantizer import pack_quantize_blockwise

from torch_bridge import port_config

N, E, K = 24, 4, 2
METRICS = ("aux_loss", "z_loss", "drop_fraction", "tokens_per_expert", "routed_tokens")


def _logits(seed, ties=False):
    r = np.random.RandomState(seed)
    x = r.randn(N, E).astype(np.float32)
    if ties:
        # few distinct values: tied maxima in a row and tied rows
        x = np.round(x).astype(np.float32)
        x[3] = x[4] = 1.0
    return x


def _valid(seed):
    v = np.random.RandomState(seed + 100).rand(N) > 0.3
    v[0] = True
    return v


CASES = {
    "no-drop": dict(capacity=16, valid=False, ties=False),
    "overflow": dict(capacity=3, valid=False, ties=False),
    "valid": dict(capacity=16, valid=True, ties=False),
    "valid-overflow": dict(capacity=3, valid=True, ties=False),
    "ties": dict(capacity=5, valid=False, ties=True),
    "ties-valid": dict(capacity=5, valid=True, ties=True),
}


def _both(case, seed=0):
    c = CASES[case]
    logits = _logits(seed, c["ties"])
    valid = _valid(seed) if c["valid"] else None
    jv = jnp.asarray(valid) if valid is not None else None
    pv = torch.from_numpy(valid) if valid is not None else None
    return logits, c["capacity"], jv, pv


def _check_metrics(jm, pm):
    for k in METRICS:
        np.testing.assert_allclose(pm[k].numpy(), np.asarray(jm[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_top_k_gating_matches_jax(case):
    logits, cap, jv, pv = _both(case)
    jd, jc, jmet = jmoe.top_k_gating(jnp.asarray(logits), K, cap, None, False, valid=jv)
    pd, pc, pmet = pmoe.top_k_gating(torch.from_numpy(logits), K, cap, valid=pv)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-7)
    _check_metrics(jmet, pmet)
    if case == "overflow":
        assert float(pmet["drop_fraction"]) > 0


@pytest.mark.parametrize("case", list(CASES))
def test_top_k_gating_indices_matches_jax(case):
    logits, cap, jv, pv = _both(case, seed=1)
    jout = jmoe.top_k_gating_indices(jnp.asarray(logits), K, cap, None, False, valid=jv)
    pout = pmoe.top_k_gating_indices(torch.from_numpy(logits), K, cap, valid=pv)
    for name, j, p in zip(("tok_of_slot", "slot_valid", "slot_of_tok"), jout[:3], pout[:3]):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j), err_msg=name)
    np.testing.assert_allclose(pout[3].numpy(), np.asarray(jout[3]), rtol=1e-6, atol=1e-7)
    _check_metrics(jout[4], pout[4])
    if pv is not None:  # invalid rows take no slot and carry no weight
        assert not np.isin(np.nonzero(~pv.numpy())[0],
                           pout[0].numpy()[pout[1].numpy()]).any()
        assert (pout[3].numpy()[~pv.numpy()] == 0).all()


def test_gating_invalid_rows_do_not_shift_real_routing():
    """The null-expert contract: padding rows between the real ones change
    nothing of the real tokens' routing."""
    logits = _logits(2)
    valid = _valid(2)
    full = pmoe.top_k_gating_indices(torch.from_numpy(logits), K, 5,
                                     valid=torch.from_numpy(valid))
    real = pmoe.top_k_gating_indices(torch.from_numpy(logits[valid]), K, 5)
    np.testing.assert_array_equal(full[3].numpy()[valid], real[3].numpy())
    np.testing.assert_array_equal(full[4]["tokens_per_expert"].numpy(),
                                  real[4]["tokens_per_expert"].numpy())


@pytest.mark.parametrize("experts,top_k,cf,n", [
    (4, 2, 2.0, 1), (4, 2, 1.0, 24), (8, 2, 2.0, 4), (8, 2, 2.0, 2048),
    (8, 1, 3.0, 100), (8, 2, 1.25, 513)])
def test_eval_capacity_matches_jax(experts, top_k, cf, n):
    jcfg = jmixtral("mixtral-tiny", num_experts=experts, moe_top_k=top_k,
                    moe_capacity_factor=cf).config
    assert pmoe.eval_capacity(port_config(jcfg), n) == jmoe.eval_capacity(jcfg, n)


def _layer(seed=0, **over):
    jm = jmixtral("mixtral-tiny", vocab_size=64, **over)
    jp = jm.init(jax.random.PRNGKey(seed))
    lp = jax.tree.map(lambda a: np.asarray(a)[0], jp["layers"]["mlp"])
    pcfg = TransformerModel(port_config(jm.config)).config
    return jm.config, {k: jnp.asarray(v) for k, v in lp.items()}, pcfg, \
        {k: torch.from_numpy(np.array(v)) for k, v in lp.items()}


def _hidden(B, S, seed=3):
    return np.random.RandomState(seed).randn(B, S, 128).astype(np.float32)


@pytest.mark.parametrize("form", ["einsum", "gather", "gather-residual",
                                  "einsum-gelu-residual"])
def test_moe_layer_eval_matches_jax(form):
    # E = 8, top-2: eval capacity max(4, ceil(2·2·18 / 8)) = 9 slots an
    # expert for 36 assignments, so a loaded expert can drop
    over = dict(moe_dispatch=form.split("-")[0], num_experts=8,
                moe_use_residual=form.endswith("residual"))
    if "gelu" in form:
        over["activation"] = "gelu"
    jcfg, jp, pcfg, pp = _layer(**over)
    x = _hidden(2, 9)
    jout, jaux = jmoe.moe_layer(jcfg, jp, jnp.asarray(x), None, False)
    pout, paux = pmoe.moe_layer(pcfg, pp, torch.from_numpy(x))
    np.testing.assert_allclose(pout.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(paux), float(jaux), rtol=1e-6)


def test_moe_layer_refuses_training():
    """Training a packed int8 expert bank raises (the banks are for
    inference); an unknown ``moe_dispatch`` raises in training and at eval."""
    _, _, pcfg, pp = _layer()
    packed = {**pp, "wi": pack_quantize_blockwise(pp["wi"], bits=8)}
    with pytest.raises(NotImplementedError, match="packed int8/int4 expert banks"):
        pmoe.moe_layer(pcfg, packed, torch.zeros(1, 2, 128), train=True)
    bad = dataclasses.replace(pcfg, moe_dispatch="scatter")
    with pytest.raises(ValueError, match="moe_dispatch"):
        pmoe.moe_layer(bad, pp, torch.zeros(1, 2, 128), train=True)
    with pytest.raises(ValueError, match="moe_dispatch"):
        pmoe.moe_layer(bad, pp, torch.zeros(1, 2, 128))


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("budget", [None, 16])
def test_moe_serving_mlp_matches_jax(residual, budget):
    jcfg, jp, pcfg, pp = _layer(seed=1, moe_use_residual=residual,
                                moe_capacity_factor=1.0, num_experts=8)
    B, S = 3, 8
    x = _hidden(B, S, seed=4)
    tv = np.random.RandomState(5).rand(B, S) > 0.25
    jout, jst = jmoe.moe_serving_mlp(jcfg, jp, jnp.asarray(x), token_valid=jnp.asarray(tv),
                                     budget_tokens=budget)
    pout, pst = pmoe.moe_serving_mlp(pcfg, pp, torch.from_numpy(x),
                                     token_valid=torch.from_numpy(tv),
                                     budget_tokens=budget)
    np.testing.assert_allclose(pout.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
    assert set(pst) == set(jst) == {"tokens_per_expert", "drop_fraction"}
    np.testing.assert_array_equal(pst["tokens_per_expert"].numpy(),
                                  np.asarray(jst["tokens_per_expert"]))
    np.testing.assert_allclose(float(pst["drop_fraction"]), float(jst["drop_fraction"]),
                               rtol=1e-6)
    # padded rows get no routed output (residual: only the dense branch)
    if not residual:
        assert (pout.numpy()[~tv] == 0).all()
