"""MoE training in the port against the JAX package, fp32, on seeded numpy
inputs and the JAX init's weights (bridged by ``params_from_numpy``):

- (a) ``moe_layer(train=True)``: output, aux loss and the gradient of every
  input (x, router, banks, the residual branch) against JAX's
  ``moe_layer(..., None, True)`` under ``jax.grad``, both dispatch forms,
  with and without ``moe_use_residual``, and at ``moe_capacity_factor`` 0.5
  where tokens drop: rtol 1e-5 / atol 1e-6 on values, rtol 1e-4 / atol 1e-6
  on gradients (fp32 sums in another order);
- (b) ``loss_fn(train=True)`` on ``mixtral-tiny``: loss, ``lm_loss``,
  ``moe_aux_loss`` (rtol 1e-5) and the gradient of every leaf, the router's
  included (rtol 1e-4, atol 1e-6), both dispatch forms;
- (c) ``initialize`` with a ``moe`` section trains 2 steps of
  ``mixtral-tiny`` equal to ``TpuEngine``'s: losses rtol 1e-5, the masters
  atol 2e-5 (``tests/test_torch_training.py``'s tolerances), the logged aux
  loss rtol 1e-5; ``overlap_a2a`` at ep 1 is logged and ignored;
- (d) router noise, held inside the port: a seeded generator gives the same
  noisy routing twice; with ``train=False`` or ``noise_std == 0`` the
  generator's state is unchanged and the routing is the noiseless one.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.topology import MeshTopology, ParallelDims
from deepspeed_tpu.models import mixtral as jmixtral
from deepspeed_tpu.models.transformer import loss_fn as jax_loss_fn
from deepspeed_tpu.moe import sharded_moe as jmoe
from deepspeed_tpu_torch.models import TransformerModel
from deepspeed_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from deepspeed_tpu_torch.models.transformer import loss_fn
from deepspeed_tpu_torch.moe import sharded_moe as pmoe

from torch_bridge import port_config

V = 256


def _layer(seed=0, **over):
    jm = jmixtral("mixtral-tiny", vocab_size=64, **over)
    lp = jax.tree.map(lambda a: np.asarray(a)[0],
                      jm.init(jax.random.PRNGKey(seed))["layers"]["mlp"])
    return jm.config, port_config(jm.config), lp


LAYER_CASES = {
    "einsum": dict(moe_dispatch="einsum"),
    "gather": dict(moe_dispatch="gather"),
    "einsum-residual": dict(moe_dispatch="einsum", moe_use_residual=True),
    "gather-residual": dict(moe_dispatch="gather", moe_use_residual=True),
    "einsum-drops": dict(moe_dispatch="einsum", moe_capacity_factor=0.5),
    "gather-drops": dict(moe_dispatch="gather", moe_capacity_factor=0.5),
}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_moe_layer_train_matches_jax(case):
    jcfg, pcfg, lp = _layer(**LAYER_CASES[case])
    r = np.random.RandomState(1)
    x = r.randn(2, 12, 128).astype(np.float32)
    cot = r.randn(2, 12, 128).astype(np.float32)  # the output's cotangent

    def jloss(x, p):
        out, aux = jmoe.moe_layer(jcfg, p, x, None, True)
        return jnp.sum(out * cot) + aux, (out, aux)

    (_, (jout, jaux)), (jgx, jgp) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(x),
                                              {k: jnp.asarray(v) for k, v in lp.items()})
    px = torch.from_numpy(x).requires_grad_(True)
    pp = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in lp.items()}
    pout, paux = pmoe.moe_layer(pcfg, pp, px, train=True)
    ((pout * torch.from_numpy(cot)).sum() + paux).backward()
    np.testing.assert_allclose(pout.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(paux.item(), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(px.grad.numpy(), np.asarray(jgx), rtol=1e-4, atol=1e-6)
    for k, g in jgp.items():
        np.testing.assert_allclose(pp[k].grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert float(np.abs(np.asarray(jgp["router"])).max()) > 0  # the gates carry gradient
    # the training capacity: 0.5 · 2 · 24 / 4 = 6 slots for 48 assignments
    cap = pmoe.train_capacity(pcfg, 24)
    assert cap == (6 if case.endswith("drops") else 24)
    logits = px.detach().reshape(24, 128) @ pp["router"].detach()
    _, _, metrics = pmoe.top_k_gating(logits, 2, cap, train=True)
    assert (float(metrics["drop_fraction"]) > 0) == case.endswith("drops")


@pytest.fixture(scope="module")
def tiny():
    jm = jmixtral("mixtral-tiny", vocab_size=V, max_seq_len=512)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    return jm, tree


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_loss_and_grads_match_jax(tiny, dispatch):
    jm, tree = tiny
    jcfg = dataclasses.replace(jm.config, moe_dispatch=dispatch)
    pcfg = port_config(jcfg)
    ids = np.random.RandomState(2).randint(0, V, size=(2, 32))
    labels = np.concatenate([ids[:, 1:], np.full((2, 1), -1)], axis=1)
    labels[0, :5] = -1
    jbatch = {"input_ids": jnp.asarray(ids), "labels": jnp.asarray(labels)}
    (jtotal, jm_), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(jcfg, p, jbatch, dtype=jnp.float32, train=True),
        has_aux=True))(jax.tree.map(jnp.asarray, tree))
    params = {k: v for k, v in params_from_numpy(pcfg, tree).items()}
    leaves = jax.tree.map(lambda a: a.requires_grad_(True), params)
    total, m = loss_fn(pcfg, leaves, {"input_ids": torch.from_numpy(ids),
                                      "labels": torch.from_numpy(labels)},
                       dtype=torch.float32, train=True)
    total.backward()
    for got, want in ((total, jtotal), (m["lm_loss"], jm_["lm_loss"]),
                      (m["moe_aux_loss"], jm_["moe_aux_loss"]), (m["tokens"], jm_["tokens"])):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(total.item(), m["lm_loss"].item() + jcfg.moe_aux_loss_coef
                               * m["moe_aux_loss"].item(), rtol=1e-6)
    got = params_to_numpy(jax.tree.map(lambda a: a.grad, leaves))
    jax.tree_util.tree_map_with_path(
        lambda path, g, w: np.testing.assert_allclose(
            g, np.asarray(w), rtol=1e-4, atol=1e-6, err_msg=jax.tree_util.keystr(path)),
        got, jax.tree.map(np.asarray, jgrads))


def _cfg(**extra):
    return {
        "train_batch_size": 4, "gradient_accumulation_steps": 2,
        # eps 1e-6, not Adam's 1e-8: with 1e-8 one element of the 1.0 M
        # (layer 1 wv[86, 6]) takes micro-batch gradients 7.5141e-4 and
        # -7.5141e-4, whose sum (about 2e-9) Adam normalises into an update set
        # by the two packages' fp32 summation noise: 2.5e-5 apart after two
        # steps, every other element within 3.3e-6
        "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.01,
                                                  "eps": 1e-6}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_num_steps": 3, "warmup_type": "linear"}},
        "gradient_clipping": 1.0, "steps_per_print": 1,
        "moe": {"enabled": True, "ep_size": 1},
        # explicit values for the JAX engine's "auto" knobs
        "zero_optimization": {"stage": 0, "grad_wire": "fp32", "param_wire": "fp32"},
        "serving": {"moe_a2a": "stock", "kv_cache_dtype": "bf16"},
        **extra,
    }


def test_initialize_trains_mixtral_like_tpu_engine(tiny):
    jm, tree = tiny
    cfg = _cfg()
    topo = MeshTopology(dims=ParallelDims(), devices=jax.devices()[:1])
    jeng, *_ = deepspeed_tpu.initialize(model=jm, config=dict(cfg), topology=topo,
                                        rng=jax.random.PRNGKey(0))
    pm = TransformerModel(port_config(jm.config))
    records = []
    handler = logging.Handler()
    handler.emit = lambda record: records.append(record.getMessage())
    logger = logging.getLogger("deepspeed_tpu_torch")
    logger.addHandler(handler)
    try:
        peng, *_ = deepspeed_tpu_torch.initialize(
            model=pm, config={**cfg, "moe": {**cfg["moe"], "overlap_a2a": True}},
            model_parameters=params_from_numpy(pm.config, tree), device="cpu")
        r = np.random.RandomState(3)
        for _ in range(2):
            batch = {"input_ids": r.randint(0, V, size=(4, 64))}
            jl = float(jeng.train_batch(batch=batch))
            np.testing.assert_allclose(peng.train_batch(batch=batch).item(), jl, rtol=1e-5)
            np.testing.assert_allclose(float(peng._metrics["moe_aux_loss"]),
                                       float(jeng._metrics["moe_aux_loss"]), rtol=1e-5)
            np.testing.assert_allclose(float(peng._metrics["lm_loss"]),
                                       float(jeng._metrics["lm_loss"]), rtol=1e-5)
    finally:
        logger.removeHandler(handler)
    assert peng.config.moe.overlap_a2a.enabled is True
    assert any("overlap_a2a" in m and "ignored" in m for m in records)
    assert any("moe_aux=" in m for m in records if ": loss=" in m)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, atol=2e-5),
                 params_to_numpy(peng.params), jax.tree.map(np.asarray, jeng.state.params))


def test_router_noise_held_inside_the_port():
    logits = torch.from_numpy(np.random.RandomState(4).randn(24, 4).astype(np.float32))
    plain, _ = pmoe._gating_rounds(logits, 2, 24)

    def routing(rounds):
        return [(i.clone(), p.clone()) for i, p, _, _ in rounds]

    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(7)
        rounds, _ = pmoe._gating_rounds(logits, 2, 24, gen, True, noise_std=1.0)
        runs.append(routing(rounds))
    for (i0, p0), (i1, p1) in zip(*runs):
        assert torch.equal(i0, i1) and torch.equal(p0, p1)
    assert any(not torch.equal(i, j) for (i, _), (j, _, _, _) in zip(runs[0], plain))
    for train, std in ((False, 1.0), (True, 0.0)):
        gen = torch.Generator().manual_seed(7)
        state = gen.get_state()
        rounds, _ = pmoe._gating_rounds(logits, 2, 24, gen, train, noise_std=std)
        assert torch.equal(gen.get_state(), state)
        for (i, p), (j, q, _, _) in zip(routing(rounds), plain):
            assert torch.equal(i, j) and torch.equal(p, q)
    # moe_layer threads its generator without a noise_std: no draw
    jcfg, pcfg, lp = _layer()
    gen = torch.Generator().manual_seed(7)
    state = gen.get_state()
    x = torch.from_numpy(np.random.RandomState(5).randn(1, 8, 128).astype(np.float32))
    pp = {k: torch.from_numpy(np.array(v)) for k, v in lp.items()}
    out, _ = pmoe.moe_layer(pcfg, pp, x, rng=gen, train=True)
    assert torch.equal(gen.get_state(), state)
    assert torch.equal(out, pmoe.moe_layer(pcfg, pp, x, train=True)[0])
