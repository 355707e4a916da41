"""The port's lion, adagrad, lamb / fusedlamb and sgd (momentum 0 and 0.9)
against the JAX package's ``build_optimizer`` optax chains, fp32, with weight
decay, a clip factor and a linear warmup:

- five steps on a random tree (a zero leaf included: LAMB's trust ratio is 1
  there), parameters and optimizer state within atol 1e-7 (the lr rounds
  once more in the JAX chain, an fp32 schedule, and LAMB's norms sum in
  another order);
- one ``initialize`` → ``train_batch`` step of a one-layer llama-tiny against
  ``TpuEngine`` from the same masters: loss rtol 1e-5, masters atol 2e-5
  (``tests/test_torch_training.py``'s tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.topology import MeshTopology, ParallelDims
from deepspeed_tpu.config import OptimizerConfig as JaxOptimizerConfig
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.runtime.lr_schedules import build_schedule as jax_schedule
from deepspeed_tpu.runtime.optimizers import build_optimizer as jax_build_optimizer
from deepspeed_tpu_torch.config import OptimizerConfig
from deepspeed_tpu_torch.models import TransformerModel
from deepspeed_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from deepspeed_tpu_torch.runtime.lr_schedules import build_schedule
from deepspeed_tpu_torch.runtime.optimizers import build_optimizer

from torch_bridge import TINY, port_config

OPTIMIZERS = {
    "lion": {"type": "lion", "params": {"lr": 1e-2, "weight_decay": 0.1,
                                        "betas": [0.9, 0.99]}},
    "adagrad": {"type": "adagrad", "params": {"lr": 1e-2, "weight_decay": 0.1,
                                              "initial_accumulator_value": 0.1}},
    "lamb": {"type": "lamb", "params": {"lr": 1e-2, "weight_decay": 0.1,
                                        "betas": [0.9, 0.95], "eps": 1e-6}},
    "fusedlamb": {"type": "FusedLamb", "params": {"lr": 1e-2, "weight_decay": 0.1}},
    "sgd": {"type": "sgd", "params": {"lr": 1e-2, "weight_decay": 0.1}},
    "sgd-momentum": {"type": "sgd", "params": {"lr": 1e-2, "weight_decay": 0.1,
                                               "momentum": 0.9}},
}
SCHED = ("WarmupLR", {"warmup_num_steps": 4, "warmup_type": "linear"})


def _tree(r):
    return {"w": r.randn(16, 8).astype(np.float32),
            "b": {"s": r.randn(8).astype(np.float32), "z": np.zeros(4, np.float32)}}


def _state_arrays(state):
    """Every array of an optax state, in order (counters dropped)."""
    return [np.asarray(a) for a in jax.tree.leaves(state) if np.ndim(a) > 0]


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_five_steps_match_optax_chain(name):
    opt = OPTIMIZERS[name]
    jtx = jax_build_optimizer(JaxOptimizerConfig(**opt), jax_schedule(*SCHED, 1e-2))
    tx = build_optimizer(OptimizerConfig(**opt), build_schedule(*SCHED, 1e-2))
    r = np.random.RandomState(0)
    start = _tree(r)
    jparams = jax.tree.map(jnp.asarray, start)
    jstate = jtx.init(jparams)
    params = jax.tree.map(lambda a: torch.from_numpy(a.copy()), start)
    state = tx.init(params)
    for step in range(5):
        g, clip = _tree(r), np.float32(0.5 + 0.1 * step)
        upd, jstate = jtx.update(jax.tree.map(lambda a: jnp.asarray(a) * clip, g), jstate,
                                 jparams)
        jparams = optax.apply_updates(jparams, upd)
        tx.step(params, jax.tree.map(torch.from_numpy, g), state, step,
                clip=torch.tensor(clip))
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7),
                 params, jparams)
    # optax lists the state's trees in order (mu before nu), leaves by sorted key
    mine = [t.numpy() for slot in sorted(state) for t in jax.tree.leaves(state[slot])]
    theirs = _state_arrays(jstate)
    assert len(mine) == len(theirs) == {"sgd": 0, "lamb": 6, "fusedlamb": 6}.get(name, 3)
    for a, b in zip(mine, theirs):
        np.testing.assert_allclose(a, b, atol=1e-7, rtol=0)
    moved = jax.tree.map(lambda a, b: float(np.abs(a.numpy() - b).max()), params, start)
    assert moved["w"] > 1e-3


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_one_engine_step_matches_tpu_engine(name):
    opt = {**OPTIMIZERS[name], "params": {**OPTIMIZERS[name]["params"], "lr": 1e-3}}
    cfg = {
        "train_batch_size": 4, "optimizer": opt,
        "scheduler": {"type": SCHED[0], "params": SCHED[1]},
        "gradient_clipping": 1.0, "steps_per_print": 100,
        "zero_optimization": {"stage": 0, "grad_wire": "fp32", "param_wire": "fp32"},
        "serving": {"moe_a2a": "stock", "kv_cache_dtype": "bf16"},
    }
    jm = jax_llama("llama-tiny", **{**TINY, "num_layers": 1})
    topo = MeshTopology(dims=ParallelDims(), devices=jax.devices()[:1])
    jeng, *_ = deepspeed_tpu.initialize(model=jm, config=dict(cfg), topology=topo,
                                        rng=jax.random.PRNGKey(0))
    pm = TransformerModel(port_config(jm.config))
    peng, *_ = deepspeed_tpu_torch.initialize(
        model=pm, config=dict(cfg), device="cpu",
        model_parameters=params_from_numpy(pm.config,
                                           jax.tree.map(np.asarray, jeng.state.params)))
    batch = {"input_ids": np.random.RandomState(1).randint(0, TINY["vocab_size"],
                                                           size=(4, 32))}
    np.testing.assert_allclose(peng.train_batch(batch=batch).item(),
                               float(jeng.train_batch(batch=batch)), rtol=1e-5)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, atol=2e-5),
                 params_to_numpy(peng.params), jax.tree.map(np.asarray, jeng.state.params))
