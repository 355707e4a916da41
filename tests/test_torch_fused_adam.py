"""Fused Adam: the port's plain update (what the CUDA kernel computes) against
the JAX package's Pallas ``_fused_adam_flat`` in interpret mode, and three
steps of the port's optimizer against ``build_optimizer(use_pallas_adam=True)``
with weight decay, a warmup schedule and a clip factor, fp32, atol 1e-6 on
m, v and the direction, 1e-7 on the parameters."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepspeed_tpu.config import OptimizerConfig as JaxOptimizerConfig
from deepspeed_tpu.ops.pallas.fused_adam import _fused_adam_flat
from deepspeed_tpu.runtime.lr_schedules import build_schedule as jax_schedule
from deepspeed_tpu.runtime.optimizers import build_optimizer as jax_build_optimizer
from deepspeed_tpu_torch.config import OptimizerConfig
from deepspeed_tpu_torch.ops.cuda.fused_adam import adam_update
from deepspeed_tpu_torch.runtime.lr_schedules import build_schedule
from deepspeed_tpu_torch.runtime.optimizers import build_optimizer


def test_plain_update_matches_pallas_kernel():
    r = np.random.RandomState(0)
    n = 128 * 8 * 3
    g, m = r.randn(n).astype(np.float32), (0.1 * r.randn(n)).astype(np.float32)
    v = (0.01 * np.abs(r.randn(n))).astype(np.float32)
    b1, b2, eps = 0.9, 0.999, 1e-8
    bc = (1 - b1 ** 3, 1 - b2 ** 3)
    out, m2, v2 = _fused_adam_flat(jnp.asarray(g), jnp.asarray(m), jnp.asarray(v),
                                   jnp.asarray(bc, jnp.float32), b1=b1, b2=b2,
                                   eps=eps, interpret=True)
    # with p = 0, lr = 1 and no decay the parameter becomes minus the direction
    p, mt, vt = torch.zeros(n), torch.from_numpy(m.copy()), torch.from_numpy(v.copy())
    adam_update(p, torch.from_numpy(g), mt, vt, lr=1.0, b1=b1, b2=b2, eps=eps,
                wd=0.0, bc1=bc[0], bc2=bc[1])
    np.testing.assert_allclose(mt.numpy(), np.asarray(m2), atol=1e-6)
    np.testing.assert_allclose(vt.numpy(), np.asarray(v2), atol=1e-6)
    np.testing.assert_allclose(-p.numpy(), np.asarray(out), atol=1e-6)


@pytest.mark.parametrize("fused", [True, False])
def test_three_steps_match_optax_chain(fused):
    params_np = {"w": np.random.RandomState(1).randn(16, 8).astype(np.float32),
                 "b": {"s": np.ones(8, np.float32)}}
    opt = {"type": "adamw", "params": {"lr": 1e-2, "weight_decay": 0.1,
                                       "betas": [0.9, 0.95]}}
    sched = ("WarmupLR", {"warmup_num_steps": 4, "warmup_type": "linear"})
    jtx = jax_build_optimizer(JaxOptimizerConfig(**opt),
                              jax_schedule(*sched, 1e-2), use_pallas_adam=True)
    tx = build_optimizer(OptimizerConfig(**opt), build_schedule(*sched, 1e-2),
                         use_fused_adam=fused)
    jparams = {"w": jnp.asarray(params_np["w"]), "b": {"s": jnp.asarray(params_np["b"]["s"])}}
    jstate = jtx.init(jparams)
    params = {"w": torch.from_numpy(params_np["w"].copy()),
              "b": {"s": torch.from_numpy(params_np["b"]["s"].copy())}}
    state = tx.init(params)
    r = np.random.RandomState(2)
    for step in range(3):
        g = {"w": r.randn(16, 8).astype(np.float32),
             "b": {"s": r.randn(8).astype(np.float32)}}
        clip = np.float32(0.5)
        jg = {"w": jnp.asarray(g["w"]) * clip, "b": {"s": jnp.asarray(g["b"]["s"]) * clip}}
        upd, jstate = jtx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tx.step(params, {"w": torch.from_numpy(g["w"]), "b": {"s": torch.from_numpy(g["b"]["s"])}},
                state, step, clip=torch.tensor(clip))
    np.testing.assert_allclose(params["w"].numpy(), np.asarray(jparams["w"]), atol=1e-7)
    np.testing.assert_allclose(params["b"]["s"].numpy(), np.asarray(jparams["b"]["s"]),
                               atol=1e-7)


def test_other_optimizers_name_the_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_optimizer(OptimizerConfig(type="onebitadam"), lambda s: 1e-3)
