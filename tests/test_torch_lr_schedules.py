"""LR schedules: the port's host-side functions of the step count against the
JAX package's traced schedules, steps 0-59 across warmup, decay and the
cycle ends, within rtol 1e-6 or 1e-6 of the base lr: the JAX schedules
compute in fp32, the port in Python floats, and fp32's 1 + cos near the
cosine's minimum is off by up to 5e-12 (1.7e-8 of the base lr 3e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest

from deepspeed_tpu.runtime.lr_schedules import build_schedule as jax_schedule
from deepspeed_tpu_torch.runtime.lr_schedules import build_schedule

CASES = [
    (None, {}),
    ("WarmupLR", {"warmup_min_lr": 1e-5, "warmup_max_lr": 1e-3, "warmup_num_steps": 10}),
    ("WarmupLR", {"warmup_max_lr": 1e-3, "warmup_num_steps": 10, "warmup_type": "linear"}),
    ("WarmupDecayLR", {"total_num_steps": 50, "warmup_max_lr": 2e-3,
                       "warmup_num_steps": 10}),
    ("WarmupCosineLR", {"total_num_steps": 50, "warmup_num_steps": 10,
                        "warmup_min_ratio": 0.1}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-3,
                  "cycle_first_step_size": 10, "cycle_second_step_size": 15,
                  "decay_step_size": 5, "decay_lr_rate": 0.1}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4, "lr_range_test_step_size": 7,
                     "lr_range_test_step_rate": 2.0, "lr_range_test_staircase": True}),
]


@pytest.mark.parametrize("name,params", CASES, ids=[
    "constant", "warmup_log", "warmup_linear", "warmup_decay", "warmup_cosine",
    "one_cycle", "range_test"])
def test_schedule_matches_jax(name, params):
    want = jax_schedule(name, params, 3e-4)
    got = build_schedule(name, params, 3e-4)
    for step in range(60):
        np.testing.assert_allclose(got(step), float(want(jnp.asarray(step, jnp.int32))),
                                   rtol=1e-6, atol=1e-6 * 3e-4)


def test_unknown_schedule_raises():
    with pytest.raises(KeyError, match="unknown scheduler"):
        build_schedule("Cyclic", {}, 1e-3)
