"""Config: every ``examples/ds_config_*.json`` parses through both packages to
the same values in the sections the port reads (before and after the batch
triangle resolves at dp=1), and the same bad inputs raise each package's
``DeepSpeedConfigError``."""

from dataclasses import replace
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from deepspeed_tpu.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.config import DeepSpeedConfigError as JaxConfigError
from deepspeed_tpu_torch.config import DeepSpeedConfig, DeepSpeedConfigError

EXAMPLES = sorted((Path(__file__).resolve().parents[1] / "examples").glob("ds_config_*.json"))
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
          jnp.float16: torch.float16}
PORT_AUTO_DEFAULTS = ("fused_rmsnorm", "fused_adam")


def _fields(c, kernel_defaults=None):
    """The values the port reads; ``kernel_defaults`` replaces the kernel
    switches that the example leaves unset (where the two packages' defaults
    differ)."""
    kernels = c.tpu_kernels
    if kernel_defaults:
        kernels = replace(kernels, **kernel_defaults)
    return {
        "batch": (c.train_batch_size, c.train_micro_batch_size_per_gpu,
                  c.gradient_accumulation_steps),
        "logging": (c.steps_per_print, c.wall_clock_breakdown, c.seed),
        "clipping": c.gradient_clipping,
        "optimizer": (c.optimizer.type, c.optimizer.params, c.optimizer.lr,
                      c.optimizer.betas, c.optimizer.eps, c.optimizer.weight_decay),
        "scheduler": (c.scheduler.type, c.scheduler.params),
        "fp16": (c.fp16.enabled, c.fp16.loss_scale, c.fp16.initial_scale_power,
                 c.fp16.loss_scale_window, c.fp16.hysteresis, c.fp16.min_loss_scale),
        "bf16": (c.bf16.enabled, c.bf16.accumulate_grads_in_fp32),
        "zero_stage": c.zero_config.stage,
        "remat": c.activation_checkpointing.policy,
        "kernels": (kernels.flash_attention, kernels.fused_rmsnorm, kernels.fused_adam,
                    kernels.fused_ce, kernels.ce_chunk),
    }


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_examples_parse_alike(path):
    jc, pc = JaxConfig(str(path)), DeepSpeedConfig(str(path))
    # the port defaults the RMSNorm and Adam kernels to "auto" (on for a
    # CUDA device), the JAX package to off; a value the example sets agrees
    unset = [k for k in PORT_AUTO_DEFAULTS if k not in (jc.raw.get("tpu_kernels") or {})]
    assert _fields(pc) == _fields(jc, {k: "auto" for k in unset})
    assert pc.compute_dtype == DTYPES[jc.compute_dtype]
    assert pc.raw == jc.raw
    for on in (False, True):
        res, jres = pc.tpu_kernels.resolve(on), jc.tpu_kernels.resolve(on)
        jres = replace(jres, **{k: on for k in unset})
        assert (res.flash_attention, res.fused_rmsnorm, res.fused_adam, res.fused_ce) == \
            (jres.flash_attention, jres.fused_rmsnorm, jres.fused_adam, jres.fused_ce)
    if jc.train_batch_size is not None:
        jc.resolve_batch_sizes(1)
        pc.resolve_batch_sizes(1)
        assert _fields(pc)["batch"] == _fields(jc)["batch"]


def test_kernel_switches_default_auto():
    kernels = DeepSpeedConfig({}).tpu_kernels
    assert all(getattr(kernels, k) == "auto" for k in
               ("flash_attention", "fused_rmsnorm", "fused_adam", "fused_ce"))
    assert kernels.resolve(True).fused_adam and not kernels.resolve(False).fused_adam
    off = DeepSpeedConfig({"tpu_kernels": {"fused_rmsnorm": False,
                                           "fused_adam": False}}).tpu_kernels
    assert not off.resolve(True).fused_rmsnorm and not off.resolve(True).fused_adam


@pytest.mark.parametrize("bad", [
    {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2,
     "gradient_accumulation_steps": 3},
    {"train_batch_size": 9, "train_micro_batch_size_per_gpu": 2},
    {"train_batch_size": 9, "gradient_accumulation_steps": 2},
    {"fp16": {"enabled": True}, "bf16": {"enabled": True}},
    {"zero_optimization": {"stage": 4}},
    {"activation_checkpointing": {"policy": "everything"}},
    {"gradient_clipping": -1.0},
], ids=["triangle", "micro", "accum", "fp16+bf16", "stage", "policy", "clipping"])
def test_same_bad_inputs_raise(bad):
    with pytest.raises(JaxConfigError):
        JaxConfig(bad, dp_world_size=1)
    with pytest.raises(DeepSpeedConfigError):
        DeepSpeedConfig(bad, dp_world_size=1)


def test_every_known_policy_parses():
    for policy in ("none", "full", "nothing", "dots_saveable", "dots_flash",
                   "attn_only", "attn_mlp"):
        cfg = {"activation_checkpointing": {"policy": policy}}
        assert DeepSpeedConfig(cfg).activation_checkpointing.policy == \
            JaxConfig(cfg).activation_checkpointing.policy == policy
