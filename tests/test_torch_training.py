"""Training: ``deepspeed_tpu_torch.initialize`` → three ``train_batch`` steps on
llama-tiny (S=128, batch 4) against the JAX package's ``TpuEngine`` held to
one device, from the same masters (bridged by params_from_numpy), with AdamW
and weight decay, gradient clipping at 1.0 and a warmup schedule, with
accumulation 1 and 2, and with the kernel switches off (plain paths) and on
(the kernels' plain versions here; Pallas in interpret mode and the chunked
CE on the JAX side). Tolerances: fp32 losses rtol 1e-5 (measured at most
8.6e-8); fp32 masters after three steps atol 2e-5, 2 % of one lr-1e-3 step
(measured 1.5e-5 with the kernel switches on, 7.3e-6 off: Adam's normalised
update turns summation-order noise on a near-zero gradient into up to that,
on one element of 32768); bf16 losses rtol 1e-2 (measured at most 1.0e-5).
Inside the port, ``full`` remat equals ``none`` bitwise."""

import logging

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.topology import MeshTopology, ParallelDims
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu_torch.models import TransformerModel
from deepspeed_tpu_torch.models.convert import params_from_numpy, params_to_numpy

from torch_bridge import TINY, port_config

KERNELS_ON = {"flash_attention": True, "fused_rmsnorm": True, "fused_adam": True,
              "fused_ce": True, "ce_chunk": 100}  # V=256: two chunks and a tail


def _cfg(dtype, accum, kernels, **extra):
    return {
        "train_batch_size": 4, "gradient_accumulation_steps": accum,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_num_steps": 3, "warmup_type": "linear"}},
        "gradient_clipping": 1.0, "steps_per_print": 100,
        "bf16": {"enabled": dtype == "bf16"},
        "tpu_kernels": KERNELS_ON if kernels else {},
        # explicit values for the JAX engine's "auto" knobs: nothing for its
        # resolver to look up in the measured-defaults table
        "zero_optimization": {"stage": 0, "grad_wire": "fp32", "param_wire": "fp32"},
        "serving": {"moe_a2a": "stock", "kv_cache_dtype": "bf16"},
        **extra,
    }


def _batches(n=3, seed=0):
    r = np.random.RandomState(seed)
    return [{"input_ids": r.randint(0, TINY["vocab_size"], size=(4, 128))}
            for _ in range(n)]


def _jax_engine(cfg):
    jm = jax_llama("llama-tiny", **TINY)
    topo = MeshTopology(dims=ParallelDims(), devices=jax.devices()[:1])
    eng, *_ = deepspeed_tpu.initialize(model=jm, config=dict(cfg), topology=topo,
                                       rng=jax.random.PRNGKey(0))
    return eng


def _port_engine(cfg, jax_engine):
    pm = TransformerModel(port_config(jax_engine.model.config))
    tree = jax.tree.map(np.asarray, jax_engine.state.params)
    eng, opt, loader, sched = deepspeed_tpu_torch.initialize(
        model=pm, config=dict(cfg), model_parameters=params_from_numpy(pm.config, tree),
        device="cpu")
    assert opt is eng and loader is None and sched is eng.lr_scheduler
    return eng


@pytest.mark.parametrize("dtype,accum,kernels", [
    ("fp32", 1, False), ("fp32", 2, True), ("bf16", 2, False), ("bf16", 1, True),
])
def test_three_steps_match_tpu_engine(dtype, accum, kernels):
    cfg = _cfg(dtype, accum, kernels)
    jeng = _jax_engine(cfg)
    peng = _port_engine(cfg, jeng)
    assert peng.tpu_kernels.fused_adam == kernels
    jl, pl = [], []
    for batch in _batches():
        jl.append(float(jeng.train_batch(batch=batch)))
        loss = peng.train_batch(batch=batch)
        assert isinstance(loss, torch.Tensor)
        pl.append(loss.item())
    assert (peng.global_steps, peng.micro_steps) == (3, 3 * accum)
    assert peng.get_lr() == pytest.approx(jeng.get_lr(), rel=1e-6)
    if dtype == "bf16":
        np.testing.assert_allclose(pl, jl, rtol=1e-2)
        return
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    np.testing.assert_allclose(peng.get_global_grad_norm(), jeng.get_global_grad_norm(),
                               rtol=1e-4)
    want = jax.tree.map(np.asarray, jeng.state.params)
    got = params_to_numpy(peng.params)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, atol=2e-5), got, want)


def test_eval_batch_matches_tpu_engine():
    cfg = _cfg("fp32", 1, False)
    jeng = _jax_engine(cfg)
    peng = _port_engine(cfg, jeng)
    batch = _batches(1, seed=1)[0]
    np.testing.assert_allclose(peng.eval_batch(batch=batch).item(),
                               float(jeng.eval_batch(batch=batch)), rtol=1e-5)


def test_full_remat_equals_none_bitwise():
    cfg = _cfg("bf16", 2, True)
    jeng = _jax_engine(cfg)
    runs = []
    for policy in ("none", "full"):
        eng = _port_engine({**cfg, "activation_checkpointing": {"policy": policy}}, jeng)
        losses = [eng.train_batch(batch=b) for b in _batches(2)]
        runs.append((losses, params_to_numpy(eng.params)))
    (l0, p0), (l1, p1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    jax.tree.map(np.testing.assert_array_equal, p0, p1)


def test_data_iter_and_labels():
    """``data_iter`` feeds the next batch; explicit labels (ignored tokens
    included) are used as given."""
    cfg = _cfg("fp32", 1, False)
    peng = _port_engine(cfg, _jax_engine(cfg))
    batches = _batches(2, seed=2)
    ids = batches[1]["input_ids"]
    labels = np.concatenate([ids[:, 1:], np.full((4, 1), -100)], axis=1)
    labels[:, :7] = -100
    losses = [peng.train_batch(data_iter=iter(batches[:1])),
              peng.train_batch(batch={"input_ids": ids, "labels": labels})]
    assert all(np.isfinite(x.item()) for x in losses)
    with pytest.raises(ValueError, match="train_batch_size"):
        peng.train_batch(batch={"input_ids": ids[:3]})


@pytest.mark.parametrize("extra,match", [
    ({"pipeline": {"stages": 2}}, "pipeline parallelism"),
    ({"fp16": {"enabled": True}, "zero_optimization": {
        "stage": 2, "offload_optimizer": {"device": "cpu"}}}, "fp16"),
    ({"optimizer": {"type": "onebitlamb", "params": {}}}, "1-bit optimizers"),
    ({"activation_checkpointing": {"policy": "dots_flash"}}, "dots_flash"),
    ({"tensor_parallel": {"tp_size": 2}}, "tensor parallelism"),
])
def test_unported_modes_raise(extra, match):
    model = TransformerModel(port_config(jax_llama("llama-tiny", **TINY).config))
    with pytest.raises(NotImplementedError, match=match):
        deepspeed_tpu_torch.initialize(model=model, config=_cfg("fp32", 1, False, **extra),
                                       device="cpu")


def test_print_boundary_log_and_wall_clock_breakdown():
    """The loss is read on the host only at a ``steps_per_print`` boundary,
    where the log line carries it; ``wall_clock_breakdown`` adds the timers."""
    model = TransformerModel(port_config(jax_llama("llama-tiny", **TINY).config))
    cfg = {**_cfg("fp32", 1, False), "steps_per_print": 2, "wall_clock_breakdown": True}
    eng, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu",
                                             rng=torch.Generator().manual_seed(0))
    records = []
    handler = logging.Handler()
    handler.emit = lambda record: records.append(record.getMessage())
    logger = logging.getLogger("deepspeed_tpu_torch")
    logger.addHandler(handler)
    try:
        for batch in _batches(2, seed=3):
            eng.train_batch(batch=batch)
    finally:
        logger.removeHandler(handler)
    steps = [m for m in records if ": loss=" in m]
    assert len(steps) == 1 and "step 2: loss=" in steps[0]
    assert all(f"{k}=" in steps[0] for k in ("batch_prep", "step_dispatch", "step_device"))
