"""fp16 with the dynamic loss scaler over data-parallel ranks: ZeRO stages 1, 2
and 3 (``stage3_param_persistence_threshold`` 0) on one gloo world of 2
spawned CPU ranks (``launcher.launch_local``; every case runs in that one
launch), against the JAX package's ``TpuEngine`` in fp16 on a dp=2 CPU mesh
from the same masters. llama-tiny (``torch_bridge.TINY``) at S=64, batch 4,
AdamW with weight decay, clipping 1.0, the JAX "auto" knobs pinned.

- Power 30 (every step overflows: the hysteresis, then the halvings) and
  power 16 with window 2 (the scale grows, no step overflows), 3 steps, at
  each stage: the scale, ``skipped_steps``, ``global_steps`` and the lr equal
  TpuEngine's every step, on both ranks, and the unscaled gradients' norm
  within rtol 3e-4 of TpuEngine's on an applied step (measured 4.1e-5 at
  the first step, from the same masters, and 1.42e-4 at the third, after
  Adam's fp16 drift of the masters; a wrong 1/scale is a factor of 2**16)
  and not finite on both sides on a skipped one. Against TpuEngine at the
  same stage (stage 1 and stage 3 at power 16, stage 2 at power 30): the
  losses within rtol 1e-4 and the masters within
  ``tests/test_torch_fp16.py``'s Adam bounds (atol 2e-3, measured 1.44e-3
  where the largest update is 3.0e-3; the update within 2e-2 in relative
  L2, measured 6.9e-3).
- On a skipped step both ranks' parts (masters and optimizer state as each
  holds them) stay bitwise as they were; no all-gather changes them.
- An inf in one rank's gradient part only (stage 2; the other rank's parts
  all finite): the overflow flag is reduced over the world, so both ranks
  skip that step, and the scale moves alike.
- Stage 3 gathers each layer in fp16, the compute dtype, through gloo (the
  prefetch's asynchronous gathers too, the same bits): bitwise stage 0 in
  fp16 at clip 0, within the fp16 bounds with clipping (the norm's order);
  gloo takes fp16 in the all-gather, blocking and asynchronous.

About 40-50 s in one process.
"""

import dataclasses

import jax
import numpy as np
import pytest

import deepspeed_tpu
from deepspeed_tpu.comm.topology import MeshTopology, ParallelDims
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu_torch.launcher import launch_local

import torch_sp_worker
from torch_bridge import TINY, port_config

S = 64
LOSS_RTOL, GRAD_NORM_RTOL, MASTER_ATOL, UPDATE_RTOL = 1e-4, 3e-4, 2e-3, 2e-2
STEPS = 3


def _cfg(stage, power, window=1000, clip=1.0, **zero):
    z = {"stage": stage, "grad_wire": "fp32", "param_wire": "fp32",
         "stage3_param_persistence_threshold": 0, **zero}
    return {
        "train_batch_size": 4,
        # eps 1e-6 (tests/test_torch_moe_training.py's reason): at Adam's 1e-8
        # one near-cancelled element moved 3.1e-3 from JAX's in 3 steps
        "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.01,
                                                  "eps": 1e-6}},
        "gradient_clipping": clip, "steps_per_print": 100,
        "fp16": {"enabled": True, "initial_scale_power": power, "loss_scale_window": window},
        "zero_optimization": z,
        "serving": {"moe_a2a": "stock", "kv_cache_dtype": "bf16"},
    }


POWERS = {16: 2, 30: 1000}  # initial_scale_power: loss_scale_window
JAX_LEGS = ((1, 16), (2, 30), (3, 16))  # (stage, power) of the TpuEngine references


def _host(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree)]


def _same_records(got, want):
    return len(got) == len(want) and all(
        tuple(g[:3]) == tuple(w[:3]) and g[3] == pytest.approx(w[3], rel=1e-6)
        for g, w in zip(got, want))


@pytest.fixture(scope="module")
def world():
    r = np.random.RandomState(0)
    batches = [{"input_ids": r.randint(0, TINY["vocab_size"], size=(4, S))}
               for _ in range(STEPS)]
    jm = jax_llama("llama-tiny", **TINY)
    topo = MeshTopology(dims=ParallelDims(dp=2), devices=jax.devices()[:2])
    jax_runs = {}
    for stage, power in JAX_LEGS:
        eng, *_ = deepspeed_tpu.initialize(model=jm, config=_cfg(stage, power, POWERS[power]),
                                           topology=topo, rng=jax.random.PRNGKey(0))
        tree = _host(eng.state.params)
        run = {"m0": tree, "losses": [], "records": [], "norms": []}
        for b in batches:
            run["losses"].append(float(eng.train_batch(batch=dict(b))))
            run["norms"].append(float(eng._metrics["grad_norm"]))
            run["records"].append((float(eng.loss_scale), eng.skipped_steps, eng.global_steps,
                                   float(eng.lr)))
        run["params"] = _host(eng.state.params)
        jax_runs[(stage, power)] = run
    fields = dataclasses.asdict(port_config(jm.config))

    def run(label, cfg, **kw):
        return {"label": label, "model": fields, "tree": tree, "config": cfg,
                "batches": batches, **kw}

    runs = [run(f"s{s} p{p}", _cfg(s, p, POWERS[p])) for s in (1, 2, 3) for p in POWERS]
    runs += [run("s0 p16", _cfg(0, 16, 2)),
             run("s0 p16 noclip", _cfg(0, 16, 2, clip=0.0)),
             run("s3 p16 noclip", _cfg(3, 16, 2, clip=0.0)),
             run("s3 p16 prefetch", _cfg(3, 16, 2, stage3_layer_prefetch=True)),
             run("s2 p16 inf on rank 0", _cfg(2, 16, 2), poison=(0, 2))]
    ranks = launch_local(torch_sp_worker.fp16_rank, 2, (runs,), backend="gloo")
    return {"jax": jax_runs, "ranks": ranks}


@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("power", [16, 30])
def test_scale_trajectory_matches_tpu_engine(world, stage, power):
    """The same scale, skips, steps and lr every step, on both ranks, as
    TpuEngine's at that power, and the same gradient norms (TpuEngine's at
    that stage where it ran, else at that power: every stage sees the same
    gradients)."""
    jax_run = world["jax"].get((stage, power)) or next(
        r for (s, p), r in world["jax"].items() if p == power)
    want = jax_run["records"]
    for r in world["ranks"]:
        got = r[f"s{stage} p{power}"]
        assert _same_records(got["records"], want)
        # the unscaled gradients' norm: within GRAD_NORM_RTOL on an applied
        # step, not finite on both sides on a skipped one
        g, w = np.asarray(got["norms"]), np.asarray(jax_run["norms"])
        assert np.array_equal(np.isfinite(g), np.isfinite(w))
        np.testing.assert_allclose(g[np.isfinite(w)], w[np.isfinite(w)], rtol=GRAD_NORM_RTOL)
        assert got["overflow"] == [power == 30] * STEPS
        # a skipped step leaves this rank's parts bitwise as they were
        assert all(u for u, o in zip(got["unchanged"], got["overflow"]) if o)
        assert not any(u for u, o in zip(got["unchanged"], got["overflow"]) if not o)


@pytest.mark.parametrize("stage,power", JAX_LEGS)
def test_losses_and_masters_match_tpu_engine(world, stage, power):
    want = world["jax"][(stage, power)]
    got = world["ranks"][0][f"s{stage} p{power}"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    for r in world["ranks"]:  # every rank: the global loss, the same masters
        assert r[f"s{stage} p{power}"]["losses"] == got["losses"]
    if power == 30:  # every step skipped: the first masters, bitwise
        for a, b in zip(_leaves(got["params"]), _leaves(want["m0"])):
            np.testing.assert_array_equal(a, b)
        return
    num = den = 0.0
    for a, w, m in zip(_leaves(got["params"]), _leaves(want["params"]), _leaves(want["m0"])):
        np.testing.assert_allclose(a, w, atol=MASTER_ATOL)
        num, den = num + float(np.sum((a - w) ** 2)), den + float(np.sum((w - m) ** 2))
    assert (num / den) ** 0.5 <= UPDATE_RTOL


def test_inf_in_one_ranks_part_skips_both(world):
    """Rank 0's part of a gradient holds an inf at step 2, rank 1's parts are
    finite: both ranks skip that step (the flag is the world's max), their
    parts stay as they were, and the scale and counts agree; the other steps
    update."""
    runs = [r["s2 p16 inf on rank 0"] for r in world["ranks"]]
    for got in runs:
        assert got["overflow"] == [False, True, False]
        assert got["unchanged"] == [False, True, False]
        assert got["records"][1][:3] == (65536.0, 1, 2)
    assert runs[0]["records"] == runs[1]["records"]
    for a, b in zip(_leaves(runs[0]["params"]), _leaves(runs[1]["params"])):
        np.testing.assert_array_equal(a, b)


def test_stage3_gathers_fp16(world):
    """Stage 3's layer gathers move fp16 through gloo (and the table's, the
    head's and the norms' whole gathers fp32, as in bf16); the prefetch's
    asynchronous gathers give the same bits; stage 3 is stage 0 in fp16 bit
    for bit at clip 0, and within the fp16 bounds with clipping (the norm
    sums the parts' squares in another order: the clip factor moves by an
    ulp, and fp16 rounding of the next steps' activations carries that to
    1.27e-3 on one element in 3 steps at eps 1e-8, measured); gloo's
    all-gather takes fp16, blocking and asynchronous."""
    for rank, r in enumerate(world["ranks"]):
        s3, pre, s0 = r["s3 p16"], r["s3 p16 prefetch"], r["s0 p16"]
        assert "torch.float16" in s3["gathered"] and "torch.float16" in pre["gathered"]
        assert s0["gathered"] == []
        assert s3["losses"] == pre["losses"] and s3["records"] == pre["records"]
        for a, b in zip(_leaves(s3["params"]), _leaves(pre["params"])):
            np.testing.assert_array_equal(a, b)
        a, b = r["s3 p16 noclip"], r["s0 p16 noclip"]
        assert a["losses"] == b["losses"] and a["records"] == b["records"]
        for x, y in zip(_leaves(a["params"]), _leaves(b["params"])):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_allclose(s3["losses"], s0["losses"], rtol=LOSS_RTOL)
        assert s3["records"] == s0["records"]
        for x, y in zip(_leaves(s3["params"]), _leaves(s0["params"])):
            np.testing.assert_allclose(x, y, atol=MASTER_ATOL)
        c = r["collectives"]
        want = np.concatenate([np.arange(6, dtype=np.float16).reshape(2, 3) + 1000 * i
                               for i in range(2)])
        for name in ("all_gather", "all_gather_async"):
            assert c[name].dtype == np.float16
            np.testing.assert_array_equal(c[name], want)
