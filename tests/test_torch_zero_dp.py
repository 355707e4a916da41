"""ZeRO stages 1 and 2 over data-parallel ranks: ``deepspeed_tpu_torch.initialize``
with ``zero_optimization.stage`` 1 or 2 on one gloo world of 2 spawned CPU
ranks (``launcher.launch_local``; every case runs in that one launch), against
the JAX package's ``TpuEngine`` at dp=2 on the CPU mesh from the same masters
(``params_from_numpy``), and against the port's stage 0 over the same world.
llama-tiny (``torch_bridge.TINY``) at S=64, batch 4, fp32, AdamW with weight
decay, clipping 1.0, the JAX "auto" knobs pinned.

- Stages 1 and 2 against TpuEngine's: losses and the last grad norm rtol 1e-5,
  the masters after three steps atol 5e-5 (``test_torch_sequence_parallel.py``'s
  bounds: the ranks' gradient sum reorders a near-zero element's noise).
- Inside the port, stage 1 is stage 0 bit for bit (AdamW, lion, sgd with
  momentum, adagrad: each update is elementwise on a part), and so is stage
  2 with clipping off (a sum of two terms is the same in either order), with
  one accumulation step and with two. With clipping on, stage 2's norm sums
  the parts' squares in another order: its masters are held within 1e-6 of
  stage 0's (measured 7.45e-9). Lamb's trust ratio sums the parts' squares
  over the ranks too: stages 1 and 2 within 1e-6 of stage 0 (measured
  5.96e-8), losses rtol 1e-5.
- ``state_bytes()``: the moments split over the ranks at stage 1, and the
  gradients too at stage 2.
- The partition plan alone, without a world: the rows and flat layouts, each
  part one contiguous 16-byte aligned run, the replicated leaves.
- ``comm.reduce_scatter`` and ``all_gather`` on the world; the refusals,
  each matched by its message.
- Checkpoints, saved whole by rank 0: stage 2 resumes bitwise on the same
  world, and loads at stage 0 on one rank; stage 1 loads in JAX's legacy
  ``runtime/checkpointing.py:load_checkpoint`` (``TpuEngine.load_checkpoint``
  is red on this jax); a stage-2 dp=2 ``TpuEngine``'s checkpoint written by
  that module (two rectangles a moment) loads into the port at stage 2.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.topology import MeshTopology, ParallelDims
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.runtime import checkpointing as jax_ckpt
from deepspeed_tpu_torch.config import DeepSpeedConfigError
from deepspeed_tpu_torch.launcher import launch_local
from deepspeed_tpu_torch.models import TransformerModel
from deepspeed_tpu_torch.models.mixtral import mixtral_config
from deepspeed_tpu_torch.models.transformer import param_specs
from deepspeed_tpu_torch.runtime import checkpointing as ckpt
from deepspeed_tpu_torch.runtime.zero import ZeroPartition, leaf_shard, shard_plan
from deepspeed_tpu_torch.utils.tree import tree_leaves

import torch_sp_worker
from torch_bridge import TINY, port_config

S = 64
LOSS_RTOL, PARAM_ATOL = 1e-5, 5e-5
SUM_ORDER_ATOL = 1e-6  # stage 0 against a norm summed over the ranks' parts
OPTIMIZERS = {
    "adamw": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.01}},
    "lion": {"type": "lion", "params": {"lr": 1e-3, "weight_decay": 0.1, "betas": [0.9, 0.99]}},
    "sgd": {"type": "sgd", "params": {"lr": 1e-2, "weight_decay": 0.1, "momentum": 0.9}},
    "adagrad": {"type": "adagrad", "params": {"lr": 1e-2, "weight_decay": 0.1}},
    "lamb": {"type": "lamb", "params": {"lr": 1e-3, "weight_decay": 0.1, "eps": 1e-6}},
}


def _cfg(stage, opt="adamw", clip=1.0, accum=1, **zero):
    return {
        "train_batch_size": 4, "gradient_accumulation_steps": accum,
        "optimizer": OPTIMIZERS[opt], "gradient_clipping": clip, "steps_per_print": 100,
        # explicit values for the JAX engine's "auto" knobs (test_torch_training.py)
        "zero_optimization": {"stage": stage, "grad_wire": "fp32", "param_wire": "fp32",
                              **zero},
        "serving": {"moe_a2a": "stock", "kv_cache_dtype": "bf16"},
    }


def _host(tree):
    """Host copies (a view of a JAX buffer would see the next step's
    donation)."""
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def _named_jax(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(_host(tree))
    return {jax.tree_util.keystr(p): v for p, v in flat}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree)]


def _gap(a, b):
    return max(float(np.abs(x - y).max()) for x, y in zip(_leaves(a), _leaves(b)))


def _bitwise(a, b):
    return all(np.array_equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX references (a TpuEngine at stages 1 and 2 on a dp=2 mesh, 3
    steps, a fourth after; stage 2's checkpoint by JAX's legacy writer) and
    one launch of the port's world of 2 ranks running every case."""
    d = tmp_path_factory.mktemp("zero_dp")
    r = np.random.RandomState(0)
    batches = [{"input_ids": r.randint(0, TINY["vocab_size"], size=(4, S))} for _ in range(4)]
    jm = jax_llama("llama-tiny", **TINY)
    topo = MeshTopology(dims=ParallelDims(dp=2), devices=jax.devices()[:2])
    jax_runs = {}
    for stage in (1, 2):
        eng, *_ = deepspeed_tpu.initialize(model=jm, config=_cfg(stage), topology=topo,
                                           rng=jax.random.PRNGKey(0))
        tree = _host(eng.state.params)
        run = {"engine": eng, "losses": [float(eng.train_batch(batch=dict(b)))
                                         for b in batches[:3]]}
        run["norm"] = eng.get_global_grad_norm()
        run["params"] = _host(eng.state.params)
        run["state"] = {**_named_jax(eng.state.params), **_named_jax(eng.state.opt_state)}
        if stage == 2:
            jax_ckpt.save_checkpoint(eng, str(d / "jax_s2"))
        run["after"] = float(eng.train_batch(batch=dict(batches[3])))
        jax_runs[stage] = run

    fields = dataclasses.asdict(port_config(jm.config))

    def run(label, cfg, **kw):
        return {"label": label, "model": fields, "tree": tree, "config": cfg,
                "batches": batches[:3], **kw}

    after = {"after": batches[3:]}
    runs = [run("s0", _cfg(0), **after),
            run("s1", _cfg(1), save=str(d / "port_s1"), **after),
            run("s2", _cfg(2), save=str(d / "port_s2"), resume=True, **after),
            run("jax_s2", _cfg(2), load=str(d / "jax_s2"), batches=[], **after)]
    runs += [run(f"s{s} noclip a{a}", _cfg(s, clip=0.0, accum=a))
             for s in (0, 2) for a in (1, 2)]
    runs += [run("s0 parts norm", _cfg(0), parts_norm=True)]
    runs += [run(f"s{s} {opt}", _cfg(s, opt)) for opt in ("lion", "sgd", "adagrad")
             for s in (0, 1)]
    runs += [run(f"s{s} lamb", _cfg(s, "lamb")) for s in (0, 1, 2)]
    moe = {"model": dataclasses.asdict(mixtral_config("mixtral-tiny", vocab_size=256)),
           "config": {"train_batch_size": 4, "zero_optimization": {"stage": 1},
                      "moe": {"enabled": True, "ep_size": 1}}}
    ranks = launch_local(torch_sp_worker.zero_rank, 2, (runs, moe), backend="gloo")
    return {"jax": jax_runs, "ranks": ranks, "dir": d, "batches": batches,
            "fields": fields}


# ------------------------------------------------------ against TpuEngine
@pytest.mark.parametrize("stage", [1, 2])
def test_stage_matches_tpu_engine_at_dp2(world, stage):
    got, want = world["ranks"][0][f"s{stage}"], world["jax"][stage]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norms"][-1], want["norm"], rtol=LOSS_RTOL)
    for a, b in zip(_leaves(got["params"]), _leaves(want["params"])):
        np.testing.assert_allclose(a, b, atol=PARAM_ATOL)
    for r in world["ranks"]:  # every rank returns the global loss and the same masters
        assert r[f"s{stage}"]["losses"] == got["losses"]
        assert _bitwise(r[f"s{stage}"]["params"], got["params"])


# ----------------------------------------------------- inside the port
@pytest.mark.parametrize("label", ["s1", "s1 lion", "s1 sgd", "s1 adagrad",
                                   "s2 noclip a1", "s2 noclip a2"])
def test_stage_is_stage0_bitwise(world, label):
    base = {"s1": "s0", "s2 noclip a1": "s0 noclip a1",
            "s2 noclip a2": "s0 noclip a2"}.get(label, label.replace("s1", "s0"))
    for r in world["ranks"]:
        got, want = r[label], r[base]
        assert got["losses"] == want["losses"]
        assert _bitwise(got["params"], want["params"]), f"{label}: gap " \
            f"{_gap(got['params'], want['params'])}"
        assert all(np.array_equal(got["state"][n], want["state"][n]) for n in want["state"])


def test_stage2_with_clipping_within_tolerance(world):
    """The norm from the parts' square sums: the clip factor moves by
    rounding, so the masters stay within 1e-6 of stage 0's."""
    r = world["ranks"][0]
    np.testing.assert_allclose(r["s2"]["losses"], r["s0"]["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(r["s2"]["grad_norms"], r["s0"]["grad_norms"], rtol=LOSS_RTOL)
    assert _gap(r["s2"]["params"], r["s0"]["params"]) <= SUM_ORDER_ATOL


def test_stage2_with_clipping_is_stage0_with_the_parts_norm_bitwise(world):
    """The witness of that tolerance's cause: stage 0 whose clipping norm is
    summed in stage 2's order (each leaf's parts' squares, then the leaves)
    is stage 2 bit for bit, clipping on."""
    for r in world["ranks"]:
        got, want = r["s2"], r["s0 parts norm"]
        assert got["losses"] == want["losses"]
        assert got["grad_norms"] == want["grad_norms"]
        assert _bitwise(got["params"], want["params"]), \
            f"gap {_gap(got['params'], want['params'])}"


@pytest.mark.parametrize("stage", [1, 2])
def test_lamb_within_tolerance(world, stage):
    r = world["ranks"][0]
    got, want = r[f"s{stage} lamb"], r["s0 lamb"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    assert _gap(got["params"], want["params"]) <= SUM_ORDER_ATOL


def test_state_bytes_show_the_sharding(world):
    """Masters whole everywhere; the moments split over the 2 ranks from
    stage 1, the gradients the update reads from stage 2 (every leaf of
    llama-tiny splits), each read from the live tensors. At the gradient
    collective the whole gradients stand at every stage, beside the
    all-reduce's flat copy (stages 0, 1) or the reduce-scatter's [dp, part]
    input and this rank's summed parts (stage 2)."""
    shapes = [tuple(shape) for shape, _ in tree_leaves(param_specs(port_config(
        jax_llama("llama-tiny", **TINY).config)))]
    whole = 4 * sum(int(np.prod(s)) for s in shapes)
    assert all(e.sharded for e in shard_plan(shapes, 2, 0))
    for r in world["ranks"]:
        b0, b1, b2 = (r[k]["state_bytes"] for k in ("s0", "s1", "s2"))
        assert b0 == {"masters": whole, "optimizer": 2 * whole, "gradients": whole,
                      "total": 4 * whole, "gradients_transient": 2 * whole}
        assert b1 == {**b0, "optimizer": whole, "total": 3 * whole}
        assert b2 == {**b1, "gradients": whole // 2, "total": 5 * whole // 2,
                      "gradients_transient": 5 * whole // 2}


# ------------------------------------------------------------- the plan
@pytest.mark.parametrize("shape,dp,layout", [
    ((16, 2048, 8192), 2, "rows"),   # llama3-1b's stacked MLP weight
    ((128,), 8, "rows"),
    ((3, 8), 2, "flat"),             # dp does not divide the first dim
    ((6,), 2, "replicated"),         # parts of 3 elements: not 16 bytes
    ((10, 4), 4, "replicated"),
    ((), 2, "replicated"),
    ((8, 8), 1, "replicated"),       # one rank: nothing to split
])
def test_partition_plan(shape, dp, layout):
    numel = int(np.prod(shape))
    entries = [leaf_shard(shape, dp, r) for r in range(dp)]
    assert {e.layout for e in entries} == {layout}
    if layout == "replicated":
        assert all((e.start, e.size) == (0, numel) for e in entries)
        return
    small = numel <= 1 << 16  # the tensors only where they are small
    whole = torch.arange(numel, dtype=torch.float32).view(shape) if small else None
    runs = []
    for r, e in enumerate(entries):
        assert e.size == numel // dp and e.start == r * e.size and e.size % 4 == 0
        if small:
            part = e.part(whole)
            assert part.is_contiguous() and (part.storage_offset() * 4) % 16 == 0
            assert part.shape == ((shape[0] // dp, *shape[1:]) if layout == "rows"
                                  else (e.size,))
            runs.append(part.reshape(-1))
    if small:
        assert torch.equal(torch.cat(runs), whole.view(-1))


def test_partition_offsets_are_aligned():
    """One rank's parts of a tree's leaves side by side in the collectives'
    flat buffer: each starts 16-byte aligned; replicated leaves stay out."""
    part = ZeroPartition([(16, 64), (6,), (3, 8), (128,)], None)
    assert (part.dp, part.sharded, part.replicated) == (1, [], [0, 1, 2, 3])
    plan = shard_plan([(16, 64), (6,), (3, 8), (128,)], 2, 1)
    assert [e.layout for e in plan] == ["rows", "replicated", "flat", "rows"]
    offsets, o = [], 0
    for e in plan:
        if e.sharded:
            offsets.append(o)
            o += e.size
    assert offsets == [0, 512, 524] and all(x % 4 == 0 for x in offsets)


# ---------------------------------------------------------- refusals
@pytest.mark.parametrize("zero,extra,match", [
    ({"stage": 3, "param_wire": "int8"}, {}, "param_wire int8 \\(item 7.2c"),
    ({"stage": 2, "offload_optimizer": {"device": "cpu"}}, {},
     "offload, NVMe included \\(item 7\\) over 2 ranks.*item 7.2c"),
    ({"stage": 1, "offload_optimizer": {"device": "nvme", "nvme_path": "/nonexistent"}}, {},
     "offload, NVMe included \\(item 7\\) over 2 ranks"),
    ({"stage": 1}, {"sequence_parallel": {"sp_size": 2, "mode": "ring"}},
     "ZeRO stage 1 \\(item 7\\) with sequence parallelism.*item 7.2c"),
    ({"stage": 2, "grad_wire": "int8"}, {}, "grad_wire int8 \\(item 7.2c"),
    ({"stage": 1, "grad_wire": "bf16"}, {}, "grad_wire bf16 \\(item 7.2c"),
    ({"stage": 3}, {"sequence_parallel": {"sp_size": 2, "mode": "ulysses"}},
     "ZeRO stage 3 \\(item 7\\) with sequence parallelism.*item 7.2c"),
    ({"stage": 3, "offload_param": {"device": "cpu"}}, {},
     "offload, NVMe included \\(item 7\\) over 2 ranks.*item 7.2c"),
    # hpZ / MiCS: the JAX package builds a dp x fsdp topology (fault C1)
    ({"stage": 3, "zero_hpz_partition_size": 2}, {},
     "zero_hpz_partition_size 2 / mics_shard_size -1 over 2 ranks \\(item 7.2c\\)"),
    ({"stage": 3, "mics_shard_size": 2}, {},
     "zero_hpz_partition_size 1 / mics_shard_size 2 over 2 ranks \\(item 7.2c\\)"),
])
def test_still_refused_over_ranks(monkeypatch, zero, extra, match):
    monkeypatch.setenv("WORLD_SIZE", "2")
    model = TransformerModel(port_config(jax_llama("llama-tiny", **TINY).config))
    cfg = {**_cfg(0), **extra}
    cfg["zero_optimization"] = zero
    with pytest.raises(NotImplementedError, match=match):
        deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")


@pytest.mark.parametrize("zero,match", [
    ({"stage": 2, "param_wire": "int8"}, "param_wire requires ZeRO stage 3"),
    ({"stage": 1, "zero_quantized_gradients": True}, "require stage 3"),
    ({"stage": 0, "grad_wire": "int8"}, "grad_wire requires ZeRO stage >= 1"),
    ({"stage": 1, "grad_wire": "fp8"}, "grad_wire must be one of"),
])
def test_wire_config_errors_as_jax(zero, match):
    """The wire knobs are read and checked as JAX's ``ZeroConfig.validate``
    checks them."""
    from deepspeed_tpu.config import DeepSpeedConfig as JaxConfig
    from deepspeed_tpu.config import DeepSpeedConfigError as JaxConfigError

    cfg = {**_cfg(0), "zero_optimization": zero}
    with pytest.raises(DeepSpeedConfigError, match=match):
        deepspeed_tpu_torch.config.DeepSpeedConfig(cfg)
    with pytest.raises(JaxConfigError):
        JaxConfig(cfg)


def test_collectives_over_the_world(world):
    """``comm.reduce_scatter`` (JAX ``reduce_scatter``: tiled, summed) and the
    one-call ``all_gather`` along dim 1 on the gloo world of 2; a size the
    group does not divide is refused."""
    xs = [np.arange(24.0).reshape(4, 6) + 100.0 * r for r in range(2)]
    total = xs[0] + xs[1]
    for r, got in enumerate(world["ranks"]):
        c = got["collectives"]
        np.testing.assert_array_equal(c["reduce_scatter"], total[:, 3 * r:3 * r + 3])
        np.testing.assert_array_equal(c["all_gather"], np.concatenate(xs, axis=1))
        assert "does not split over 2 members" in c["refused"]


def test_moe_over_ranks_refused(world):
    for r in world["ranks"]:
        assert r["moe"] is not None and "MoE model on one rank" in r["moe"] \
            and "item 7.2c" in r["moe"]


# --------------------------------------------------------- checkpoints
def test_stage2_checkpoint_resumes_bitwise(world):
    for r in world["ranks"]:
        s2 = r["s2"]
        assert s2["resumed"] == s2["after"]
        assert _bitwise(s2["resumed_params"], s2["final"])
        assert s2["resumed_state"].keys() == s2["state"].keys()
        assert all(np.array_equal(s2["resumed_state"][n], v) for n, v in s2["state"].items())
    meta = json.loads((world["dir"] / "port_s2/global_step3/metadata.json").read_text())
    assert (meta["zero_stage"], meta["world_size"]) == (2, 2)
    files = ckpt._index_shard_files(str(world["dir"] / "port_s2/global_step3/opt_state"))
    assert all(len(v) == 1 for v in files.values())  # whole leaves


@pytest.mark.parametrize("stage", [1, 2])
def test_save_gathers_one_moment_leaf_at_a_time(world, stage):
    """Every rank takes part in each sharded moment leaf's gather, and holds
    one gathered leaf at a time: the save never gathers the whole state."""
    n_sharded = sum(e.sharded for e in shard_plan(
        [tuple(shape) for shape, _ in tree_leaves(param_specs(port_config(
            jax_llama("llama-tiny", **TINY).config)))], 2, 0))
    for r in world["ranks"]:
        assert r[f"s{stage}"]["save_gathers"] == (2 * n_sharded, 1)  # AdamW's mu and nu


def test_stage2_checkpoint_loads_at_stage0_on_one_rank(world):
    model = TransformerModel(port_config(jax_llama("llama-tiny", **TINY).config))
    eng, *_ = deepspeed_tpu_torch.initialize(model=model, config=_cfg(0), device="cpu",
                                             rng=torch.Generator().manual_seed(5))
    eng.load_checkpoint(str(world["dir"] / "port_s2"))
    want = world["ranks"][0]["s2"]
    got = {n: (t.detach().numpy() if torch.is_tensor(t) else np.asarray(t))
           for comp in ("params", "opt_state") for n, t in eng.checkpoint_components()[comp]}
    assert got.keys() == want["state"].keys()
    assert all(np.array_equal(got[n], v) for n, v in want["state"].items())
    loss = eng.train_batch(batch=world["batches"][3]).item()
    np.testing.assert_allclose(loss, want["after"], rtol=LOSS_RTOL)


def test_stage1_checkpoint_loads_in_jax_legacy_loader(world):
    jeng = world["jax"][1]["engine"]
    jax_ckpt.load_checkpoint(jeng, str(world["dir"] / "port_s1"))
    assert (jeng.global_steps, int(jeng.state.step)) == (3, 3)
    want = world["ranks"][0]["s1"]
    got = {**_named_jax(jeng.state.params), **_named_jax(jeng.state.opt_state)}
    for name, arr in want["state"].items():
        assert np.array_equal(got[name], arr), name
    loss = float(jeng.train_batch(batch=dict(world["batches"][3])))
    np.testing.assert_allclose(loss, want["after"], rtol=LOSS_RTOL)


def test_jax_legacy_checkpoint_loads_at_stage2(world):
    """JAX's writer saved each moment of its stage-2 dp=2 engine as two
    rectangles; the port's ranks each keep their part of the assembled leaf."""
    files = ckpt._index_shard_files(str(world["dir"] / "jax_s2/global_step3/opt_state"))
    assert max(len(v) for v in files.values()) == 2
    want = world["jax"][2]
    for r in world["ranks"]:
        got = r["jax_s2"]
        assert got["state"].keys() == want["state"].keys()
        assert all(np.array_equal(got["state"][n], v) for n, v in want["state"].items())
        np.testing.assert_allclose(got["after"], [want["after"]], rtol=LOSS_RTOL)
