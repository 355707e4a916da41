"""ZeRO stage 3 over data-parallel ranks: ``deepspeed_tpu_torch.initialize`` with
``zero_optimization.stage`` 3 on one gloo world of 2 spawned CPU ranks
(``launcher.launch_local``; every case runs in that one launch), against the
JAX package's ``TpuEngine`` at stage 3 on a dp=2 CPU mesh from the same
masters, and against the port's stages 0 and 1 over the same world.
llama-tiny (``torch_bridge.TINY``) at S=64, batch 4, fp32, AdamW with weight
decay, clipping 1.0, ``stage3_param_persistence_threshold`` 0 (at the
default of 1e5 every llama-tiny leaf stays whole), the JAX "auto" knobs
pinned.

- Against TpuEngine at stage 3, ``stage3_layer_prefetch`` off and on: losses
  and the last grad norm rtol 1e-5, the masters after three steps atol 5e-5
  (``test_torch_zero_dp.py``'s bounds).
- Inside the port: stage 3 at clip 0 and one accumulation step is stage 0 bit
  for bit, and so is ``gpt2-tiny`` (a tied head: the token table gathered
  for the lookup and for the head, biases, learned positions); the prefetch
  on is the prefetch off bit for bit; with clipping the norm sums the parts'
  squares in another order (the witness, stage 0 with its norm summed in
  stage 3's order, is stage 3 bit for bit), and with two accumulation steps
  each micro-batch's layer gradient is reduce-scattered before the sum: both
  within 1e-6 of stage 0; at the default threshold (every leaf persistent)
  stage 3 is stage 1 bit for bit.
- Memory: ``state_bytes()`` is the plan's (masters, moments and gradients
  split); at 6 layers and remat ``none`` the gather scope's counter shows at
  most 2 layers' gathered slices alive in backward (3 with the prefetch).
- The stage-3 plan alone, without a world.
- Checkpoints: a stage-3 checkpoint resumes bitwise on the same world and
  loads at stage 0 on one rank; a stage-3 dp=2 ``TpuEngine``'s checkpoint
  written by JAX's legacy ``runtime/checkpointing.py`` loads into the port at
  stage 3; ``save_16bit_model`` at stage 3 writes stage 0's file byte for
  byte; ``zero.GatheredParameters`` yields stage 0's masters.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.topology import MeshTopology, ParallelDims
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.runtime import checkpointing as jax_ckpt
from deepspeed_tpu_torch.launcher import launch_local
from deepspeed_tpu_torch.models import TransformerModel
from deepspeed_tpu_torch.models.convert import params_to_numpy
from deepspeed_tpu_torch.models.transformer import param_specs
from deepspeed_tpu_torch.runtime.zero import LeafShard, ZeroPartition, stage3_plan
from deepspeed_tpu_torch.utils.tree import tree_items

import torch_sp_worker
from torch_bridge import TINY, family_pair, port_config

S = 64
LOSS_RTOL, PARAM_ATOL = 1e-5, 5e-5
SUM_ORDER_ATOL = 1e-6  # stage 0 against another order of the same sums
MEMORY_LAYERS = 6


def _cfg(stage, clip=1.0, accum=1, threshold=0, **zero):
    z = {"stage": stage, "grad_wire": "fp32", "param_wire": "fp32", **zero}
    if threshold is not None:
        z["stage3_param_persistence_threshold"] = threshold
    return {
        "train_batch_size": 4, "gradient_accumulation_steps": accum,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.01}},
        "gradient_clipping": clip, "steps_per_print": 100,
        "zero_optimization": z,
        "serving": {"moe_a2a": "stock", "kv_cache_dtype": "bf16"},
    }


def _host(tree):
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


def _tiny_shapes(**over):
    cfg = port_config(jax_llama("llama-tiny", **{**TINY, **over}).config)
    return [(n, tuple(shape)) for n, (shape, _) in tree_items(param_specs(cfg))]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX references (a TpuEngine at stage 3 on a dp=2 mesh, the
    prefetch off and on, 3 steps, a fourth after; the prefetch-off engine's
    checkpoint by JAX's legacy writer) and one launch of the port's world of
    2 ranks running every case."""
    d = tmp_path_factory.mktemp("zero3")
    r = np.random.RandomState(0)
    batches = [{"input_ids": r.randint(0, TINY["vocab_size"], size=(4, S))} for _ in range(4)]
    jm = jax_llama("llama-tiny", **TINY)
    topo = MeshTopology(dims=ParallelDims(dp=2), devices=jax.devices()[:2])
    jax_runs = {}
    for prefetch in (False, True):
        eng, *_ = deepspeed_tpu.initialize(
            model=jm, config=_cfg(3, stage3_layer_prefetch=prefetch), topology=topo,
            rng=jax.random.PRNGKey(0))
        tree = _host(eng.state.params)
        run = {"losses": [float(eng.train_batch(batch=dict(b))) for b in batches[:3]]}
        run["norm"] = eng.get_global_grad_norm()
        run["params"] = _host(eng.state.params)
        if not prefetch:
            run["state"] = {**_named_jax(eng.state.params), **_named_jax(eng.state.opt_state)}
            jax_ckpt.save_checkpoint(eng, str(d / "jax_s3"))
            run["after"] = float(eng.train_batch(batch=dict(batches[3])))
        jax_runs[prefetch] = run

    fields = dataclasses.asdict(port_config(jm.config))
    deep = {**fields, "num_layers": MEMORY_LAYERS}
    _, _, gpt2, gpt2_tree = family_pair("gpt2")
    gpt2_run = {"model": dataclasses.asdict(gpt2.config),
                "tree": params_to_numpy(gpt2_tree)}

    def run(label, cfg, **kw):
        return {"label": label, "model": fields, "tree": tree, "config": cfg,
                "batches": batches[:3], **kw}

    after = {"after": batches[3:]}
    runs = [run("s0", _cfg(0), **after),
            run("s3", _cfg(3), save=str(d / "port_s3"), resume=True, **after),
            run("s3 prefetch", _cfg(3, stage3_layer_prefetch=True)),
            run("jax_s3", _cfg(3), load=str(d / "jax_s3"), batches=[], **after),
            run("s0 parts3", _cfg(0), parts_norm=0),
            run("s0 noclip", _cfg(0, clip=0.0), save16=str(d / "s0_16")),
            run("s3 noclip", _cfg(3, clip=0.0), save16=str(d / "s3_16"), gathered=True),
            run("s0 noclip a2", _cfg(0, clip=0.0, accum=2)),
            run("s3 noclip a2", _cfg(3, clip=0.0, accum=2)),
            run("s1 default", _cfg(1, threshold=None)),
            run("s3 default", _cfg(3, threshold=None)),
            run("gpt2 s0", _cfg(0, clip=0.0), **gpt2_run),
            run("gpt2 s3", _cfg(3, clip=0.0), **gpt2_run),
            run("deep s3", _cfg(3), model=deep, tree=None, batches=batches[:1]),
            run("deep s3 prefetch", _cfg(3, stage3_layer_prefetch=True), model=deep,
                tree=None, batches=batches[:1])]
    ranks = launch_local(torch_sp_worker.zero3_rank, 2, (runs,), backend="gloo")
    return {"jax": jax_runs, "ranks": ranks, "dir": d, "batches": batches}


# ------------------------------------------------------ against TpuEngine
@pytest.mark.parametrize("prefetch", [False, True])
def test_stage3_matches_tpu_engine_at_dp2(world, prefetch):
    label = "s3 prefetch" if prefetch else "s3"
    got, want = world["ranks"][0][label], world["jax"][prefetch]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norms"][-1], want["norm"], rtol=LOSS_RTOL)
    for a, b in zip(_leaves(got["params"]), _leaves(want["params"])):
        np.testing.assert_allclose(a, b, atol=PARAM_ATOL)
    for r in world["ranks"]:  # every rank returns the global loss and the same masters
        assert r[label]["losses"] == got["losses"]
        assert _bitwise(r[label]["params"], got["params"])


# ----------------------------------------------------- inside the port
@pytest.mark.parametrize("label,base,same_norm", [
    ("s3 noclip", "s0 noclip", False),   # clip 0, one micro-batch: stage 0's sums
    ("s3 prefetch", "s3", True),         # the prefetch moves the same bytes earlier
    ("s3", "s0 parts3", True),           # clipping: the witness of stage 3's norm order
    ("s3 default", "s1 default", True),  # every leaf persistent: stage 1
    ("gpt2 s3", "gpt2 s0", False),       # tied head, biases, learned positions
])
def test_stage3_bitwise(world, label, base, same_norm):
    """Losses, masters, moments and the eval loss bit for bit; the reported
    grad norm too where both sum it in one order (at clip 0 it steers
    nothing, and stage 3 sums its parts' squares)."""
    for r in world["ranks"]:
        got, want = r[label], r[base]
        assert got["losses"] == want["losses"]
        if same_norm:
            assert got["grad_norms"] == want["grad_norms"]
        np.testing.assert_allclose(got["grad_norms"], want["grad_norms"], rtol=LOSS_RTOL)
        assert _bitwise(got["params"], want["params"]), f"{label}: gap " \
            f"{_gap(got['params'], want['params'])}"
        assert got["eval"] == want["eval"]
        assert all(np.array_equal(got["state"][n], want["state"][n]) for n in want["state"])


@pytest.mark.parametrize("label,base", [("s3", "s0"), ("s3 noclip a2", "s0 noclip a2")])
def test_stage3_within_tolerance(world, label, base):
    """Clipping (the norm's order), and two micro-batches (each micro-batch's
    gradient reduce-scattered before the micro-batches' sum): within 1e-6 of
    stage 0."""
    r = world["ranks"][0]
    np.testing.assert_allclose(r[label]["losses"], r[base]["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(r[label]["grad_norms"], r[base]["grad_norms"], rtol=LOSS_RTOL)
    assert _gap(r[label]["params"], r[base]["params"]) <= SUM_ORDER_ATOL
    assert r[label]["losses"][0] == r[base]["losses"][0]  # before any update


def test_default_threshold_keeps_tiny_leaves_whole(world):
    for r in world["ranks"]:
        assert r["s3 default"]["gather"]["held"] == []
        assert len(r["s3"]["gather"]["held"]) == len(_tiny_shapes())


# ------------------------------------------------------------- memory
def test_state_bytes_are_the_plans(world):
    """Masters, moments and gradients all split over the 2 ranks at
    threshold 0 (every llama-tiny leaf splits into 16-byte runs), each read
    from the live tensors. The gradient bytes alive at any collective (the
    parts' gradients, one layer's or one leaf's whole gradient, the call's
    buffers) stay below stage 0's whole gradients and flat copy, and at 6
    layers, where the layers outweigh the embedding, below the whole
    gradients alone: they never all exist at once."""
    shapes = [s for _, s in _tiny_shapes()]
    whole = 4 * sum(int(np.prod(s)) for s in shapes)
    for rank, r in enumerate(world["ranks"]):
        plan = stage3_plan(shapes, [n.startswith("['layers']") for n, _ in _tiny_shapes()],
                           2, rank, 0)
        part = 4 * sum(e.size for e, _ in plan)
        assert all(held for _, held in plan) and part == whole // 2
        b = r["s3"]["state_bytes"]
        assert (b["masters"], b["optimizer"], b["gradients"]) == (part, 2 * part, part)
        assert b["total"] == 4 * part
        assert r["s0"]["state_bytes"]["gradients_transient"] == 2 * whole
        assert b["gradients_transient"] < 2 * whole
        deep = 4 * sum(int(np.prod(s)) for _, s in _tiny_shapes(num_layers=MEMORY_LAYERS))
        assert r["deep s3"]["state_bytes"]["gradients_transient"] < deep
        assert r["s0"]["state_bytes"]["masters"] == whole


@pytest.mark.parametrize("label,most", [("deep s3", 2), ("deep s3 prefetch", 3)])
def test_at_most_two_layers_gathered_in_backward(world, label, most):
    """6 layers at remat none: each layer's slices are freed after its
    forward and gathered again for its backward, so at most 2 layers' slices
    are alive at once in backward (3 with the prefetch's gather in flight);
    2 x 6 layer gathers a step (forward and backward)."""
    for r in world["ranks"]:
        g = r[label]["gather"]
        assert 1 <= g["peak_layers_backward"] <= most
        assert g["peak_layers"] <= most < MEMORY_LAYERS
        assert g["gathers"] == 2 * MEMORY_LAYERS


# ------------------------------------------------------------- the plan
@pytest.mark.parametrize("shape,stacked,threshold,layout,held", [
    ((16, 2048, 8192), True, 0, "layers", True),   # llama3-1b's MLP weight: within layers
    ((4, 64), True, 0, "layers", True),            # a stacked norm scale
    ((4, 6), True, 0, "rows", False),              # a layer of 6: runs of 3, not 16 bytes
    ((256, 128), False, 0, "rows", True),          # the token table
    ((256, 128), False, 10**5, "rows", False),     # under the threshold: persistent
    ((6,), False, 0, "replicated", False),
])
def test_stage3_plan(shape, stacked, threshold, layout, held):
    numel = int(np.prod(shape))
    entries = [stage3_plan([shape], [stacked], 2, r, threshold)[0] for r in range(2)]
    assert {e.layout for e, _ in entries} == {layout}
    assert {h for _, h in entries} == {held}
    if layout != "layers":
        return
    L = shape[0]
    for r, (e, _) in enumerate(entries):
        assert e.run == numel // L // 2 and e.start == r * e.run and e.run % 4 == 0
        assert e.size == L * e.run
    if numel > 1 << 16:
        return
    whole = torch.arange(numel, dtype=torch.float32).view(shape)
    parts = [e.part(whole).contiguous() for e, _ in entries]
    for l in range(L):  # each layer's slice: rank 0's run, then rank 1's
        assert torch.equal(torch.cat([p[l] for p in parts]), whole[l].reshape(-1))
    gathered = torch.cat([p.reshape(-1) for p in parts])  # an all-gather's rank order
    assert torch.equal(entries[0][0].assemble(gathered), whole)


def test_partition_stage3_roles():
    """One rank's stage-3 partition: the held leaves, the persistent ones
    whose optimizer state still splits (re-gathered after the update), and
    the cut masters."""
    shapes = [(4, 8, 16), (4, 6), (64,), (6,)]
    part = ZeroPartition(shapes, None, stacked=[True, True, False, False], threshold=0)
    assert part.dp == 1 and part.gathered == []  # one rank: nothing held
    plan = stage3_plan(shapes, [True, True, False, False], 2, 1, 0)
    assert [(e.layout, h) for e, h in plan] == [("layers", True), ("rows", False),
                                                 ("rows", True), ("replicated", False)]
    assert plan[0][0] == LeafShard("layers", (4, 8, 16), 64, 256)


# --------------------------------------------------------- checkpoints
def test_stage3_checkpoint_resumes_bitwise(world):
    for r in world["ranks"]:
        s3 = r["s3"]
        assert s3["resumed"] == s3["after"]
        assert _bitwise(s3["resumed_params"], s3["final"])
        assert s3["resumed_state"].keys() == s3["state"].keys()
        assert all(np.array_equal(s3["resumed_state"][n], v) for n, v in s3["state"].items())
        # the masters are gathered leaf by leaf with the moments: 3 a leaf
        assert s3["save_gathers"] == (3 * len(_tiny_shapes()), 1)


def test_stage3_checkpoint_loads_at_stage0_on_one_rank(world):
    model = TransformerModel(port_config(jax_llama("llama-tiny", **TINY).config))
    eng, *_ = deepspeed_tpu_torch.initialize(model=model, config=_cfg(0), device="cpu",
                                             rng=torch.Generator().manual_seed(5))
    eng.load_checkpoint(str(world["dir"] / "port_s3"))
    want = world["ranks"][0]["s3"]
    got = {n: (t.detach().numpy() if torch.is_tensor(t) else np.asarray(t))
           for comp in ("params", "opt_state") for n, t in eng.checkpoint_components()[comp]}
    assert got.keys() == want["state"].keys()
    assert all(np.array_equal(got[n], v) for n, v in want["state"].items())
    loss = eng.train_batch(batch=world["batches"][3]).item()
    np.testing.assert_allclose(loss, want["after"], rtol=LOSS_RTOL)


def test_jax_stage3_checkpoint_loads_at_stage3(world):
    """JAX's legacy writer saved its stage-3 dp=2 engine's masters and
    moments split over the mesh; the port's ranks each keep their parts of
    the assembled leaves and train on."""
    want = world["jax"][False]
    for r in world["ranks"]:
        got = r["jax_s3"]
        assert got["state"].keys() == want["state"].keys()
        assert all(np.array_equal(got["state"][n], v) for n, v in want["state"].items())
        np.testing.assert_allclose(got["after"], [want["after"]], rtol=LOSS_RTOL)


def test_save_16bit_model_is_stage0s_file(world):
    """Stage 3 at clip 0 trains stage 0's masters; gathered a leaf at a time
    and cast, they make stage 0's file."""
    a = (world["dir"] / "s0_16" / "model.safetensors").read_bytes()
    b = (world["dir"] / "s3_16" / "model.safetensors").read_bytes()
    assert len(a) > 0 and a == b


def test_gathered_parameters_yield_stage0s_masters(world):
    for r in world["ranks"]:
        assert _bitwise(r["s3 noclip"]["gathered"], r["s0 noclip"]["params"])
