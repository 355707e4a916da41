"""Rank functions of the sequence-parallel tests (tests/test_torch_sequence_parallel.py,
tests/test_torch_ring_flash.py), of the checkpointing test over ranks
(tests/test_torch_checkpointing.py) and of ZeRO over dp ranks
(tests/test_torch_zero_dp.py, tests/test_torch_zero3.py) and of fp16 over
them (tests/test_torch_fp16_dp.py), run by
``deepspeed_tpu_torch.launcher.launch_local`` in spawned processes: this module
imports only torch and the port, so a rank starts without jax."""

import functools
import weakref

import numpy as np
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.comm import all_gather, get_topology, init_distributed, reduce_scatter
from deepspeed_tpu_torch.comm.collectives import all_gather_async
from deepspeed_tpu_torch.comm.topology import ParallelDims
from deepspeed_tpu_torch.models import TransformerConfig, TransformerModel
from deepspeed_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from deepspeed_tpu_torch.models.sharding import use_topology
from deepspeed_tpu_torch.ops.attention import attention, attention_impl
from deepspeed_tpu_torch.parallel.sequence import ring_attention, ulysses_attention
from deepspeed_tpu_torch.runtime import engine as engine_module
from deepspeed_tpu_torch.runtime.zero import ShardedLeaf, prefetch, shard_plan, stage3_plan
from deepspeed_tpu_torch.utils.tree import tree_items, tree_leaves, tree_map
from deepspeed_tpu_torch.zero import GatheredParameters


def train_rank(rank, runs):
    """Each run, a dict of ``label``, ``model`` (TransformerConfig fields),
    ``tree`` (numpy masters), ``config`` and ``batches``: ``initialize`` on
    this rank's world from the masters, one ``train_batch`` per batch, then
    ``eval_batch`` on the first. Returns per label the losses, grad norms,
    the eval loss and (rank 0) the final masters."""
    out = {}
    for run in runs:
        model = TransformerModel(TransformerConfig(**run["model"]))
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=model, config=run["config"],
            model_parameters=params_from_numpy(model.config, run["tree"]), device="cpu")
        losses, norms = [], []
        for batch in run["batches"]:
            losses.append(eng.train_batch(batch=batch).item())
            norms.append(eng.get_global_grad_norm())
        out[run["label"]] = {
            "losses": losses, "grad_norms": norms,
            "eval": eng.eval_batch(batch=run["batches"][0]).item(),
            "params": params_to_numpy(eng.params) if rank == 0 else None}
    return out


def checkpoint_rank(rank, run, directory, npz):
    """A dp world's save and resume: every rank trains one step from the
    masters and calls ``save_checkpoint`` (rank 0 writes), trains a second
    step, then a fresh engine of other masters loads the checkpoint and trains
    the second step again. Rank 0 then runs the ``zero_to_fp32.py`` the save
    dropped into ``directory``, with jax and the JAX package made unimportable.
    Returns the second step's loss, uninterrupted and resumed."""
    import runpy
    import sys

    model = TransformerModel(TransformerConfig(**run["model"]))

    def engine(**kw):
        return deepspeed_tpu_torch.initialize(model=model, config=run["config"],
                                              device="cpu", **kw)[0]

    eng = engine(model_parameters=params_from_numpy(model.config, run["tree"]))
    first, second = run["batches"]
    eng.train_batch(batch=first)
    eng.save_checkpoint(directory)
    want = eng.train_batch(batch=second).item()
    fresh = engine(rng=torch.Generator().manual_seed(9))
    fresh.load_checkpoint(directory)
    got = fresh.train_batch(batch=second).item()
    if rank == 0:
        sys.modules["jax"] = sys.modules["deepspeed_tpu"] = None
        argv, sys.argv = sys.argv, ["zero_to_fp32.py", directory, npz]
        try:
            runpy.run_path(f"{directory}/zero_to_fp32.py", run_name="__main__")
        finally:
            sys.argv = argv
    return want, got


def _masters(eng):
    """The whole masters as numpy copies (``params_to_numpy`` views CPU
    tensors, which the next step updates in place; at stage 3 the held parts
    are gathered: every rank calls)."""
    return params_to_numpy(tree_map(lambda t: t.detach().clone(), eng.whole_params()))


def _numpy_state(eng):
    """The engine's masters and optimizer state by checkpoint name, whole
    (gathered over the dp ranks: every rank calls)."""
    comps = eng.checkpoint_components()
    return {n: (t.detach().numpy().copy() if torch.is_tensor(t)
                else t.whole().numpy() if isinstance(t, ShardedLeaf) else np.asarray(t))
            for comp in ("params", "opt_state") for n, t in comps[comp]}


def _counting_gathers(fn):
    """Run ``fn`` with ``ShardedLeaf.whole`` counted: (the gathers, the most
    gathered leaves alive at once, each gather's own result included)."""
    whole, alive, most = ShardedLeaf.whole, [], [0]

    def counted(leaf):
        t = whole(leaf)
        alive.append(weakref.ref(t))
        most[0] = max(most[0], sum(r() is not None for r in alive))
        return t

    ShardedLeaf.whole = counted
    try:
        fn()
    finally:
        ShardedLeaf.whole = whole
    return len(alive), most[0]


def parts_norm(leaves, dp=2, stacked=None, threshold=0):
    """The global norm of the whole gradients ``leaves`` summed as stage 2
    over ``dp`` ranks sums it (``ZeroPartition.square_sums``): each sharded
    leaf's parts' squares added in rank order, a replicated leaf's whole,
    then the [1, leaves] sums and the root. With ``stacked`` (each leaf's
    membership of the layers group), as stage 3 at ``threshold`` sums it: the
    leaves held as parts split, each part contiguous as the engine holds it,
    the persistent ones whole."""
    shapes = [t.shape for t in leaves]
    if stacked is None:
        plans = [[(e, e.sharded) for e in shard_plan(shapes, dp, r)] for r in range(dp)]
    else:
        plans = [stage3_plan(shapes, stacked, dp, r, threshold) for r in range(dp)]
    sq = []
    for i, t in enumerate(leaves):
        split = plans[0][i][1]
        s = (plans[0][i][0].part(t).contiguous() if split else t).float().square().sum()
        for plan in plans[1:] if split else ():
            s = s + plan[i][0].part(t).contiguous().float().square().sum()
        sq.append(s)
    return torch.stack([torch.stack(sq)]).sum().sqrt()


def zero_rank(rank, runs, moe_config):
    """ZeRO over this world's dp ranks. Each run, a dict of ``label``,
    ``model`` (TransformerConfig fields), ``tree`` (numpy masters),
    ``config`` and ``batches``, and optionally ``load`` (a checkpoint
    directory loaded before the batches), ``parts_norm`` (the engine's
    ``global_norm`` replaced by :func:`parts_norm` for the run), ``save`` (a
    directory saved to after them) and ``after`` (batches trained after the save; with
    ``resume`` also by a fresh engine that loads the save). Returns per
    label the losses, grad norms, ``state_bytes()``, the whole state and the
    masters after the batches, the ``after`` losses, the masters at the end
    (``final``) and the resumed run's state, losses and final masters. Last, ``moe``: the
    refusal of an MoE model over the world (``moe_config``), and
    ``collectives``: ``comm.reduce_scatter`` and ``all_gather`` along dim 1
    of a [4, 6] tensor, and the reduce-scatter's refusal of 3 elements."""
    out = {run["label"]: zero_run(run) for run in runs}
    world = get_topology().world_group()
    x = torch.arange(24.0).view(4, 6) + 100.0 * rank
    out["collectives"] = {"reduce_scatter": reduce_scatter(x, world, dim=1).numpy(),
                          "all_gather": all_gather(x, world, dim=1).numpy()}
    try:
        reduce_scatter(torch.ones(3), world)
    except ValueError as e:
        out["collectives"]["refused"] = str(e)
    try:
        moe = TransformerModel(TransformerConfig(**moe_config["model"]))
        deepspeed_tpu_torch.initialize(model=moe, config=moe_config["config"], device="cpu")
        out["moe"] = None
    except NotImplementedError as e:
        out["moe"] = str(e)
    return out


def zero_run(run):
    """One run of :func:`zero_rank` / :func:`zero3_rank` on this rank's
    world. ``parts_norm``: True for stage 2's order, or the persistence
    threshold of stage 3's order. Beside :func:`zero_rank`'s keys, ``save16``
    (a directory ``save_16bit_model`` writes to after the batches),
    ``gathered`` (the masters ``zero.GatheredParameters`` yields) and, at
    stage 3, ``gather``: the last step's gather scope counters."""
    model = TransformerModel(TransformerConfig(**run["model"]))

    def engine(**kw):
        return deepspeed_tpu_torch.initialize(model=model, config=run["config"],
                                              device="cpu", **kw)[0]

    if run["tree"] is None:  # masters drawn from a seed
        eng = engine(rng=torch.Generator().manual_seed(0))
    else:
        eng = engine(model_parameters=params_from_numpy(model.config, run["tree"]))
    if run.get("load"):
        eng.load_checkpoint(run["load"])
    res = {"losses": [], "grad_norms": []}
    norm = engine_module.global_norm
    pn = run.get("parts_norm")
    if pn is True:
        engine_module.global_norm = parts_norm
    elif pn is not None and pn is not False:
        stacked = [n.startswith("['layers']") for n, _ in tree_items(eng.params)]
        engine_module.global_norm = functools.partial(parts_norm, stacked=stacked,
                                                      threshold=pn)
    try:
        for batch in run["batches"]:
            res["losses"].append(eng.train_batch(batch=batch).item())
            res["grad_norms"].append(eng.get_global_grad_norm())
    finally:
        engine_module.global_norm = norm
    res["state_bytes"] = eng.state_bytes()
    g = eng.last_gather
    if g is not None:
        res["gather"] = {"peak_layers": g.peak_layers, "gathers": g.gathers,
                         "peak_layers_backward": g.peak_layers_backward,
                         "held": list(eng._partition.gathered)}
    res["state"] = _numpy_state(eng)
    res["params"] = _masters(eng)
    if run.get("gathered"):
        with GatheredParameters(eng) as whole:
            res["gathered"] = params_to_numpy(whole)
    res["eval"] = eng.eval_batch(batch=run["batches"][0]).item() if run["batches"] else None
    if run.get("save16"):
        eng.save_16bit_model(run["save16"])
    if run.get("save"):
        res["save_gathers"] = _counting_gathers(lambda: eng.save_checkpoint(run["save"]))
    res["after"] = [eng.train_batch(batch=b).item() for b in run.get("after", [])]
    res["final"] = _masters(eng)
    if run.get("resume"):
        fresh = engine(rng=torch.Generator().manual_seed(9))
        fresh.load_checkpoint(run["save"])
        res["resumed_state"] = _numpy_state(fresh)
        res["resumed"] = [fresh.train_batch(batch=b).item() for b in run["after"]]
        res["resumed_params"] = _masters(fresh)
    return res


def zero3_rank(rank, runs):
    """ZeRO stage 3 over this world's dp ranks: :func:`zero_run` of each
    run, by label."""
    return {run["label"]: zero_run(run) for run in runs}


def _parts(eng):
    """This rank's masters and optimizer state as it holds them (its parts
    over the dp ranks; no collective), as numpy copies."""
    return [t.detach().numpy().copy() for t in
            tree_leaves(eng.params) + tree_leaves(eng.opt_state)]


def fp16_rank(rank, runs):
    """fp16 over this world's dp ranks. Each run, a dict of ``label``,
    ``model``, ``tree``, ``config`` and ``batches``, optionally ``poison``
    (rank, step): on that rank at that step (1-based) one element of the
    first gradient part this rank holds is set to inf just before the
    overflow test, so the inf lies in that rank's part only. Returns per
    label, per step, the loss, (scale, skipped_steps, global_steps, lr), the
    overflow flag, the gradient norm and whether this rank's parts stayed bitwise as they were;
    the whole masters at the end and ``gathered``, the dtypes the stage-3
    gathers (``runtime/zero/prefetch.py``) moved. Last, ``collectives``: an
    fp16 tensor through gloo's all-gather, blocking and asynchronous."""
    out = {}
    for run in runs:
        model = TransformerModel(TransformerConfig(**run["model"]))
        eng = deepspeed_tpu_torch.initialize(
            model=model, config=run["config"], device="cpu",
            model_parameters=params_from_numpy(model.config, run["tree"]))[0]
        poison_rank, poison_step = run.get("poison") or (None, None)
        unscale = eng._unscale
        res = {"losses": [], "records": [], "unchanged": [], "overflow": [], "norms": []}
        gathered = set()  # the dtypes the stage-3 gathers moved through gloo
        real = {n: getattr(prefetch, n) for n in ("all_gather", "all_gather_async")}

        def spy(name):
            def call(x, *a, **k):
                gathered.add(str(x.dtype))
                return real[name](x, *a, **k)
            return call

        for name in real:
            setattr(prefetch, name, spy(name))
        try:
            for step, batch in enumerate(run["batches"], 1):
                if rank == poison_rank and step == poison_step:
                    def poisoned(leaves, scale, accum):
                        leaves[0].view(-1)[0] = float("inf")
                        return unscale(leaves, scale, accum)
                    eng._unscale = poisoned
                before = _parts(eng)
                res["losses"].append(eng.train_batch(batch=batch).item())
                eng._unscale = unscale
                res["records"].append((float(eng.loss_scale), eng.skipped_steps,
                                       eng.global_steps, float(eng.lr)))
                res["overflow"].append(bool(eng._metrics["overflow"]))
                res["norms"].append(float(eng._metrics["grad_norm"]))
                res["unchanged"].append(all(np.array_equal(a, b)
                                            for a, b in zip(before, _parts(eng))))
        finally:
            for name, fn in real.items():
                setattr(prefetch, name, fn)
        res["gathered"] = sorted(gathered)
        res["params"] = _masters(eng)
        out[run["label"]] = res
    world = get_topology().world_group()
    x = torch.arange(6, dtype=torch.float16).view(2, 3) + 1000 * rank
    handle = all_gather_async(x, world)
    out["collectives"] = {"all_gather": all_gather(x, world).numpy(),
                          "all_gather_async": handle.wait().numpy()}
    return out


def attention_rank(rank, sp, cases):
    """Each case, a dict of ``label``, ``mode`` (ulysses | ring), ``impl``
    (plain | flash), ``causal`` and numpy ``q``, ``k``, ``v``, ``g`` (the
    upstream gradient) over the whole sequence, and optional ``segment_ids``
    and ``slopes``: this rank's sequence chunk through the sp attention over
    the world's sp group. Returns per label this rank's output chunk and its
    share of the q, k, v gradients (the gradients of the whole inputs, summed
    over the ranks, are the flat attention's)."""
    init_distributed(dims=ParallelDims(sp=sp))
    topo = get_topology()
    out = {}
    for c in cases:
        q, k, v = (torch.from_numpy(c[n]).requires_grad_(True) for n in "qkv")
        S = q.shape[1]
        chunk = slice(rank * S // sp, (rank + 1) * S // sp)
        seg = c.get("segment_ids")
        seg = None if seg is None else torch.from_numpy(seg)[:, chunk].contiguous()
        slopes = None if c.get("slopes") is None else torch.from_numpy(c["slopes"])
        fn = ulysses_attention if c["mode"] == "ulysses" else ring_attention
        with use_topology(topo), attention_impl(c["impl"]):
            y = fn(q[:, chunk], k[:, chunk], v[:, chunk], causal=c["causal"],
                   segment_ids=seg, alibi_slopes=slopes)
        grads = torch.autograd.grad(y, (q, k, v), torch.from_numpy(c["g"])[:, chunk])
        out[c["label"]] = [y.detach().numpy()] + [g.numpy() for g in grads]
    return out


def flat_attention(c):
    """The flat attention of an ``attention_rank`` case on one process:
    (out, dq, dk, dv)."""
    q, k, v = (torch.from_numpy(c[n]).requires_grad_(True) for n in "qkv")
    seg = None if c.get("segment_ids") is None else torch.from_numpy(c["segment_ids"])
    slopes = None if c.get("slopes") is None else torch.from_numpy(c["slopes"])
    y = attention(q, k, v, causal=c["causal"], segment_ids=seg, alibi_slopes=slopes)
    grads = torch.autograd.grad(y, (q, k, v), torch.from_numpy(c["g"]))
    return [y.detach().numpy()] + [g.numpy() for g in grads]
