"""Rank functions of the sequence-parallel tests (tests/test_torch_sequence_parallel.py,
tests/test_torch_ring_flash.py) and of the checkpointing test over ranks
(tests/test_torch_checkpointing.py), run by
``deepspeed_tpu_torch.launcher.launch_local`` in spawned processes: this module
imports only torch and the port, so a rank starts without jax."""

import numpy as np
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.comm import get_topology, init_distributed
from deepspeed_tpu_torch.comm.topology import ParallelDims
from deepspeed_tpu_torch.models import TransformerConfig, TransformerModel
from deepspeed_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from deepspeed_tpu_torch.models.sharding import use_topology
from deepspeed_tpu_torch.ops.attention import attention, attention_impl
from deepspeed_tpu_torch.parallel.sequence import ring_attention, ulysses_attention


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
