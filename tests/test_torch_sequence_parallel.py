"""Sequence-parallel training: ``deepspeed_tpu_torch.initialize`` with the
"sequence_parallel" section → three ``train_batch`` steps on gloo worlds of
spawned CPU ranks (``launcher.launch_local``), against the JAX package's
``TpuEngine`` on the same topology of the 8-device CPU mesh, from the same
masters (``params_from_numpy``), fp32.

- A world of 2 (sp=2) and one of 4 (dp=2, sp=2), each in the ring mode and
  the Ulysses mode (the world of 4's ring run with 2 accumulation steps),
  llama-tiny (H=4, KV=2: Ulysses repeats nothing at sp=2) at S=128, batch 4,
  AdamW with weight decay, clipping 1.0, kernel switches off (the dense ring
  and plain attention on both sides). Losses and the last grad norm rtol
  1e-5, as ``test_torch_training.py``; the masters after three steps atol
  5e-5, 5 % of one lr-1e-3 step: Adam's normalised update turns the
  summation-order noise of a near-zero gradient element into up to that (the
  ranks' gradient sum, the chunked attention; measured at most 3.2e-5
  against JAX and 2.0e-5 against the port's sp=1), where one device
  measured 1.5e-5 against its 2e-5.
- Inside the port, on the same batches: ring, Ulysses and sp=1 agree (losses
  rtol 1e-5, masters atol 5e-5) with the kernel switches on too (the ring
  flash and flash attention's plain versions, the chunked CE), on packed
  batches (segment ids across the chunk edge, restarting positions) and on
  bloom-tiny (ALiBi slopes at the chunks' global positions; with given
  positions the dense bias, which takes the ring mode to Ulysses).
- What stays refused names its ROADMAP item; an sp that does not divide the
  world, the sequence or the heads raises."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.topology import MeshTopology, ParallelDims
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.parallel.sequence import set_sp_mode
from deepspeed_tpu_torch.config import DeepSpeedConfigError
from deepspeed_tpu_torch.launcher import launch_local
from deepspeed_tpu_torch.models import TransformerModel

from torch_bridge import TINY, family_pair, port_config
from torch_sp_worker import train_rank

S = 128
KERNELS_ON = {"flash_attention": True, "fused_rmsnorm": True, "fused_adam": True,
              "fused_ce": True, "ce_chunk": 100}
LOSS_RTOL, PARAM_ATOL = 1e-5, 5e-5


def _cfg(sp=1, mode="ulysses", accum=1, kernels=False):
    cfg = {
        "train_batch_size": 4, "gradient_accumulation_steps": accum,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.01}},
        "gradient_clipping": 1.0, "steps_per_print": 100,
        "tpu_kernels": KERNELS_ON if kernels else {},
        # explicit values for the JAX engine's "auto" knobs (test_torch_training.py)
        "zero_optimization": {"stage": 0, "grad_wire": "fp32", "param_wire": "fp32"},
        "serving": {"moe_a2a": "stock", "kv_cache_dtype": "bf16"},
    }
    if sp > 1:
        cfg["sequence_parallel"] = {"sp_size": sp, "mode": mode}
    return cfg


def _batches(vocab, n=3, seed=0):
    r = np.random.RandomState(seed)
    return [{"input_ids": r.randint(0, vocab, size=(4, S))} for _ in range(n)]


def _packed(vocab, n=3, docs=(50, 78)):
    """Rows of two documents, the boundary inside the first sp=2 chunk:
    segment ids, positions restarting at each document, labels inside it."""
    out = []
    seg = np.concatenate([np.full(d, i) for i, d in enumerate(docs)])
    pos = np.concatenate([np.arange(d) for d in docs])
    for b in _batches(vocab, n, seed=5):
        ids = b["input_ids"]
        labels = np.concatenate([ids[:, 1:], np.full((4, 1), -1)], axis=1)
        labels[:, np.cumsum(docs) - 1] = -1
        out.append({"input_ids": ids, "labels": labels,
                    "segment_ids": np.tile(seg, (4, 1)).astype(np.int32),
                    "positions": np.tile(pos, (4, 1)).astype(np.int32)})
    return out


def _jax_run(cfg, dp, sp, batches, seed=0):
    jm = jax_llama("llama-tiny", **TINY)
    topo = MeshTopology(dims=ParallelDims(dp=dp, sp=sp), devices=jax.devices()[:dp * sp])
    try:
        eng, *_ = deepspeed_tpu.initialize(model=jm, config=dict(cfg), topology=topo,
                                           rng=jax.random.PRNGKey(seed))
        tree = jax.tree.map(np.asarray, eng.state.params)
        losses = [float(eng.train_batch(batch=dict(b))) for b in batches]
        return (tree, losses, eng.get_global_grad_norm(),
                jax.tree.map(np.asarray, eng.state.params))
    finally:
        set_sp_mode("ulysses")


def _run(label, fields, tree, cfg, batches):
    return {"label": label, "model": fields, "tree": tree, "config": cfg,
            "batches": batches}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree)]


def _assert_same(got, want, what):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL,
                               err_msg=f"{what}: losses")
    np.testing.assert_allclose(got["grad_norms"][-1], want["grad_norms"][-1],
                               rtol=LOSS_RTOL, err_msg=f"{what}: grad norm")
    for a, b in zip(_leaves(got["params"]), _leaves(want["params"])):
        np.testing.assert_allclose(a, b, atol=PARAM_ATOL, err_msg=f"{what}: masters")


def _single(runs):
    """The runs on this process, one device (sp=1)."""
    return train_rank(0, runs)


@pytest.mark.parametrize("dp", [1, 2])
def test_sp_world_matches_tpu_engine(dp):
    """dp x 2 ranks, ring and Ulysses, against TpuEngine on the same mesh;
    inside the port, both modes against sp=1 on one process."""
    batches = _batches(TINY["vocab_size"])
    accum = {"ring": 2 if dp == 2 else 1, "ulysses": 1}
    want = {mode: _jax_run(_cfg(2, mode, accum[mode]), dp, 2, batches)
            for mode in ("ring", "ulysses")}
    tree = want["ring"][0]
    fields = dataclasses.asdict(port_config(jax_llama("llama-tiny", **TINY).config))
    runs = [_run(mode, fields, tree, _cfg(2, mode, accum[mode]), batches)
            for mode in ("ring", "ulysses")]
    ranks = launch_local(train_rank, 2 * dp, (runs,), backend="gloo")
    for r in ranks[1:]:  # every rank returns the global loss
        for mode in ("ring", "ulysses"):
            assert r[mode]["losses"] == ranks[0][mode]["losses"]
    single = _single([_run("sp1", fields, tree, _cfg(), batches)])["sp1"]
    for mode in ("ring", "ulysses"):
        _, jl, jnorm, jparams = want[mode]
        _assert_same(ranks[0][mode], {"losses": jl, "grad_norms": [jnorm],
                                      "params": jparams}, f"{mode} vs TpuEngine")
        _assert_same(ranks[0][mode], single, f"{mode} vs sp=1")
        np.testing.assert_allclose(ranks[0][mode]["eval"], single["eval"], rtol=LOSS_RTOL)


def test_sp_modes_agree_inside_the_port():
    """On a world of 2: the kernel switches on (ring flash, flash attention's
    plain versions, chunked CE), packed batches, and bloom-tiny's ALiBi,
    each in both modes, against sp=1 on one process."""
    llama_fields = dataclasses.asdict(port_config(jax_llama("llama-tiny", **TINY).config))
    _, _, pm, pp = family_pair("bloom")
    from deepspeed_tpu_torch.models.convert import params_to_numpy

    bloom_fields, bloom_tree = dataclasses.asdict(pm.config), params_to_numpy(pp)
    llama_tree = _jax_run(_cfg(), 1, 1, [])[0]
    cases = {
        "kernels": (llama_fields, llama_tree, _batches(TINY["vocab_size"]),
                    dict(kernels=True)),
        "packed": (llama_fields, llama_tree, _packed(TINY["vocab_size"]), {}),
        "bloom": (bloom_fields, bloom_tree, _batches(pm.config.vocab_size), {}),
        "bloom_positions": (bloom_fields, bloom_tree, _packed(pm.config.vocab_size), {}),
    }
    runs = [_run(f"{name} {mode}", f, t, _cfg(2, mode, **kw), b)
            for name, (f, t, b, kw) in cases.items() for mode in ("ring", "ulysses")]
    got = launch_local(train_rank, 2, (runs,), backend="gloo")[0]
    want = _single([_run(name, f, t, _cfg(**kw), b)
                    for name, (f, t, b, kw) in cases.items()])
    for label, res in got.items():
        _assert_same(res, want[label.split()[0]], label)


@pytest.mark.parametrize("extra,match", [
    ({"zero_optimization": {"stage": 1}}, "ZeRO stage 1 \\(item 7\\)"),
    ({"tensor_parallel": {"tp_size": 2}}, "tensor parallelism \\(item 7\\)"),
    ({"pipeline": {"stages": 2}}, "pipeline parallelism \\(item 7\\)"),
    ({"zero_optimization": {"stage": 0, "offload_optimizer": {"device": "cpu"}}},
     "offload, NVMe included \\(item 7\\)"),
])
def test_other_parallelism_still_refused(extra, match):
    model = TransformerModel(port_config(jax_llama("llama-tiny", **TINY).config))
    cfg = {**_cfg(2, "ring"), **extra}
    with pytest.raises(NotImplementedError, match=match):
        deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")


def test_sp_config_errors():
    model = TransformerModel(port_config(jax_llama("llama-tiny", **TINY).config))
    with pytest.raises(DeepSpeedConfigError, match="ulysses or ring"):
        deepspeed_tpu_torch.initialize(
            model=model, config={**_cfg(), "sequence_parallel": {"sp_size": 2,
                                                                  "mode": "zigzag"}},
            device="cpu")
    with pytest.raises(DeepSpeedConfigError, match="sparse_attention"):
        deepspeed_tpu_torch.initialize(
            model=model, config={**_cfg(2), "sparse_attention": {"mode": "fixed"}},
            device="cpu")
    # one process cannot hold an sp ring of 2
    with pytest.raises(ValueError, match="world size 1"):
        deepspeed_tpu_torch.initialize(model=model, config=_cfg(2, "ring"), device="cpu")
