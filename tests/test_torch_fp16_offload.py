"""fp16 with the dynamic loss scaler under optimizer and parameter offload, on
the CPU: ``offload_optimizer: cpu`` at ZeRO stages 2 and 3 (the per-layer
bucketed stream, ``runtime/bucketed_opt.py``), ``offload_param`` beside it
(the card's compute copy of the masters in fp16, refreshed by an applied
update only), and ``offload_optimizer: nvme`` (``runtime/swap_tensor.py``),
each against the resident fp16 run of the port, bitwise.

The JAX package turns its bucketed update off under fp16 and takes the
whole-state select (``deepspeed_tpu/runtime/engine.py:669-697``), whose
numbers are the resident run's: so the oracle is the port's resident fp16
run, bit for bit, as ``tests/test_torch_offload.py`` holds bf16 and fp32
offload (a departure by design, ROADMAP C). The resident run itself is held
to ``TpuEngine`` by ``tests/test_torch_fp16.py``.

llama-tiny (2 layers) at S=128, batch 4, ``tests/test_torch_fp16.py``'s
mixed trajectory (power 20, window 1, hysteresis 1: good steps grow the
scale until its steps overflow), six steps with at least one skip. Every
step's loss, scale and counts are equal; the masters and every optimizer
moment (under its resident name) are equal at the end. On each skipped step
the host state (moments, and the masters under ``offload_param``) and the
NVMe swap files stay bitwise as they were, and nothing streams: the
bucketed update, the NVMe reads (``bytes_read``) and writes
(``bytes_written``) and the compute copy's refresh do not run.

About 10-16 s in one process.
"""

import glob
import os

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import TransformerModel
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu_torch.runtime import bucketed_opt

from test_torch_fp16 import CASES, MIXED, _record
from test_torch_offload import _state
from torch_bridge import TINY, port_config

S = 128
STEPS = 6
CPU = {"offload_optimizer": {"device": "cpu"}}
FORMS = {
    "cpu stage 2": (2, CPU),
    "cpu stage 3": (3, CPU),
    "cpu + offload_param": (3, {**CPU, "offload_param": {"device": "cpu"}}),
    "nvme": (3, {"offload_optimizer": {"device": "nvme"}}),
    "nvme + offload_param": (3, {"offload_optimizer": {"device": "nvme"},
                                 "offload_param": {"device": "cpu"}}),
}


def _cfg(stage=0, zo=None, nvme_path=None):
    cfg = dict(CASES[MIXED][0])
    z = {**cfg["zero_optimization"], "stage": stage, **(zo or {})}
    if nvme_path is not None and "offload_optimizer" in z:
        z["offload_optimizer"] = {**z["offload_optimizer"], "nvme_path": nvme_path}
    return {**cfg, "zero_optimization": z}


def _batches():
    r = np.random.RandomState(0)
    return [{"input_ids": r.randint(0, TINY["vocab_size"], size=(4, S))}
            for _ in range(STEPS)]


def _engine(cfg):
    model = TransformerModel(port_config(jax_llama("llama-tiny", **TINY).config))
    eng, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu",
                                             rng=torch.Generator().manual_seed(0))
    return eng


def _host_state(eng):
    """The host-resident tensors (moments; masters under offload_param) and
    the NVMe swap files' bytes, as copies, read without moving anything."""
    tensors = []
    if eng._bucketed is not None:
        tensors += [t.clone() for t in _leaves(eng.opt_state)]
    if eng._param_offload:
        tensors += [t.clone() for t in _leaves(eng.params)]
    files = {}
    if eng._swapper is not None:
        eng._swapper.wait_pending("opt_state")
        for path in sorted(glob.glob(os.path.join(eng._swapper.swap_dir, "*"))):
            with open(path, "rb") as f:
                files[os.path.basename(path)] = f.read()
    return tensors, files


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree] if torch.is_tensor(tree) else []


@pytest.fixture(scope="module")
def resident():
    eng = _engine(_cfg())
    losses = [eng.train_batch(batch=b).item() for b in _batches()]
    return losses, _record(eng), _state(eng), eng.skipped_steps


@pytest.mark.parametrize("form", list(FORMS))
def test_fp16_offload_is_bitwise_the_resident_run(resident, form, tmp_path, monkeypatch):
    stage, zo = FORMS[form]
    eng = _engine(_cfg(stage, zo, str(tmp_path)))
    assert eng.offloaded and eng.fp16_enabled
    streamed = []
    real_step = bucketed_opt.BucketedOptimizer.step

    def step(self, *a, **kw):
        streamed.append("bucketed")
        return real_step(self, *a, **kw)

    monkeypatch.setattr(bucketed_opt.BucketedOptimizer, "step", step)
    losses, skips = [], 0
    for b in _batches():
        before = _host_state(eng)
        swapper = eng._swapper
        io = (swapper.bytes_read, swapper.bytes_written) if swapper else None
        copy = eng._compute_copy
        copy_before = [t.clone() for t in _leaves(copy)] if copy is not None else None
        streamed.clear()
        losses.append(eng.train_batch(batch=b).item())
        if eng._metrics["overflow"]:
            skips += 1
            after = _host_state(eng)
            assert len(before[0]) == len(after[0]) and all(
                torch.equal(x, y) for x, y in zip(before[0], after[0]))
            assert before[1] == after[1]
            assert not streamed
            if swapper is not None:
                assert (swapper.bytes_read, swapper.bytes_written) == io
            if copy_before is not None:
                assert eng._compute_copy is copy and all(
                    torch.equal(x, y) for x, y in zip(copy_before, _leaves(copy)))
        elif eng._bucketed is not None:
            assert streamed == ["bucketed"]
    want_losses, want_record, want_state, want_skips = resident
    assert skips == want_skips >= 1
    assert losses == want_losses and _record(eng) == want_record
    if eng._param_offload:  # the compute copy is fp16 and is the masters' cast
        assert all(c.dtype == torch.float16 for c in _leaves(eng._compute_copy))
        assert all(torch.equal(c, h.to(torch.float16)) for c, h in
                   zip(_leaves(eng._compute_copy), _leaves(eng.params)))
    got = _state(eng)
    assert set(got) == set(want_state)
    for name, t in want_state.items():
        assert torch.equal(got[name], t), name
