"""fp16 with the dynamic loss scaler under sequence parallelism: ``initialize``
with the ``fp16`` and "sequence_parallel" sections (sp_size 2, ring and
Ulysses) on one gloo world of 2 spawned CPU ranks (``launcher.launch_local``;
every case in that one launch, ``torch_sp_worker.fp16_rank``), against the
JAX package's ``TpuEngine`` in fp16 on the sp=2 CPU mesh with the kernel
switches off, and against the port's sp=1 fp16 run with them on (the ring
flash's offset forms and flash attention's plain versions, the chunked CE),
from the same masters. llama-tiny at S=128, batch 4, three steps,
``tests/test_torch_fp16.py``'s config with AdamW's eps at 1e-6.

- Against TpuEngine, kernels off: ring at power 16 with window 2 (the scale
  grows, no skip), Ulysses at power 30 (every step skipped). Each step's
  scale, ``skipped_steps``, ``global_steps`` and lr equal on both ranks; the
  losses within rtol 1e-4 and the unscaled gradients' norm within rtol 1e-4
  (a loss scaled once per chunk, or a chunk's gradient unscaled twice, is a
  factor of 2 or of 2**16 away); the masters within the fp16 Adam bounds
  (atol 2e-3, the update within 2e-2 in relative L2); a skipped step leaves
  every rank's masters and optimizer state bitwise as they were.
- Against the port's sp=1, kernels on: ring on packed batches (segment ids
  across the chunk edge, positions restarting: the hops' segment pairs at
  their offsets) and Ulysses on plain batches, power 16, the same bounds.

About 25-35 s in one process.
"""

import dataclasses

import jax
import numpy as np
import pytest

import deepspeed_tpu
from deepspeed_tpu.comm.topology import MeshTopology, ParallelDims
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.parallel.sequence import set_sp_mode
from deepspeed_tpu_torch.launcher import launch_local

import torch_sp_worker
from test_torch_fp16 import (LOSS_RTOL, _cfg, _host, _masters_close, _record, _same_norms,
                             _same_records)
from torch_bridge import TINY, port_config

S, DOCS = 128, (50, 78)
# label: (mode, power, kernels, packed)
SP_RUNS = {
    "ring p16 plain": ("ring", 16, False, False),
    "ulysses p30 plain": ("ulysses", 30, False, False),
    "ring p16 kernels packed": ("ring", 16, True, True),
    "ulysses p16 kernels": ("ulysses", 16, True, False),
}


def _batches(packed):
    r = np.random.RandomState(4)
    out = []
    for _ in range(3):
        ids = r.randint(0, TINY["vocab_size"], size=(4, S))
        b = {"input_ids": ids}
        if packed:
            labels = np.concatenate([ids[:, 1:], np.full((4, 1), -1)], axis=1)
            labels[:, np.cumsum(DOCS) - 1] = -1
            seg = np.concatenate([np.full(d, i) for i, d in enumerate(DOCS)])
            pos = np.concatenate([np.arange(d) for d in DOCS])
            b.update(labels=labels, segment_ids=np.tile(seg, (4, 1)).astype(np.int32),
                     positions=np.tile(pos, (4, 1)).astype(np.int32))
        out.append(b)
    return out


def _config(mode, power, kernels, sp=2):
    cfg = _cfg(power, 2 if power == 16 else 1000, kernels)
    # eps 1e-6, as tests/test_torch_fp16_dp.py has it: at Adam's 1e-8 one
    # near-cancelled element of the packed ring run moved 2.1e-3 from sp=1's
    # in 3 steps (the chunks' fp16 gradient sums in another order, normalised)
    cfg["optimizer"]["params"]["eps"] = 1e-6
    if sp > 1:
        cfg["sequence_parallel"] = {"sp_size": sp, "mode": mode}
    return cfg


@pytest.fixture(scope="module")
def runs():
    """TpuEngine's sp=2 runs of the plain cases, the port's world of 2 for
    every case, and the port's sp=1 runs of the kernel cases (this
    process)."""
    jm = jax_llama("llama-tiny", **TINY)
    topo = MeshTopology(dims=ParallelDims(sp=2), devices=jax.devices()[:2])
    want, tree = {}, None
    for label, (mode, power, kernels, packed) in SP_RUNS.items():
        if kernels:
            continue
        try:
            eng, *_ = deepspeed_tpu.initialize(model=jm, config=_config(mode, power, False),
                                               topology=topo, rng=jax.random.PRNGKey(0))
            m0 = _host(eng.state.params)  # one seed: every engine's masters alike
            tree = m0 if tree is None else tree
            jax.tree.map(np.testing.assert_array_equal, m0, tree)
            res = {"losses": [], "records": [], "norms": []}
            for b in _batches(packed):
                res["losses"].append(float(eng.train_batch(batch=dict(b))))
                res["records"].append(_record(eng))
                res["norms"].append(float(eng._metrics["grad_norm"]))
            res["params"] = _host(eng.state.params)
            want[label] = res
        finally:
            set_sp_mode("ulysses")
    fields = dataclasses.asdict(port_config(jm.config))
    cases = [{"label": label, "model": fields, "tree": tree,
              "config": _config(mode, power, kernels), "batches": _batches(packed)}
             for label, (mode, power, kernels, packed) in SP_RUNS.items()]
    ranks = launch_local(torch_sp_worker.fp16_rank, 2, (cases,), backend="gloo")
    single = torch_sp_worker.fp16_rank(0, [
        {**c, "config": _config(None, SP_RUNS[c["label"]][1], True, sp=1)}
        for c in cases if SP_RUNS[c["label"]][2]])
    return {"tree": tree, "jax": want, "ranks": ranks, "single": single}


@pytest.mark.parametrize("label", [k for k, v in SP_RUNS.items() if not v[2]])
def test_sp2_fp16_matches_tpu_engine(runs, label):
    want = runs["jax"][label]
    for rank in runs["ranks"]:
        got = rank[label]
        assert _same_records(got["records"], want["records"])
        _same_norms(got["norms"], want["norms"])
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
        assert all(u for u, o in zip(got["unchanged"], got["overflow"]) if o)
    got = runs["ranks"][0][label]["params"]
    if SP_RUNS[label][1] == 30:
        assert all(runs["ranks"][0][label]["overflow"])
        jax.tree.map(np.testing.assert_array_equal, got, runs["tree"])
    else:
        assert not any(runs["ranks"][0][label]["overflow"])
        _masters_close(got, want["params"], runs["tree"])


@pytest.mark.parametrize("label", [k for k, v in SP_RUNS.items() if v[2]])
def test_sp2_fp16_kernels_match_sp1(runs, label):
    want = runs["single"][label]
    for rank in runs["ranks"]:
        got = rank[label]
        assert _same_records(got["records"], want["records"])
        _same_norms(got["norms"], want["norms"])
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    _masters_close(runs["ranks"][0][label]["params"], want["params"], runs["tree"])
