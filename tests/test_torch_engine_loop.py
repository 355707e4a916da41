"""The port's DeepSpeed imperative loop, ``train_batch_chain`` and
``prepare_batch`` on llama-tiny (fp32, the CPU):

- ``engine(mb)`` / ``engine.backward(loss)`` / ``engine.step()`` at
  accumulation 1 and 2, with micro-batches of unequal target counts
  (ignored labels in some rows), equals ``train_batch`` on the same global
  batches bitwise (losses and masters), and the JAX ``TpuEngine``'s own loop
  within ``tests/test_torch_training.py``'s tolerances (losses rtol 1e-5,
  masters atol 2e-5), the forward's micro-batch losses rtol 1e-5;
- ``train_batch_chain(steps=3)`` on a batch, on a data iterator, and three
  ``train_batch`` calls on a ``prepare_batch``'d batch equal three
  ``train_batch`` calls bitwise;
- the surface: ``module``, ``train``/``eval`` (an eval-mode forward equals
  ``eval_batch`` bitwise and holds nothing), ``zero_grad``, the boundary,
  ``no_sync`` (refused under ZeRO >= 2), the batch-size properties.
"""

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
from deepspeed_tpu_torch.runtime.engine import PreparedBatch

from torch_bridge import TINY, port_config


def _cfg(accum):
    return {
        "train_batch_size": 4, "gradient_accumulation_steps": accum,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_num_steps": 3, "warmup_type": "linear"}},
        "gradient_clipping": 1.0, "steps_per_print": 100,
        # explicit values for the JAX engine's "auto" knobs
        "zero_optimization": {"stage": 0, "grad_wire": "fp32", "param_wire": "fp32"},
        "serving": {"moe_a2a": "stock", "kv_cache_dtype": "bf16"},
    }


@pytest.fixture(scope="module")
def weights():
    jm = jax_llama("llama-tiny", **TINY)
    return jm, jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))


def _port(weights, accum):
    jm, tree = weights
    pm = TransformerModel(port_config(jm.config))
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=pm, config=_cfg(accum), model_parameters=params_from_numpy(pm.config, tree),
        device="cpu")
    return eng


def _batches(n=2, seed=0):
    """Global batches of 4 x 64 with explicit labels; rows 0 and 1 ignore
    most of their targets, so the micro-batches' target counts differ."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = r.randint(0, TINY["vocab_size"], size=(4, 64))
        labels = np.concatenate([ids[:, 1:], np.full((4, 1), -100)], axis=1)
        labels[0, :40] = -100
        labels[1, 10:60] = -100
        out.append({"input_ids": ids, "labels": labels})
    return out


def _loop(engine, batches, micro):
    """The DeepSpeed loop over each global batch's micro-batches: the
    forward's losses and the losses ``step`` returned at each boundary."""
    fwd, stepped = [], []
    for batch in batches:
        for i in range(0, 4, micro):
            mb = {k: v[i:i + micro] for k, v in batch.items()}
            loss = engine(mb)
            fwd.append(float(loss))
            engine.backward(loss)
            at_boundary = i + micro == 4
            assert engine.is_gradient_accumulation_boundary() == at_boundary
            out = engine.step()
            assert (out is None) != at_boundary
            if out is not None:
                stepped.append(out)
    return fwd, stepped


@pytest.mark.parametrize("accum", [1, 2])
def test_loop_equals_train_batch(weights, accum):
    micro = 4 // accum
    batches = _batches()
    ref = _port(weights, accum)
    want = [ref.train_batch(batch=b) for b in batches]
    eng = _port(weights, accum)
    fwd, got = _loop(eng, batches, micro)
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and len(got) == 2
    jax.tree.map(np.testing.assert_array_equal, params_to_numpy(eng.params),
                 params_to_numpy(ref.params))
    assert (eng.global_steps, eng.micro_steps) == (2, 2 * accum)

    jm, tree = weights
    topo = MeshTopology(dims=ParallelDims(), devices=jax.devices()[:1])
    jeng, *_ = deepspeed_tpu.initialize(model=jm, config=_cfg(accum), topology=topo,
                                        model_parameters=jax.tree.map(np.asarray, tree))
    jfwd, jgot = _loop(jeng, batches, micro)
    np.testing.assert_allclose(fwd, jfwd, rtol=1e-5)
    np.testing.assert_allclose([x.item() for x in got], [float(x) for x in jgot], rtol=1e-5)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, atol=2e-5),
                 params_to_numpy(eng.params), jax.tree.map(np.asarray, jeng.state.params))


def test_chain_and_prepared_batch_equal_train_batch(weights):
    batch = _batches(1, seed=1)[0]
    ref = _port(weights, 2)
    want = torch.stack([ref.train_batch(batch=batch) for _ in range(3)])
    chain = _port(weights, 2)
    got = chain.train_batch_chain(batch=batch, steps=3)
    assert got.shape == (3,) and torch.equal(got, want)
    m = chain.last_chain_metrics
    assert {"loss", "grad_norm", "lr", "lm_loss", "moe_aux_loss", "tokens"} <= set(m)
    assert all(v.shape == (3,) for v in m.values()) and torch.equal(m["loss"], want)
    assert chain.global_steps == 3
    staged = _port(weights, 2)
    prepared = staged.prepare_batch(batch)
    assert isinstance(prepared, PreparedBatch)
    assert prepared["input_ids"].shape == (2, 2, 64)
    assert staged.prepare_batch(prepared) is prepared
    got_staged = torch.stack([staged.train_batch(batch=prepared) for _ in range(3)])
    assert torch.equal(got_staged, want)
    from_iter = _port(weights, 2)
    assert torch.equal(from_iter.train_batch_chain(data_iter=iter([batch] * 3), steps=3), want)
    for eng in (chain, staged, from_iter):
        jax.tree.map(np.testing.assert_array_equal, params_to_numpy(eng.params),
                     params_to_numpy(ref.params))
    with pytest.raises(ValueError, match="steps"):
        chain.train_batch_chain(batch=batch, steps=0)


def test_loop_surface(weights):
    eng = _port(weights, 2)
    assert eng.module is eng.model and eng.training
    assert (eng.train_micro_batch_size_per_gpu, eng.gradient_accumulation_steps) == (2, 2)
    batch = _batches(1, seed=2)[0]
    mb = {k: v[:2] for k, v in batch.items()}
    assert eng.eval() is eng and not eng.training
    assert torch.equal(eng(mb), eng.eval_batch(batch=mb))
    with pytest.raises(ValueError, match="pending forward"):
        eng.backward()  # an eval-mode forward holds nothing
    eng.train()
    eng.zero_grad()
    with eng.no_sync():
        eng.backward(eng(mb))
    assert not eng.is_gradient_accumulation_boundary() and eng.step() is None
    eng.backward(batch={k: v[2:] for k, v in batch.items()})  # an explicit micro-batch
    assert eng.is_gradient_accumulation_boundary()
    assert torch.equal(eng.step(), _port(weights, 2).train_batch(batch=batch))
    eng.config.zero_config.stage = 2
    with pytest.raises(RuntimeError, match="ZeRO stage >= 2"):
        with eng.no_sync():
            pass
