"""Packed sequences, custom positions and block-sparse attention in training:
the port against the JAX package, fp32 on the CPU.

- ``loss_fn`` and its gradients, and ``apply``'s logits, on ``llama-tiny``,
  ``gpt2-tiny`` and ``bloom-tiny`` with a batch's ``segment_ids`` only, its
  ``positions`` only, and both: B=2, S=128, documents of 50 and 78 tokens,
  positions restarting at token 50 (RoPE and learned positions move; BLOOM's
  ALiBi becomes the dense positions bias). Logits rtol 1e-4 / atol 1e-5 as
  ``test_torch_model.py``; the loss rtol 1e-5; every gradient leaf atol 1e-5
  of its largest value (fp32 sums in another order) plus 1e-9 (the key
  bias's gradient is exactly zero, and 1e-11 of rounding in both packages);
- ``TorchEngine`` against ``TpuEngine`` for three ``train_batch`` steps on
  packed batches, and with the "sparse_attention" section ("fixed" and
  "bigbird" at S=256, block 128), kernel switches on (the kernels' plain
  versions here, Pallas in interpret mode on the JAX side): the tolerances of
  ``test_torch_training.py`` (losses rtol 1e-5, grad norm rtol 1e-4, masters
  atol 2e-5);
- what sparse attention refuses as the JAX package does: a dense bias, and a
  block that is not a multiple of 128."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.topology import MeshTopology, ParallelDims
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.models.transformer import loss_fn as jax_loss_fn
from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu_torch.models import TransformerModel
from deepspeed_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from deepspeed_tpu_torch.ops import sparse_attention as psa

from torch_bridge import TINY, family_pair, port_config, tiny_pair, to_torch

S, DOCS = 128, (50, 78)
KEYS = {"segments": ("segment_ids",), "positions": ("positions",),
        "both": ("segment_ids", "positions")}


def _pair(family):
    return tiny_pair() if family == "llama" else family_pair(family)


def _packed(rows, S, docs, vocab, seed=0):
    """Token rows packed with ``docs`` per row: segment ids, positions
    restarting at every document, labels the next token inside it (-1 on a
    document's last token)."""
    ids = np.random.RandomState(seed).randint(0, vocab, size=(rows, S))
    seg = np.concatenate([np.full(n, i) for i, n in enumerate(docs)])
    pos = np.concatenate([np.arange(n) for n in docs])
    labels = np.concatenate([ids[:, 1:], np.full((rows, 1), -1)], axis=1)
    labels[:, np.cumsum(docs) - 1] = -1
    return {"input_ids": ids, "labels": labels,
            "segment_ids": np.tile(seg, (rows, 1)).astype(np.int32),
            "positions": np.tile(pos, (rows, 1)).astype(np.int32)}


@pytest.mark.parametrize("keys", sorted(KEYS))
@pytest.mark.parametrize("family", ["llama", "gpt2", "bloom"])
def test_loss_and_gradients_match_jax(family, keys):
    jm, jp, pm, pp = _pair(family)
    full = _packed(2, S, DOCS, jm.config.vocab_size)
    batch = {k: full[k] for k in ("input_ids", "labels", *KEYS[keys])}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    extra = {k: jbatch[k] for k in KEYS[keys]}
    @jax.jit
    def run(p):
        logits, _ = jm.apply(p, jbatch["input_ids"], dtype=jnp.float32, **extra)
        return logits, jax.value_and_grad(
            lambda p: jax_loss_fn(jm.config, p, jbatch, dtype=jnp.float32)[0])(p)

    want_logits, (want_loss, want_grads) = run(jp)

    tbatch = {k: to_torch(v).long() for k, v in batch.items()}
    got_logits = pm.apply(pp, tbatch["input_ids"], **{k: tbatch[k] for k in KEYS[keys]})
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), rtol=1e-4,
                               atol=1e-5)
    leaves = jax.tree.map(lambda t: t.clone().requires_grad_(True), pp)
    loss, _ = pm.loss(leaves, tbatch, dtype=torch.float32)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = params_to_numpy(jax.tree.map(lambda t: t.grad, leaves))
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g, w, atol=1e-5 * np.abs(w).max() + 1e-9, rtol=0),
        got, jax.tree.map(np.asarray, want_grads))


def _cfg(**extra):
    """test_torch_training.py's fp32 config, kernel switches on, the JAX
    engine's "auto" knobs pinned."""
    return {
        "train_batch_size": 4, "gradient_accumulation_steps": 2,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.01}},
        "gradient_clipping": 1.0, "steps_per_print": 100, "bf16": {"enabled": False},
        "tpu_kernels": {"flash_attention": True, "fused_rmsnorm": True,
                        "fused_adam": True, "fused_ce": True, "ce_chunk": 100},
        "zero_optimization": {"stage": 0, "grad_wire": "fp32", "param_wire": "fp32"},
        "serving": {"moe_a2a": "stock", "kv_cache_dtype": "bf16"},
        **extra,
    }


def _engines(cfg):
    jm = jax_llama("llama-tiny", **TINY)
    topo = MeshTopology(dims=ParallelDims(), devices=jax.devices()[:1])
    jeng, *_ = deepspeed_tpu.initialize(model=jm, config=dict(cfg), topology=topo,
                                        rng=jax.random.PRNGKey(0))
    pm = TransformerModel(port_config(jm.config))
    tree = jax.tree.map(np.asarray, jeng.state.params)
    peng, *_ = deepspeed_tpu_torch.initialize(
        model=pm, config=dict(cfg), model_parameters=params_from_numpy(pm.config, tree),
        device="cpu")
    return jeng, peng


# at S=256 (two blocks): "fixed" attends inside each block only; "bigbird"'s
# random block (seed 0) makes its layout the causal triangle
SPARSE = {
    "fixed": {"mode": "fixed", "block": 128, "num_local_blocks": 1,
              "num_global_blocks": 0},
    "bigbird": {"mode": "bigbird", "block": 128, "num_sliding_window_blocks": 1,
                "num_global_blocks": 0, "num_random_blocks": 1},
}


@pytest.mark.parametrize("case", ["packed", "sparse_fixed", "sparse_bigbird"])
def test_three_steps_match_tpu_engine(case):
    """Packed batches (S=128, documents 50 + 78 and 90 + 38), or plain
    batches at S=256 under the sparse_attention section: three steps."""
    if case == "packed":
        cfg = _cfg()
        batches = [_packed(4, S, docs, TINY["vocab_size"], seed=i)
                   for i, docs in enumerate((DOCS, (90, 38), DOCS))]
    else:
        cfg = _cfg(sparse_attention=SPARSE[case.split("_")[1]])
        batches = [{"input_ids": np.random.RandomState(i).randint(
            0, TINY["vocab_size"], size=(4, 256))} for i in range(3)]
    jeng, peng = _engines(cfg)
    assert (peng._sparse_impl is None) == (case == "packed")
    jl, pl = [], []
    for batch in batches:
        jl.append(float(jeng.train_batch(batch={k: jnp.asarray(v) for k, v in batch.items()})))
        pl.append(peng.train_batch(batch=batch).item())
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    np.testing.assert_allclose(peng.get_global_grad_norm(), jeng.get_global_grad_norm(),
                               rtol=1e-4)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, atol=2e-5),
                 params_to_numpy(peng.params), jax.tree.map(np.asarray, jeng.state.params))
    np.testing.assert_allclose(peng.eval_batch(batch=batches[0]).item(),
                               float(jeng.eval_batch(batch={k: jnp.asarray(v) for k, v in
                                                            batches[0].items()})),
                               rtol=1e-5)


def test_sparse_refusals_match_jax():
    """A dense bias with a sparse layout, and a block that is not a multiple
    of 128, raise ValueError in both packages."""
    r = np.random.RandomState(0)
    q, k, v = (r.randn(1, 256, 2, 64).astype(np.float32) for _ in range(3))
    bias = np.zeros((1, 1, 256, 256), np.float32)
    for mod, arr in ((jsa, jnp.asarray), (psa, torch.from_numpy)):
        impl = mod.make_attention_impl(mod.FixedSparsityConfig(block=128))
        with pytest.raises(ValueError, match="dense attention bias"):
            impl(arr(q), arr(k), arr(v), bias=arr(bias))
        with pytest.raises(ValueError):
            mod.make_attention_impl(mod.FixedSparsityConfig(block=64))(
                arr(q), arr(k), arr(v))
