"""fp16 training wherever bf16 trains, one device: ``deepspeed_tpu_torch.
initialize`` with an ``fp16`` section against the JAX package's ``TpuEngine``
in fp16 on one CPU device, from the same masters, on the GPT-2 and BLOOM
families (LayerNorm, biases, learned positions or ALiBi, the tied head),
packed batches (segment ids, positions, labels; BLOOM's ALiBi then becomes
the fp32 dense positions bias) and the ``sparse_attention`` section.

``gpt2-tiny`` and ``bloom-tiny`` (``torch_bridge.family_pair``: vocab 256,
seeded noise on the zero biases and unit scales) and ``llama-tiny``, S=128
(256 for the block-sparse layout at block 128), batch 4, three steps each,
``tests/test_torch_fp16.py``'s config (AdamW with weight decay, a warmup
schedule, clipping 1.0, the JAX "auto" knobs pinned) at power 16 with window
2 (the scale grows, no step overflows) or power 30 (every step overflows:
the hysteresis, then the halvings), kernels off (the plain paths on both
sides) and on (the kernels' plain versions here, the Pallas kernels in
interpret mode and the chunked CE there). Every family meets both powers and
both kernel settings across the cases. A packed batch carries its labels:
without them both packages drop the segment ids.

Each step's scale, ``skipped_steps``, ``global_steps`` and lr are equal; the
losses within rtol 1e-4, the gradient norm within rtol 1e-4 on an applied
step and not finite on both sides on a skipped one, the masters within atol
2e-3 and their update within 2e-2 of JAX's in relative L2 (the bounds of
``tests/test_torch_fp16.py``; the port's fp16 head rounds the logits to
fp16, JAX's fused CE keeps them fp32, and the tied table's gradient sums the
head's and the embedding's). A skipped step changes no bit of the masters or
the optimizer state.

The tied table's gradient against JAX's ``loss_fn`` in fp16 is held apart
(``test_tied_head_fp16_against_jax_loss_fn``).

About 55-70 s in one process, mostly the JAX engines' first compiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.topology import MeshTopology, ParallelDims
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu_torch.models import TransformerModel
from deepspeed_tpu_torch.models.convert import params_from_numpy, params_to_numpy

from test_torch_fp16 import (LOSS_RTOL, _cfg, _host, _masters_close, _record,
                             _same, _same_norms, _same_records, _state)
from torch_bridge import TINY, family_pair, port_config

S, DOCS = 128, ((50, 78), (90, 38), (50, 78))
SPARSE = {"mode": "fixed", "block": 128, "num_local_blocks": 1, "num_global_blocks": 0}
# name: (family, kernels, power, batches)
CASES = {
    "bloom plain p16": ("bloom", False, 16, "plain"),
    "bloom kernels p30": ("bloom", True, 30, "plain"),
    "gpt2 plain p30": ("gpt2", False, 30, "plain"),
    "gpt2 kernels p16": ("gpt2", True, 16, "plain"),
    "bloom packed kernels p16": ("bloom", True, 16, "packed"),
    "llama packed kernels p30": ("llama", True, 30, "packed"),
    "llama sparse kernels p16": ("llama", True, 16, "sparse"),
}


def _packed(docs, vocab, seed):
    """Four rows packed with ``docs``: segment ids, positions restarting at
    every document, labels the next token inside it (-1 on a document's last
    token)."""
    ids = np.random.RandomState(seed).randint(0, vocab, size=(4, S))
    seg = np.concatenate([np.full(n, i) for i, n in enumerate(docs)])
    pos = np.concatenate([np.arange(n) for n in docs])
    labels = np.concatenate([ids[:, 1:], np.full((4, 1), -1)], axis=1)
    labels[:, np.cumsum(docs) - 1] = -1
    return {"input_ids": ids, "labels": labels,
            "segment_ids": np.tile(seg, (4, 1)).astype(np.int32),
            "positions": np.tile(pos, (4, 1)).astype(np.int32)}


def _batches(kind, vocab):
    if kind == "packed":
        return [_packed(docs, vocab, i) for i, docs in enumerate(DOCS)]
    n = 256 if kind == "sparse" else S
    return [{"input_ids": np.random.RandomState(i).randint(0, vocab, size=(4, n))}
            for i in range(3)]


def _config(kernels, power, kind):
    cfg = _cfg(power, 2, kernels)
    if kind == "sparse":
        cfg["sparse_attention"] = dict(SPARSE)
    return cfg


def _jax_model(family):
    if family == "llama":
        return jax_llama("llama-tiny", **TINY), None
    jm, params = family_pair(family)[:2]
    return jm, params


@pytest.mark.parametrize("name", list(CASES))
def test_fp16_train_batch_matches_tpu_engine(name):
    family, kernels, power, kind = CASES[name]
    cfg = _config(kernels, power, kind)
    jm, jparams = _jax_model(family)
    topo = MeshTopology(dims=ParallelDims(), devices=jax.devices()[:1])
    jeng, *_ = deepspeed_tpu.initialize(model=jm, config=dict(cfg), topology=topo,
                                        rng=jax.random.PRNGKey(0), model_parameters=jparams)
    m0 = _host(jeng.state.params)
    pm = TransformerModel(port_config(jm.config))
    peng, *_ = deepspeed_tpu_torch.initialize(
        model=pm, config=dict(cfg), model_parameters=params_from_numpy(pm.config, m0),
        device="cpu")
    assert peng.fp16_enabled and (peng._sparse_impl is not None) == (kind == "sparse")
    want_l, want_r, want_n, got_l, got_r, got_n = [], [], [], [], [], []
    for batch in _batches(kind, jm.config.vocab_size):
        want_l.append(float(jeng.train_batch(batch={k: jnp.asarray(v)
                                                    for k, v in batch.items()})))
        want_r.append(_record(jeng))
        want_n.append(float(jeng._metrics["grad_norm"]))
        before = _state(peng)
        got_l.append(peng.train_batch(batch=batch).item())
        got_r.append(_record(peng))
        got_n.append(float(peng._metrics["grad_norm"]))
        if peng._metrics["overflow"]:
            assert _same(_state(peng), before)
    assert _same_records(got_r, want_r)
    _same_norms(got_n, want_n)
    np.testing.assert_allclose(got_l, want_l, rtol=LOSS_RTOL)
    got, want = params_to_numpy(peng.params), _host(jeng.state.params)
    if power == 30:  # every step skipped on both sides
        assert peng.skipped_steps == 3
        jax.tree.map(np.testing.assert_array_equal, got, want)
        jax.tree.map(np.testing.assert_array_equal, got, m0)
    else:
        assert peng.skipped_steps == 0 and got_r[-1][0] == 2.0 ** (power + 1)
        _masters_close(got, want, m0)


def test_kernel_switches_on_run_the_fp16_forms(monkeypatch):
    """With the kernel switches on, the fp16 BLOOM packed step runs the
    LayerNorm and masked flash wrappers (their plain versions for CPU
    tensors) on fp16 tensors: no wrapper refuses an fp16 form."""
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import layernorm as ln

    seen = []
    real = (fa.flash_attention_fwd, ln.layernorm_fwd)

    def spy_fa(q, k, v, causal, slopes, bias, segment_ids, layout):
        seen.append(("flash", q.dtype, bias.dtype, segment_ids is not None))
        return real[0](q, k, v, causal, slopes, bias, segment_ids, layout)

    def spy_ln(x, *a, **kw):
        seen.append(("layernorm", x.dtype, a[0].dtype))
        return real[1](x, *a, **kw)

    jm, jparams, pm, params = family_pair("bloom")
    eng, *_ = deepspeed_tpu_torch.initialize(model=pm, config=_config(True, 16, "packed"),
                                             model_parameters=params, device="cpu")
    import deepspeed_tpu_torch.ops.attention as att
    import deepspeed_tpu_torch.ops.normalization as norm
    monkeypatch.setattr(att, "flash_attention_fwd", spy_fa)
    monkeypatch.setattr(norm, "layernorm_fwd", spy_ln)
    assert np.isfinite(eng.train_batch(batch=_packed(DOCS[0], 256, 0)).item())
    # the positions bias stays fp32, as JAX's does; every other operand fp16
    assert ("flash", torch.float16, torch.float32, True) in seen
    assert ("layernorm", torch.float16, torch.float16) in seen
    assert all(s[1] == torch.float16 for s in seen)


@pytest.mark.parametrize("family", ["gpt2", "bloom"])
def test_tied_head_fp16_against_jax_loss_fn(family):
    """The tied table's gradient in fp16 (ROADMAP C): the port's head
    rounds each chunk's logits to fp16 and the table sums that product's
    gradient and the embedding's, where JAX's ``loss_fn`` keeps the logits
    fp32. From the same masters, S=128, batch 4: the loss within 1e-5
    relative (measured 8.6e-7 gpt2-tiny, 1.7e-7 bloom-tiny) and the token
    table's gradient within 2e-3 of its largest element (measured 7.5e-4,
    9.7e-4)."""
    from deepspeed_tpu.models.transformer import loss_fn as jax_loss_fn
    jm, jp, pm, pp = family_pair(family)
    ids = np.random.RandomState(0).randint(0, 256, size=(4, S))
    labels = np.concatenate([ids[:, 1:], np.full((4, 1), -100)], axis=1)
    want_loss, want = jax.jit(jax.value_and_grad(lambda p: jax_loss_fn(
        jm.config, p, {"input_ids": jnp.asarray(ids), "labels": jnp.asarray(labels)},
        dtype=jnp.float16)[0]))(jp)
    leaves = jax.tree.map(lambda t: t.clone().requires_grad_(True), pp)
    loss, _ = pm.loss(leaves, {"input_ids": torch.from_numpy(ids),
                               "labels": torch.from_numpy(labels)}, dtype=torch.float16)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = params_to_numpy(jax.tree.map(lambda t: t.grad, leaves))["embed"]["tok"]
    ref = np.asarray(want["embed"]["tok"], np.float32)
    assert np.abs(got - ref).max() <= 2e-3 * np.abs(ref).max()
