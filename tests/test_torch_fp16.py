"""fp16 training with the dynamic loss scaler: ``deepspeed_tpu_torch.initialize``
with an ``fp16`` section on one device against the JAX package's
``TpuEngine`` in fp16 on one CPU device, from the same masters
(``params_from_numpy``); llama-tiny (``torch_bridge.TINY``) at S=128, batch
4, AdamW with weight decay, a warmup schedule, clipping 1.0, the JAX "auto"
knobs pinned.

- The scaler's state machine (``runtime/precision.py:update_loss_scale``)
  equals JAX's function to function under hypothesis: overflow sequences,
  hysteresis 1-3, windows 1-4, ``consecutive_hysteresis`` on and off, the
  ``min_loss_scale`` clamp, a static scale.
- ``train_batch`` against ``TpuEngine`` (3 steps; 6 at power 30): power 16
  with window 2 (the scale grows, no step overflows) and power 30 (every
  step overflows: the hysteresis, then the halvings), kernels off (the plain
  paths on both sides) and on (the kernels' plain versions here, the Pallas
  kernels in interpret mode and the chunked CE there), accumulation 1 and
  2, a mixed trajectory (power 20, window 1, hysteresis 1: good steps
  grow the scale to 2**22, whose steps overflow; every step's margin to
  the overflow is 10 % or more), and plain SGD without clipping at power 16
  and accumulation 2, whose steps all apply (its masters move by lr times
  the gradients after 1/(accum*scale), so they see a wrong factor, which
  Adam's update, invariant to a constant factor, and clipping hide). The
  scale, ``skipped_steps``, ``global_steps`` and the lr are equal every
  step; the gradient norm (of the unscaled gradients, before clipping)
  within rtol 1e-4 on an applied step (measured at most 3.9e-5) and not
  finite on both sides on a skipped one; the losses within rtol 1e-4 (fp16
  compute; measured at most 1.3e-6). The masters: under AdamW within atol
  2e-3 and the update (masters less the first masters) within 2e-2 of
  JAX's in relative L2 (measured 1.53e-3 where the largest update is
  2.0e-3, and 1.0e-2; Mixtral's 1.41e-3: fp16 rounding of the gradients,
  which Adam's normalised update turns into up to an lr on a near-zero
  element, so the elementwise bound is of the size of an update and the
  relative L2 and the gradient norm carry the check; the port's head
  rounds the logits to fp16, JAX's keeps them fp32); under SGD within atol
  1e-6 (measured 6.0e-8, the largest update 2.5e-5) and the update within
  2e-3 in relative L2 (measured 7.8e-4). On a skipped step the masters,
  the optimizer state and its counts stay bitwise as they were.
- Inside the port: ``train_batch_chain`` and the ``forward``/``backward``/
  ``step`` loop give ``train_batch``'s trajectory bitwise, skips included.
- ``mixtral-tiny`` with the ``moe`` section (ep 1) in fp16 with a static
  scale against ``TpuEngine``.
- The plain fp16 flash attention (forward, backward) and RMSNorm (forward,
  backward) against the JAX package's Pallas kernels in fp16 in interpret
  mode.
- The fp16 head's CE against JAX's fused CE in fp16 (the size of the
  port's fp16 logits rounding, ROADMAP C).
- A live scaler's checkpoint with skipped steps both ways: the port's into
  JAX's legacy ``runtime/checkpointing.py`` reader, JAX's legacy writer into
  the port (``TpuEngine.save_checkpoint`` is red on this jax, ROADMAP C),
  and a bitwise resume inside the port.
- The refusals gone: fp16 with offload, with sp > 1, with a LayerNorm
  family or a sparse_attention section trains (the families, sp and offload
  held by ``tests/test_torch_fp16_{families,sp,offload}.py``), and the same
  models and configs serve in fp16 (``tests/test_torch_fp16_serving.py``
  holds fp16 serving against JAX); the decode and matvec wrappers pick
  their fp16 entries by dtype, as the flash and norm wrappers do.

About 50-60 s in one process on 8 CPU cores.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.topology import MeshTopology, ParallelDims
from deepspeed_tpu.config import FP16Config as JaxFP16Config
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.models import mixtral as jax_mixtral
from deepspeed_tpu.ops.cross_entropy import chunked_masked_ce as jax_chunked_ce
from deepspeed_tpu.ops.pallas import flash_attention as jfa
from deepspeed_tpu.ops.pallas.rmsnorm import rmsnorm as pallas_rmsnorm
from deepspeed_tpu.runtime import checkpointing as jax_ckpt
from deepspeed_tpu.runtime import precision as jax_precision
from deepspeed_tpu_torch.config import DeepSpeedConfig, FP16Config
from deepspeed_tpu_torch.models import TransformerModel
from deepspeed_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from deepspeed_tpu_torch.ops.cross_entropy import chunked_masked_ce
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
from deepspeed_tpu_torch.ops.cuda import rmsnorm as rn
from deepspeed_tpu_torch.runtime import precision
from deepspeed_tpu_torch.runtime.engine import TorchEngine
from deepspeed_tpu_torch.utils.tree import tree_leaves

from torch_bridge import TINY, port_config

S = 128
LOSS_RTOL = 1e-4
GRAD_NORM_RTOL = 1e-4
MASTER_ATOL, UPDATE_RTOL = 2e-3, 2e-2  # Adam's
SGD_BOUNDS = (1e-6, 2e-3)  # (atol, rtol) of the plain SGD case's masters
KERNELS_ON = {"flash_attention": True, "fused_rmsnorm": True, "fused_adam": True,
              "fused_ce": True, "ce_chunk": 100}  # V=256: two chunks and a tail


def _cfg(power=16, window=2, kernels=False, accum=1, static=0.0, hysteresis=2, opt="adamw",
         clip=1.0):
    return {
        "train_batch_size": 4, "gradient_accumulation_steps": accum,
        "optimizer": {"type": opt, "params": {"lr": 1e-3, "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_num_steps": 3, "warmup_type": "linear"}},
        "gradient_clipping": clip, "steps_per_print": 100,
        "fp16": {"enabled": True, "initial_scale_power": power, "loss_scale": static,
                 "loss_scale_window": window, "hysteresis": hysteresis},
        "tpu_kernels": KERNELS_ON if kernels else {},
        # explicit values for the JAX engine's "auto" knobs (ROADMAP C)
        "zero_optimization": {"stage": 0, "grad_wire": "fp32", "param_wire": "fp32"},
        "serving": {"moe_a2a": "stock", "kv_cache_dtype": "bf16"},
    }


# name: (config, steps)
CASES = {
    "p16 w2 plain a1": (_cfg(16, 2), 3),
    "p30 kernels a2": (_cfg(30, 1000, True, 2), 6),
    "mixed kernels a1": (_cfg(20, 1, True, hysteresis=1), 6),
    # plain SGD without clipping: the masters move by lr times the unscaled
    # gradients, so they see a wrong 1/scale or 1/accum
    "sgd noclip p16 w2 plain a2": (_cfg(16, 2, False, 2, opt="sgd", clip=0.0), 3),
}
MIXED = "mixed kernels a1"
CKPT_AT = 4  # the mixed run's checkpoint step: one skip behind it


def _batches(n, seed=0):
    r = np.random.RandomState(seed)
    return [{"input_ids": r.randint(0, TINY["vocab_size"], size=(4, S))} for _ in range(n)]


def _host(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def _record(eng):
    """(scale, skipped_steps, global_steps, lr) after a step."""
    return (float(eng.loss_scale), eng.skipped_steps, eng.global_steps, float(eng.lr))


def _same_norms(got, want):
    """The steps' gradient norms (of the unscaled gradients, before
    clipping): within GRAD_NORM_RTOL on an applied step, not finite on both
    sides on a skipped one."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    finite = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite], want[finite], rtol=GRAD_NORM_RTOL)


def _same_records(got, want):
    """Equal records: the scale and counts exactly, the lr to fp32 rounding
    (JAX's schedule computes in fp32, the port's in Python floats)."""
    got, want = list(got), list(want)
    return len(got) == len(want) and all(
        g[:3] == w[:3] and g[3] == pytest.approx(w[3], rel=1e-6) for g, w in zip(got, want))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Each case's TpuEngine run from its initial masters: per step the loss
    and :func:`_record`; the masters at the start and the end; the mixed
    run's legacy checkpoint at step CKPT_AT and its engine."""
    d = tmp_path_factory.mktemp("fp16")
    jm = jax_llama("llama-tiny", **TINY)
    topo = MeshTopology(dims=ParallelDims(), devices=jax.devices()[:1])
    runs = {}
    for name, (cfg, steps) in CASES.items():
        eng, *_ = deepspeed_tpu.initialize(model=jm, config=dict(cfg), topology=topo,
                                           rng=jax.random.PRNGKey(0))
        run = {"m0": _host(eng.state.params), "losses": [], "records": [], "norms": []}
        for i, b in enumerate(_batches(steps)):
            run["losses"].append(float(eng.train_batch(batch=b)))
            run["records"].append(_record(eng))
            run["norms"].append(float(eng._metrics["grad_norm"]))
            if name == MIXED and i + 1 == CKPT_AT:
                jax_ckpt.save_checkpoint(eng, str(d / "jax"))
        run["params"] = _host(eng.state.params)
        run["engine"] = eng
        runs[name] = run
    return {"runs": runs, "dir": d, "model": jm}


def _port(cfg, m0=None, seed=None):
    pm = TransformerModel(port_config(jax_llama("llama-tiny", **TINY).config))
    kw = {"model_parameters": params_from_numpy(pm.config, m0)} if m0 is not None else {
        "rng": torch.Generator().manual_seed(seed)}
    eng, *_ = deepspeed_tpu_torch.initialize(model=pm, config=dict(cfg), device="cpu", **kw)
    return eng


def _state(eng):
    """The masters and optimizer state with their counts, as numpy copies."""
    return [np.array(t.detach().numpy() if torch.is_tensor(t) else t, copy=True)
            for comp in ("params", "opt_state") for _, t in eng.checkpoint_components()[comp]]


def _same(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def _masters_close(got, want, m0, atol=MASTER_ATOL, rtol=UPDATE_RTOL):
    """Masters within ``atol`` of JAX's, and the update from ``m0`` within
    ``rtol`` of JAX's in relative L2."""
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, atol=atol), got, want)
    num = sum(float(np.sum((g - w) ** 2)) for g, w in
              zip(jax.tree.leaves(got), jax.tree.leaves(want)))
    den = sum(float(np.sum((w - a) ** 2)) for w, a in
              zip(jax.tree.leaves(want), jax.tree.leaves(m0)))
    assert (num / den) ** 0.5 <= rtol


# -------------------------------------------------------------- the scaler
@settings(max_examples=60, deadline=None, database=None)
@given(overflows=st.lists(st.booleans(), min_size=1, max_size=12),
       power=st.integers(0, 24), window=st.integers(1, 4), hysteresis=st.integers(1, 3),
       consecutive=st.booleans(), min_power=st.integers(-2, 24),
       static=st.sampled_from([0.0, 0.0, 0.0, 128.0]))
def test_scaler_matches_jax(overflows, power, window, hysteresis, consecutive, min_power,
                            static):
    knobs = dict(enabled=True, loss_scale=static, initial_scale_power=power,
                 loss_scale_window=window, hysteresis=hysteresis,
                 consecutive_hysteresis=consecutive, min_loss_scale=2.0 ** min_power)
    pcfg, jcfg = FP16Config(**knobs), JaxFP16Config(**knobs)
    got = precision.init_loss_scale(pcfg, True)
    want = jax_precision.init_loss_scale(jcfg, True)
    for overflow in overflows:
        assert (float(got.scale), int(got.good_steps), int(got.hysteresis_left)) == \
            (float(want.scale), int(want.good_steps), int(want.hysteresis_left))
        got = precision.update_loss_scale(got, overflow, pcfg, True)
        want = jax_precision.update_loss_scale(want, jnp.asarray(overflow), jcfg, True)
    assert (float(got.scale), int(got.good_steps), int(got.hysteresis_left)) == \
        (float(want.scale), int(want.good_steps), int(want.hysteresis_left))
    assert isinstance(got.scale, np.float32)


def test_scaler_off_and_unscale():
    """fp16 off: the state never moves (scale 1). ``unscale_`` multiplies
    in fp32 and flags a non-finite element anywhere, a NaN too, and a finite
    element that a factor above 1 carries past fp32's range."""
    cfg = FP16Config()
    s = precision.init_loss_scale(cfg, False)
    assert precision.update_loss_scale(s, True, cfg, False) == s and float(s.scale) == 1.0
    r = np.random.RandomState(1)
    want = [r.randn(4).astype(np.float32), r.randn(3, 2).astype(np.float32)]
    inv = float(np.float32(1.0) / np.float32(3 * 65536.0))
    g = [torch.from_numpy(w.copy()) for w in want]
    assert precision.unscale_(g, inv).item() == 0.0
    for got, w in zip(g, want):
        np.testing.assert_array_equal(got.numpy(), w * np.float32(inv))
    for bad in (float("inf"), float("-inf"), float("nan")):
        g[1][2, 1] = bad
        assert precision.unscale_(g, inv).item() == 1.0
    g = [torch.ones(2), torch.tensor([3e38])]
    assert precision.unscale_(g, 4.0).item() == 1.0 and torch.isinf(g[1]).all()


# ----------------------------------------------------- against TpuEngine
@pytest.mark.parametrize("name", list(CASES))
def test_train_batch_matches_tpu_engine(jax_runs, name):
    cfg, steps = CASES[name]
    want = jax_runs["runs"][name]
    eng = _port(cfg, want["m0"])
    losses, records, norms = [], [], []
    for b in _batches(steps):
        before = _state(eng)
        losses.append(eng.train_batch(batch=b).item())
        records.append(_record(eng))
        norms.append(float(eng._metrics["grad_norm"]))
        if eng._metrics["overflow"]:  # a skipped step changes no bit of the state
            assert _same(_state(eng), before)
    assert _same_records(records, want["records"])
    _same_norms(norms, want["norms"])
    assert eng.update_count == steps - eng.skipped_steps
    np.testing.assert_allclose(losses, want["losses"], rtol=LOSS_RTOL)
    got, m0 = params_to_numpy(eng.params), want["m0"]
    if eng.skipped_steps == steps:  # nothing updated on either side
        jax.tree.map(np.testing.assert_array_equal, got, want["params"])
        jax.tree.map(np.testing.assert_array_equal, got, m0)
        return
    _masters_close(got, want["params"], m0,
                   *(SGD_BOUNDS if cfg["optimizer"]["type"] == "sgd" else ()))


def test_chain_and_loop_match_train_batch(jax_runs):
    """The mixed trajectory (skips and growth) through ``train_batch``,
    ``train_batch_chain`` and the forward/backward/step loop: the same
    losses, scales, skips and masters, bit for bit."""
    cfg, steps = CASES[MIXED]
    m0, batches = jax_runs["runs"][MIXED]["m0"], _batches(steps)
    base = _port(cfg, m0)
    want = [base.train_batch(batch=b).item() for b in batches]
    want_rec = _record(base)
    chain = _port(cfg, m0)
    got = chain.train_batch_chain(data_iter=iter(batches), steps=steps).tolist()
    assert got == want and _record(chain) == want_rec
    ms = chain.last_chain_metrics
    assert int(ms["overflow"].sum()) == chain.skipped_steps > 0
    assert ms["loss_scale"].tolist() == [r[0] for r in jax_runs["runs"][MIXED]["records"]]
    loop = _port(cfg, m0)
    looped = []
    for b in batches:
        loop.backward(loop(b))
        looped.append(loop.step().item())
    assert looped == want and _record(loop) == want_rec
    for eng in (chain, loop):
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(eng.params),
                                                     tree_leaves(base.params)))


def test_fused_adam_takes_fp32_masters_and_gradients(jax_runs, monkeypatch):
    """Under fp16 the fused Adam kernel stays as it is: each launch updates
    fp32 masters and moments from the fp32 gradients (unscaled, the micro-
    batches' sum in fp32), one launch a leaf."""
    from deepspeed_tpu_torch.runtime import optimizers
    seen = []
    real = optimizers.adam_update

    def spy(p, g, m, v, **kw):
        seen.append({t.dtype for t in (p, g, m, v)})
        return real(p, g, m, v, **kw)

    monkeypatch.setattr(optimizers, "adam_update", spy)
    cfg, _ = CASES["p30 kernels a2"]
    eng = _port(cfg, jax_runs["runs"][MIXED]["m0"])
    eng._loss_scale = precision.init_loss_scale(FP16Config(initial_scale_power=8), True)
    eng.train_batch(batch=_batches(1)[0])
    assert eng.skipped_steps == 0 and eng.tpu_kernels.fused_adam
    assert len(seen) == len(tree_leaves(eng.params))
    assert all(s == {torch.float32} for s in seen)


def test_mixtral_tiny_ep1_matches_tpu_engine():
    """eps 1e-6, as ``tests/test_torch_moe_training.py`` has it: at Adam's
    1e-8 the expert banks' near-cancelled micro-batch gradients, normalised,
    put the update 5.2e-2 from JAX's (1.0e-2 at 1e-6, max 1.41e-3)."""
    jm = jax_mixtral("mixtral-tiny", vocab_size=256, max_seq_len=512)
    cfg = {**_cfg(static=1024.0), "moe": {"enabled": True, "ep_size": 1}}
    cfg["optimizer"]["params"]["eps"] = 1e-6
    topo = MeshTopology(dims=ParallelDims(), devices=jax.devices()[:1])
    jeng, *_ = deepspeed_tpu.initialize(model=jm, config=dict(cfg), topology=topo,
                                        rng=jax.random.PRNGKey(0))
    m0 = _host(jeng.state.params)
    pm = TransformerModel(port_config(jm.config))
    peng, *_ = deepspeed_tpu_torch.initialize(model=pm, config=dict(cfg), device="cpu",
                                              model_parameters=params_from_numpy(pm.config, m0))
    r = np.random.RandomState(3)
    for _ in range(3):
        batch = {"input_ids": r.randint(0, 256, size=(4, 64))}
        jl = float(jeng.train_batch(batch=batch))
        np.testing.assert_allclose(peng.train_batch(batch=batch).item(), jl, rtol=LOSS_RTOL)
        assert _same_records([_record(peng)], [_record(jeng)])
        _same_norms([float(peng._metrics["grad_norm"])], [float(jeng._metrics["grad_norm"])])
        np.testing.assert_allclose(float(peng._metrics["moe_aux_loss"]),
                                   float(jeng._metrics["moe_aux_loss"]), rtol=LOSS_RTOL)
    _masters_close(params_to_numpy(peng.params), _host(jeng.state.params), m0)


# ------------------------------------------------- kernels' plain versions
def test_plain_fp16_flash_matches_pallas():
    """The port's plain flash attention in fp16 (what a CPU tensor takes;
    the fp16 kernel's function on the card) against the Pallas forward and
    backward in fp16 in interpret mode, causal GQA at head dim 64: out
    within 2e-3 (the Pallas kernel rounds p to fp16 before P V, the plain
    version keeps it fp32), lse within 1e-4, the gradients within 5e-3 of
    the largest."""
    r = np.random.RandomState(7)
    B, Sq, H, KV, D = 1, 128, 4, 2, 64
    q, k, v, do = (r.randn(*shape).astype(np.float16) for shape in
                   ((B, Sq, H, D), (B, Sq, KV, D), (B, Sq, KV, D), (B, Sq, H, D)))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = fa.flash_attention_fwd(tq, tk, tv, causal=True)
    dq, dk, dv = fa.flash_attention_bwd(tq, tk, tv, out, lse, tdo, causal=True)
    sw = lambda t: jnp.swapaxes(jnp.asarray(t), 1, 2)  # noqa: E731
    scale = 1.0 / D ** 0.5
    jo, jlse = jfa._flash_fwd(sw(q), sw(k), sw(v), None, None, None, None, causal=True,
                              scale=scale, block_q=128, block_k=128, interpret=True)
    jdq, jdk, jdv = jfa._flash_bwd(sw(q), sw(k), sw(v), jo, jlse, sw(do), None, None, None,
                                   None, causal=True, scale=scale, block_q=128, block_k=128,
                                   interpret=True)[:3]
    assert out.dtype == dq.dtype == torch.float16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(sw(jo), np.float32), atol=2e-3)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0], atol=1e-4)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        want = np.asarray(sw(want), np.float32)
        assert np.abs(got.float().numpy() - want).max() <= 5e-3 * np.abs(want).max()


def test_plain_fp16_rmsnorm_matches_pallas():
    """The plain RMSNorm forward and backward in fp16 against the Pallas
    kernels in fp16 in interpret mode: out, dx and dscale (fp32 here, which
    the autograd Function casts to the scale's fp16 as the Pallas VJP
    returns it) within two fp16 ulps."""
    r = np.random.RandomState(8)
    x = r.randn(64, 256).astype(np.float16)
    w = (1 + 0.1 * r.randn(256)).astype(np.float16)
    g = r.randn(64, 256).astype(np.float16)
    tx, tw, tg = (torch.from_numpy(a) for a in (x, w, g))
    out = rn.rmsnorm_fwd(tx, tw)
    dx, ds = rn.rmsnorm_bwd(tx, tw, tg)
    jout, vjp = jax.vjp(lambda a, b: pallas_rmsnorm(a, b, 1e-5), jnp.asarray(x), jnp.asarray(w))
    jdx, jds = vjp(jnp.asarray(g))
    assert out.dtype == dx.dtype == torch.float16
    for got, want in ((out, jout), (dx, jdx)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, atol=1e-3, rtol=2e-3)
    np.testing.assert_allclose(ds.to(torch.float16).float().numpy(),
                               np.asarray(jds, np.float32), atol=1e-3, rtol=2e-3)


def test_fp16_head_ce_against_jax_fused_ce():
    """The port's fp16 head rounds each chunk's logits to fp16 (the product
    in the compute dtype), where JAX's fused CE accumulates them in fp32:
    the CE within 2e-5 relative and the hidden states' and head's gradients
    within 4e-3 of the largest (measured 1.49e-6, 4.06e-4 and 3.00e-4; the
    port's dense head gives the same numbers)."""
    r = np.random.RandomState(9)
    N, d, V = 96, 64, 256
    y = (r.randn(N, d) * 0.5).astype(np.float16)
    head = (r.randn(d, V) * 0.2).astype(np.float32)
    labels = r.randint(0, V, size=(N,))
    labels[:5] = -100
    jl, jgrads = jax.jit(jax.value_and_grad(
        lambda a, h: jax_chunked_ce(a, h, jnp.asarray(labels), chunk=100)[0],
        argnums=(0, 1)))(jnp.asarray(y), jnp.asarray(head))
    ty = torch.from_numpy(y).requires_grad_(True)
    th = torch.from_numpy(head).requires_grad_(True)
    ce, _ = chunked_masked_ce(ty, th, torch.from_numpy(labels), 100)
    ce.backward()
    np.testing.assert_allclose(ce.item(), float(jl), rtol=2e-5)
    for got, want in ((ty.grad, jgrads[0]), (th.grad, jgrads[1])):
        want = np.asarray(want, np.float32)
        assert np.abs(got.float().numpy() - want).max() <= 4e-3 * np.abs(want).max()


# ------------------------------------------------------------ checkpoints
def test_live_scaler_checkpoint_both_ways(jax_runs, tmp_path):
    """The mixed run's state at step CKPT_AT (a skip behind it, the scale
    grown past its start): the port's checkpoint loads in JAX's legacy
    reader and JAX's in the port, each with the scaler, the counts and the
    masters as written; the two steps after it match JAX's uninterrupted
    run; inside the port the resume is bitwise."""
    cfg, steps = CASES[MIXED]
    run = jax_runs["runs"][MIXED]
    batches = _batches(steps)
    peng = _port(cfg, run["m0"])
    for b in batches[:CKPT_AT]:
        peng.train_batch(batch=b)
    assert peng.skipped_steps >= 1 and peng.update_count == CKPT_AT - peng.skipped_steps
    saved = (_record(peng), tuple(peng._loss_scale), _state(peng))
    masters = _host(params_to_numpy(peng.params))
    peng.save_checkpoint(str(tmp_path / "port"))
    after = [peng.train_batch(batch=b).item() for b in batches[CKPT_AT:]]

    # port -> JAX: the legacy reader takes the scaler, the counts, the masters
    jeng = run["engine"]
    jax_ckpt.load_checkpoint(jeng, str(tmp_path / "port"))
    ls = jeng.state.loss_scale
    assert (float(ls.scale), int(ls.good_steps), int(ls.hysteresis_left)) == \
        tuple(float(x) for x in saved[1])
    skipped = saved[0][1]
    assert (int(jeng.state.step), jeng.skipped_steps, jeng.global_steps) == \
        (CKPT_AT - skipped, skipped, CKPT_AT)
    jax.tree.map(np.testing.assert_array_equal, _host(jeng.state.params), masters)
    jl = [float(jeng.train_batch(batch=b)) for b in batches[CKPT_AT:]]
    np.testing.assert_allclose(jl, after, rtol=LOSS_RTOL)
    assert _same_records([_record(jeng)], [_record(peng)])

    # JAX -> port: a port engine from other masters loads JAX's step-4 tag
    fresh = _port(cfg, seed=5)
    fresh.load_checkpoint(str(jax_runs["dir"] / "jax"))
    rec = run["records"][CKPT_AT - 1]
    assert (float(fresh.loss_scale), fresh.skipped_steps, fresh.global_steps) == rec[:3]
    assert fresh.update_count == CKPT_AT - rec[1]
    got = [fresh.train_batch(batch=b).item() for b in batches[CKPT_AT:]]
    np.testing.assert_allclose(got, run["losses"][CKPT_AT:], rtol=LOSS_RTOL)
    assert _same_records([_record(fresh)], [run["records"][-1]])

    # inside the port: bitwise
    resumed = _port(cfg, seed=6)
    resumed.load_checkpoint(str(tmp_path / "port"))
    assert (_record(resumed), tuple(resumed._loss_scale)) == saved[:2]
    assert _same(_state(resumed), saved[2])
    assert [resumed.train_batch(batch=b).item() for b in batches[CKPT_AT:]] == after
    assert _record(resumed) == _record(peng)
    assert _same(_state(resumed), _state(peng))


# ---------------------------------------------------------------- refusals
def _model(family="llama"):
    if family == "llama":
        return TransformerModel(port_config(jax_llama("llama-tiny", **TINY).config))
    from torch_bridge import family_pair
    return family_pair(family)[2]


# fp16 is refused nowhere bf16 trains or serves: the configs once refused
# train, and the same models serve in fp16 (a few greedy tokens on the CPU)
def _serves_fp16(model, **serving):
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    eng = InferenceEngine(model, device=torch.device("cpu"), dtype=torch.float16,
                          rng=torch.Generator().manual_seed(0), **serving)
    out = eng.generate(np.arange(12)[None, :] % model.config.vocab_size, max_new_tokens=4)
    assert out.shape == (1, 16) and eng.dtype == torch.float16


@pytest.mark.parametrize("extra,serving", [
    ({"zero_optimization": {"stage": 1, "offload_optimizer": {"device": "cpu"}}}, {}),
    ({"zero_optimization": {"stage": 3, "offload_param": {"device": "cpu"},
                            "offload_optimizer": {"device": "cpu"}}},
     {"quantize_bits": 8}),
    ({"sequence_parallel": {"sp_size": 2, "mode": "ring"}}, {"kv_cache_dtype": "int8"}),
])
def test_fp16_refused_by_name(extra, serving):
    """The fp16 configs once refused (offload, parameter offload, sp > 1)
    pass ``unported_features``; each form of the inference engine once
    refused in fp16 on a card (dense, 8-bit weights, the int8 KV cache)
    builds and serves in fp16 (here on the CPU: the card's kernels take
    fp16 since fp16 serving was ported, ``tests/test_torch_fp16_serving.py``)."""
    from deepspeed_tpu_torch.runtime.engine import unported_features
    cfg = DeepSpeedConfig({**_cfg(), **extra})
    assert unported_features(cfg) == []
    _serves_fp16(_model(), **serving)


@pytest.mark.parametrize("family,extra", [
    ("gpt2", {}), ("bloom", {}),
    ("llama", {"sparse_attention": {"mode": "fixed", "block": 128}}),
])
def test_fp16_on_a_card_refuses_later_forms(family, extra):
    """Each family once refused fp16 serving on a CUDA device serves in fp16
    (here on the CPU), and fp16 training of the same model and config (a
    LayerNorm family, a sparse_attention section) trains; what a card still
    refuses at start-up, before any tensor reaches it, is a dtype its
    kernels do not take (fp32: ROADMAP C, by design)."""
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    model = _model(family)
    _serves_fp16(model)
    with pytest.raises(NotImplementedError, match="bfloat16 or float16"):
        InferenceEngine(model, device=torch.device("cuda"), dtype=torch.float32)
    eng, *_ = deepspeed_tpu_torch.initialize(model=model, config={**_cfg(), **extra},
                                             device="cpu", rng=torch.Generator().manual_seed(0))
    assert np.isfinite(eng.train_batch(batch=_batches(1)[0]).item())


def test_kernel_wrappers_refuse_fp16_forms_not_ported():
    """No fp16 form is left unported: the dtype code of fp16 is 2 for every
    kernel (no refusal, no flag), and every wrapper picks its fp16 entry by
    its input's dtype: every flash form and the bias gradient, the decode
    forms (the fp16 entries taking the cache's code: fp16, bf16 for the
    mixed form, fp16 for int8) and the packed matvec; each fp16 entry has
    its argument types. An fp16 x with a scale of another dtype is not a
    pair the model passes."""
    from types import SimpleNamespace

    from deepspeed_tpu_torch.ops.cuda import _build
    from deepspeed_tpu_torch.ops.cuda import decode_attention as dec

    assert _build.dtype_code(torch.float16) == 2 and not hasattr(_build, "FP16_LATER")
    with pytest.raises(ValueError, match="no CUDA kernel"):
        _build.dtype_code(torch.int16)
    lib = SimpleNamespace(**{f"dst_{n}{s}": n + s for n in fa.KERNEL_NAMES +
                             ("flash_attention_bias_grad",) + dec.KERNEL_NAMES
                             for s in ("", "_f16")})
    q = torch.zeros(1, 8, 2, 64, dtype=torch.float16)
    for name in fa.KERNEL_NAMES + ("flash_attention_bias_grad",):
        assert fa._entry(lib, name, q) == name + "_f16"
        assert fa._entry(lib, name, q.bfloat16()) == name
    k16, kb, k8 = q, q.bfloat16(), q.to(torch.int8)
    for name in dec.KERNEL_NAMES:
        int8 = name.endswith("int8")
        assert dec._entry(lib, name, q, k8 if int8 else k16, int8, False) == (
            name + "_f16", 2, "_f16")
        assert dec._entry(lib, name, q.bfloat16(), k8 if int8 else kb, int8, False) == (
            name, 1, "")
        if not int8:
            assert dec._entry(lib, name, q, kb, False, True) == (name + "_f16", 1, "_mixed_f16")
        assert f"dst_{name}_f16" in _build.SIGNATURES
        assert _build.SIGNATURES[f"dst_{name}_f16"] == _build.SIGNATURES[f"dst_{name}"]
    assert _build.SIGNATURES["dst_quantized_expert_matvec_f16"] == \
        _build.SIGNATURES["dst_quantized_expert_matvec"]
    for fn in ("dst_layernorm_fwd_f16", "dst_layernorm_bwd_f16",
               "dst_flash_attention_bias_grad_f16"):
        assert fn in _build.SIGNATURES
    with pytest.raises(ValueError, match="fp16 x takes an fp16 scale"):
        rn._check("rmsnorm_fwd", q.reshape(-1, 64), torch.ones(64))


def test_fp16_config_knobs():
    assert dataclasses.asdict(FP16Config()) == {
        k: v for k, v in dataclasses.asdict(JaxFP16Config()).items()}
    assert FP16Config(initial_scale_power=5).initial_scale == 32.0
    assert FP16Config(loss_scale=3.0).initial_scale == 3.0 and not FP16Config(
        loss_scale=3.0).dynamic
