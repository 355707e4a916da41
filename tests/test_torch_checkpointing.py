"""Checkpointing: the port's ``save_checkpoint`` / ``load_checkpoint`` against
the JAX package's checkpoint layout, on a one-layer llama-tiny at S=32 and
batch 4 (``tests/test_torch_optimizers.py``'s size). The JAX side uses its
module ``runtime/checkpointing.py`` (``save_checkpoint``, ``load_checkpoint``,
``load_params``) and ``zero.py``: ``TpuEngine.save_checkpoint`` goes through
``runtime/ckpt``, which imports ``deepspeed_tpu.analysis`` and is red on this
jax. Both write and read the same files.

- port → JAX and JAX → port, for every optimizer of the port (AdamW plain and
  through the fused kernel, lion, adagrad, lamb, sgd at momentum 0 and 0.9):
  a checkpoint after 2 steps resumes in the other package, and its 2 more
  steps match the uninterrupted JAX run: losses rtol 1e-5, masters atol 2e-5
  (``tests/test_torch_training.py``'s tolerances, fp32);
- a JAX ZeRO-3 checkpoint of a dp=4 mesh (the Adam moments four shard files
  each) loads into the port's one-device engine: masters and moments equal
  JAX's, assembled, bitwise;
- inside the port the resume is bitwise (losses, masters, optimizer state),
  for every optimizer in fp32 and in bf16 with accumulation 2, and for
  ``mixtral-tiny`` with the ``moe`` section;
- leaves are matched by name where the packages' tree orders differ (BLOOM's
  ``embed_norm``, Mixtral's expert banks);
- the commit rule: a torn tag is refused by name and skipped by ``latest``,
  ``keep_last`` prunes, an async save's files are byte for byte a sync
  save's, a writer's exception surfaces at the next fence, async saves reuse
  one pinned generation, SIGTERM commits a final save and its registry keeps
  no engine alive; ``strict=False`` keeps a missing or reshaped leaf; an
  Orbax component and a wrong update count are refused;
- on a dp=2 gloo world of spawned ranks, rank 0 writes and every rank
  resumes bitwise;
- ``init_inference(checkpoint=)`` gives JAX's greedy tokens on the same
  directory, and each leaf its own weights where the checkpoint records no
  names; ``zero_to_fp32`` gives JAX's npz, and the script dropped into a
  checkpoint root runs with no jax importable.
"""

import dataclasses
import gc
import json
import os
import signal
import threading
import types
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu import zero as jax_zero
from deepspeed_tpu.comm.topology import MeshTopology, ParallelDims
from deepspeed_tpu.config import FP16Config
from deepspeed_tpu.config import OptimizerConfig as JaxOptimizerConfig
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.models import mixtral as jax_mixtral
from deepspeed_tpu.runtime import checkpointing as jax_ckpt
from deepspeed_tpu.runtime.optimizers import build_optimizer as jax_build_optimizer
from deepspeed_tpu.runtime.precision import LossScaleState, init_loss_scale
from deepspeed_tpu_torch.config import DeepSpeedConfigError
from deepspeed_tpu_torch.launcher import launch_local
from deepspeed_tpu_torch.models import TransformerModel
from deepspeed_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from deepspeed_tpu_torch.models.transformer import param_specs
from deepspeed_tpu_torch.runtime import checkpointing as ckpt
from deepspeed_tpu_torch.runtime.ckpt import (UncommittedCheckpointError, async_writer,
                                             latest_committed_tag, reset_preempt_handler)
from deepspeed_tpu_torch.runtime.swap_tensor import PinnedBufferPool
from deepspeed_tpu_torch.utils.tree import tree_items, tree_map, tree_paths

import torch_sp_worker
from torch_bridge import TINY, family_pair, port_config

ONE_LAYER = {**TINY, "num_layers": 1}
OPTIMIZERS = {
    "adamw": ({"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.01}}, {}),
    "fusedadam": ({"type": "FusedAdam", "params": {"lr": 1e-3, "weight_decay": 0.01}},
                  {"fused_adam": True}),
    "lion": ({"type": "lion", "params": {"lr": 1e-3, "weight_decay": 0.1,
                                         "betas": [0.9, 0.99]}}, {}),
    "adagrad": ({"type": "adagrad", "params": {"lr": 1e-2, "weight_decay": 0.1}}, {}),
    "lamb": ({"type": "lamb", "params": {"lr": 1e-3, "weight_decay": 0.1, "eps": 1e-6}}, {}),
    "sgd": ({"type": "sgd", "params": {"lr": 1e-2, "weight_decay": 0.1}}, {}),
    "sgd-momentum": ({"type": "sgd", "params": {"lr": 1e-2, "weight_decay": 0.1,
                                                "momentum": 0.9}}, {}),
}


def _cfg(name="adamw", dtype="fp32", accum=1, **extra):
    opt, kernels = OPTIMIZERS[name]
    return {
        "train_batch_size": 4, "gradient_accumulation_steps": accum, "optimizer": opt,
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_num_steps": 4, "warmup_type": "linear"}},
        "gradient_clipping": 1.0, "steps_per_print": 100,
        "bf16": {"enabled": dtype == "bf16"}, "tpu_kernels": kernels,
        # explicit values for the JAX engine's "auto" knobs (ROADMAP C)
        "zero_optimization": {"stage": 0, "grad_wire": "fp32", "param_wire": "fp32"},
        "serving": {"moe_a2a": "stock", "kv_cache_dtype": "bf16"},
        **extra,
    }


def _batches(n=4, seed=0, rows=4):
    r = np.random.RandomState(seed)
    return [{"input_ids": r.randint(0, 256, size=(rows, 32))} for _ in range(n)]


def _jax_engine(cfg, devices=1):
    jm = jax_llama("llama-tiny", **ONE_LAYER)
    dims = ParallelDims(dp=devices) if devices > 1 else ParallelDims()
    topo = MeshTopology(dims=dims, devices=jax.devices()[:devices])
    eng, *_ = deepspeed_tpu.initialize(model=jm, config=dict(cfg), topology=topo,
                                       rng=jax.random.PRNGKey(0))
    return eng


def _port_engine(cfg, masters=None, model=None, seed=None):
    model = model or TransformerModel(port_config(jax_llama("llama-tiny", **ONE_LAYER).config))
    kw = {"model_parameters": params_from_numpy(model.config, masters)} if masters else {}
    if seed is not None:
        kw["rng"] = torch.Generator().manual_seed(seed)
    eng, *_ = deepspeed_tpu_torch.initialize(model=model, config=dict(cfg), device="cpu", **kw)
    return eng


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _named_jax(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _named_port(eng):
    return {n: (t.detach().numpy() if torch.is_tensor(t) else t)
            for comp in ("params", "opt_state") for n, t in eng.checkpoint_components()[comp]}


def _state(eng):
    return [t.detach().clone() for comp in ("params", "opt_state")
            for _, t in eng.checkpoint_components()[comp] if torch.is_tensor(t)]


def _masters_close(port_params, jax_params, atol=2e-5):
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, atol=atol),
                 params_to_numpy(port_params), _host(jax_params))


# ------------------------------------------------ across the two packages
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_resume_across_packages(name, tmp_path):
    cfg = _cfg(name)
    jeng = _jax_engine(cfg)
    m0 = _host(jeng.state.params)
    batches = _batches()
    want = [float(jeng.train_batch(batch=b)) for b in batches[:2]]
    jax_ckpt.save_checkpoint(jeng, str(tmp_path / "jax"))
    want += [float(jeng.train_batch(batch=b)) for b in batches[2:]]
    want_params = _host(jeng.state.params)

    # port → JAX: the port's 2 steps from the same masters, resumed by JAX
    peng = _port_engine(cfg, m0)
    got = [peng.train_batch(batch=b).item() for b in batches[:2]]
    np.testing.assert_allclose(got, want[:2], rtol=1e-5)
    peng.save_checkpoint(str(tmp_path / "port"))
    jax_ckpt.load_checkpoint(jeng, str(tmp_path / "port"))
    assert (jeng.global_steps, int(jeng.state.step)) == (2, 2)
    got = [float(jeng.train_batch(batch=b)) for b in batches[2:]]
    np.testing.assert_allclose(got, want[2:], rtol=1e-5)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, atol=2e-5),
                 _host(jeng.state.params), want_params)

    # JAX → port: a port engine from other masters resumes JAX's checkpoint
    peng = _port_engine(cfg, seed=5)
    path, client = peng.load_checkpoint(str(tmp_path / "jax"))
    assert path.endswith("global_step2") and client == {} and peng.global_steps == 2
    got = [peng.train_batch(batch=b).item() for b in batches[2:]]
    np.testing.assert_allclose(got, want[2:], rtol=1e-5)
    _masters_close(peng.params, want_params)


def _jax_stub(params, opt_state=(), steps=0, micro_steps=0, loss_scale=None):
    """The fields of a TpuEngine that JAX's ``save_checkpoint`` reads, for its
    own writer to save a state built here."""
    ls = loss_scale or LossScaleState(jnp.asarray(1.0), jnp.asarray(0, jnp.int32),
                                      jnp.asarray(2, jnp.int32))
    return types.SimpleNamespace(
        state=types.SimpleNamespace(params=params, opt_state=opt_state, loss_scale=ls,
                                    step=jnp.asarray(steps, jnp.int32)),
        global_steps=steps, micro_steps=micro_steps, skipped_steps=0,
        _rng=jax.random.PRNGKey(1234),
        config=types.SimpleNamespace(zero_config=types.SimpleNamespace(stage=0)),
        topology=types.SimpleNamespace(world_size=1))


def test_port_checkpoint_has_jax_names_and_layout(tmp_path):
    """The port's state after one step, saved by each package's writer (JAX's
    into its own trees): the same metadata and leaf names per component, the
    same files, the same bytes in every shard file."""
    cfg = _cfg("adamw")
    jparams = jax_llama("llama-tiny", **ONE_LAYER).init(jax.random.PRNGKey(0))
    peng = _port_engine(cfg, _host(jparams))
    peng.train_batch(batch=_batches(1)[0])
    named = _named_port(peng)

    def put(tree):
        return jax.tree_util.tree_map_with_path(
            lambda p, v: jnp.asarray(named[jax.tree_util.keystr(p)]), tree)

    # the trees a TpuEngine holds: its optax chain's state, the static loss scale
    tx = jax_build_optimizer(JaxOptimizerConfig(**cfg["optimizer"]), lambda step: 1e-3)
    jax_ckpt.save_checkpoint(
        _jax_stub(put(jparams), put(tx.init(jparams)), 1, 1,
                  init_loss_scale(FP16Config(), False)), str(tmp_path / "jax"))
    peng.save_checkpoint(str(tmp_path / "port"))
    jm = json.loads((tmp_path / "jax/global_step1/metadata.json").read_text())
    pm = json.loads((tmp_path / "port/global_step1/metadata.json").read_text())
    for key in ("tag", "global_steps", "micro_steps", "skipped_steps", "step", "rng",
                "client_state", "zero_stage", "world_size"):
        assert pm[key] == jm[key], key
    assert pm["rng"] == [0, 1234] and pm["manifest_version"] == 1
    for comp in ckpt._COMPONENTS:
        assert pm["components"][comp]["leaf_names"] == jm["components"][comp]["leaf_names"]
        jfiles = sorted(os.listdir(tmp_path / "jax/global_step1" / comp))
        assert sorted(os.listdir(tmp_path / "port/global_step1" / comp)) == jfiles
        for f in jfiles:
            assert (tmp_path / "port/global_step1" / comp / f).read_bytes() == \
                (tmp_path / "jax/global_step1" / comp / f).read_bytes(), (comp, f)
    assert {"leaf_shapes", "leaf_dtypes", "leaf_dimspecs", "shards"} <= \
        set(pm["components"]["opt_state"])
    for f in ("latest", "zero_to_fp32.py"):
        assert (tmp_path / "port" / f).exists()


def test_zero3_dp4_checkpoint_loads_on_one_device(tmp_path):
    cfg = _cfg("adamw", zero_optimization={"stage": 3, "grad_wire": "fp32",
                                           "param_wire": "fp32"})
    jeng = _jax_engine(cfg, devices=4)
    jeng.train_batch(batch=_batches(1)[0])
    jax_ckpt.save_checkpoint(jeng, str(tmp_path))
    meta = json.loads((tmp_path / "global_step1/metadata.json").read_text())
    names = meta["components"]["opt_state"]["leaf_names"]
    files = ckpt._index_shard_files(str(tmp_path / "global_step1/opt_state"))
    mu = names.index("[0][0].mu['embed']['tok']")
    assert len(files[mu]) == 4 and meta["zero_stage"] == 3 and meta["world_size"] == 4
    peng = _port_engine(_cfg("adamw"), seed=5)
    peng.load_checkpoint(str(tmp_path))
    want = {**_named_jax(jeng.state.params), **_named_jax(jeng.state.opt_state)}
    got = _named_port(peng)
    assert set(got) == set(want)
    for name, arr in got.items():
        assert np.array_equal(arr, want[name]) and arr.dtype == want[name].dtype, name


# ------------------------------------------------------ inside the port
@pytest.mark.parametrize("dtype,accum", [("fp32", 1), ("bf16", 2)])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_resume_inside_port_is_bitwise(name, dtype, accum, tmp_path):
    cfg = _cfg(name, dtype, accum)
    batches = _batches(rows=4)
    eng = _port_engine(cfg)
    for b in batches[:2]:
        eng.train_batch(batch=b)
    eng.save_checkpoint(str(tmp_path), client_state={"epoch": 3})
    want = [eng.train_batch(batch=b).item() for b in batches[2:]]
    fresh = _port_engine(cfg, seed=7)
    path, client = fresh.load_checkpoint(str(tmp_path))
    assert client == {"epoch": 3} and (fresh.global_steps, fresh.micro_steps) == (2, 2 * accum)
    assert [fresh.train_batch(batch=b).item() for b in batches[2:]] == want
    assert all(torch.equal(a, b) for a, b in zip(_state(fresh), _state(eng)))


def test_mixtral_resume_inside_port_is_bitwise(tmp_path):
    jm = jax_mixtral("mixtral-tiny", vocab_size=256, max_seq_len=64, num_layers=1)
    model = TransformerModel(port_config(jm.config))
    cfg = _cfg("adamw", moe={"enabled": True, "ep_size": 1})
    batches = _batches()
    eng = _port_engine(cfg, model=model)
    for b in batches[:2]:
        eng.train_batch(batch=b)
    eng.save_checkpoint(str(tmp_path))
    want = [eng.train_batch(batch=b).item() for b in batches[2:]]
    fresh = _port_engine(cfg, model=model, seed=7)
    fresh.load_checkpoint(str(tmp_path))
    assert [fresh.train_batch(batch=b).item() for b in batches[2:]] == want
    assert all(torch.equal(a, b) for a, b in zip(_state(fresh), _state(eng)))


@pytest.mark.parametrize("family", ["bloom", "mixtral"])
def test_leaves_match_by_name_where_tree_orders_differ(family, tmp_path):
    """BLOOM's ``embed_norm`` and Mixtral's banks sit elsewhere in the port's
    tree than in JAX's sorted walk: each leaf still lands on its name."""
    if family == "bloom":
        jm, jparams, pm, pparams = family_pair("bloom")
    else:
        jm = jax_mixtral("mixtral-tiny", vocab_size=256, max_seq_len=64, num_layers=1)
        jparams = jm.init(jax.random.PRNGKey(3))
        pm = TransformerModel(port_config(jm.config))
        pparams = params_from_numpy(pm.config, _host(jparams))
    assert tree_paths(pparams) != tree_paths(pparams, sort_keys=True)
    eng = _port_engine(_cfg("adamw", moe={"enabled": family == "mixtral"}),
                       masters=_host(jparams), model=pm)
    eng.save_checkpoint(str(tmp_path / "port"))
    template = jax.eval_shape(lambda k: jm.init(k), jax.random.PRNGKey(0))
    loaded = jax_ckpt.load_params(str(tmp_path / "port"), template)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
                 loaded, _host(jparams))
    jax_ckpt.save_checkpoint(_jax_stub(jparams), str(tmp_path / "jax"))
    shapes = tree_map(lambda spec: spec[0], param_specs(pm.config))
    back = ckpt.load_params(str(tmp_path / "jax"), shapes)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b),
                 params_to_numpy(back), _host(jparams))


# ---------------------------------------------------------- commit rule
def test_torn_tag_refused_and_skipped_keep_last_prunes(tmp_path):
    eng = _port_engine(_cfg("adamw", checkpoint={"keep_last": 2}))
    b = _batches(1)[0]
    for _ in range(3):
        eng.train_batch(batch=b)
        eng.save_checkpoint(str(tmp_path))
    assert ckpt.list_checkpoints(str(tmp_path)) == ["global_step2", "global_step3"]
    eng.train_batch(batch=b)
    eng.save_checkpoint(str(tmp_path))
    os.remove(tmp_path / "global_step4/metadata.json")  # a writer killed before its commit
    with pytest.raises(UncommittedCheckpointError, match="NOT committed"):
        eng.load_checkpoint(str(tmp_path), tag="global_step4")
    assert (tmp_path / "latest").read_text() == "global_step4"
    assert latest_committed_tag(str(tmp_path)) == "global_step3"
    fresh = _port_engine(_cfg("adamw"), seed=7)
    path, _ = fresh.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step3") and fresh.global_steps == 3
    with pytest.raises(FileNotFoundError):
        fresh.load_checkpoint(str(tmp_path), tag="global_step9")
    assert fresh.load_checkpoint(str(tmp_path / "empty")) == (None, {})


def test_async_save_equals_sync_save_and_failures_surface(tmp_path, monkeypatch):
    eng = _port_engine(_cfg("lamb"))
    b = _batches(1)[0]
    eng.train_batch(batch=b)
    eng.save_checkpoint(str(tmp_path / "sync"), async_save=False)
    eng.save_checkpoint(str(tmp_path / "async"), async_save=True)
    eng.train_batch(batch=b)  # the masters move in place while the writer runs
    eng._ckpt_guard().fence()
    for comp in ckpt._COMPONENTS:
        for f in sorted(os.listdir(tmp_path / "sync/global_step1" / comp)):
            assert (tmp_path / "async/global_step1" / comp / f).read_bytes() == \
                (tmp_path / "sync/global_step1" / comp / f).read_bytes(), (comp, f)
    assert json.loads((tmp_path / "async/global_step1/metadata.json").read_text()) == \
        json.loads((tmp_path / "sync/global_step1/metadata.json").read_text())

    def boom(*args):
        raise OSError("disk full")

    monkeypatch.setattr(async_writer, "_write_entries", boom)
    eng.save_checkpoint(str(tmp_path / "async"), async_save=True)
    eng.train_batch(batch=b)
    with pytest.raises(RuntimeError, match="async checkpoint writer failed"):
        eng.save_checkpoint(str(tmp_path / "async"))
    assert latest_committed_tag(str(tmp_path / "async")) == "global_step1"


def test_pool_recycles_generations_and_refuses_pending_reads():
    pool = PinnedBufferPool()
    a = pool.take((4, 3), torch.float32)
    pool.retire_generation([a])
    b = pool.take((4, 3), torch.float32)
    assert b is not a  # one generation later, not at once
    pool.retire_generation([b])
    assert pool.take((4, 3), torch.float32) is a and pool.generation == 2
    with pytest.raises(RuntimeError, match="in-flight write"):
        pool.retire_generation([], pending_ids={id(b)})
    pool.retire_generation([])
    assert pool.take((4, 3), torch.float32) is b


def test_async_saves_reuse_one_pinned_generation(tmp_path):
    """The fence that joins a writer retires its buffers: three async saves
    take one generation of buffers, allocated by the first. The guard
    refuses to recycle a buffer that the writer in flight still reads."""
    eng = _port_engine(_cfg("adamw"))
    guard, b = eng._ckpt_guard(), _batches(1)[0]
    gens = []
    for _ in range(3):
        eng.train_batch(batch=b)
        eng.save_checkpoint(str(tmp_path), async_save=True)
        gens.append({id(t) for t in guard._pool._last_gen})
    assert gens[0] and gens[0] == gens[1] == gens[2]
    assert not any(guard._pool._free.values())  # nothing allocated beside them
    guard.fence()
    assert latest_committed_tag(str(tmp_path)) == "global_step3"

    release = threading.Event()
    bufs = [guard._pool.take((3,), torch.float32)]
    guard.rotate(bufs)
    guard.launch(release.wait, bufs)
    with pytest.raises(RuntimeError, match="in-flight write"):
        guard.landed()
    release.set()
    guard.fence()
    assert guard._pool.take((3,), torch.float32) is bufs[0]


def test_sigterm_commits_final_save(tmp_path):
    reset_preempt_handler()
    old = signal.getsignal(signal.SIGTERM)
    try:
        eng = _port_engine(_cfg("adamw", checkpoint={"on_preempt": "save"}))
        b = _batches(1)[0]
        eng.train_batch(batch=b)
        eng.save_checkpoint(str(tmp_path), tag="boot")  # installs the handler
        eng.train_batch(batch=b)
        handler = signal.getsignal(signal.SIGTERM)
        assert callable(handler) and handler is not old
        with pytest.raises(SystemExit) as e:
            handler(signal.SIGTERM, None)
        assert e.value.code == 128 + signal.SIGTERM
        assert latest_committed_tag(str(tmp_path)) == "global_step2"
        eng.destroy()
        assert eng.params is None
    finally:
        signal.signal(signal.SIGTERM, old)
        reset_preempt_handler()


def test_preempt_registry_holds_engines_weakly(tmp_path):
    """The SIGTERM handler's registrations keep no engine alive, and
    ``destroy`` drops the engine's."""
    reset_preempt_handler()
    old = signal.getsignal(signal.SIGTERM)
    try:
        kept, dropped = (_port_engine(_cfg("adamw")) for _ in range(2))
        kept.save_checkpoint(str(tmp_path / "kept"))
        dropped.save_checkpoint(str(tmp_path / "dropped"))
        assert [d for _, d in async_writer._registered()] == \
            [str(tmp_path / "kept"), str(tmp_path / "dropped")]
        ref = weakref.ref(dropped)
        del dropped
        gc.collect()
        assert ref() is None
        assert [e for e, _ in async_writer._registered()] == [kept]
        kept.destroy()
        assert async_writer._registered() == []
    finally:
        signal.signal(signal.SIGTERM, old)
        reset_preempt_handler()


def test_strict_false_refusals_and_orbax(tmp_path):
    eng = _port_engine(_cfg("adamw"))
    eng.train_batch(batch=_batches(1)[0])
    eng.save_checkpoint(str(tmp_path))
    pdir = tmp_path / "global_step1/params"
    meta = json.loads((tmp_path / "global_step1/metadata.json").read_text())
    names = meta["components"]["params"]["leaf_names"]

    def leaf_file(name):
        i = names.index(name)
        (f,) = [p for p in os.listdir(pdir) if p.startswith(f"leaf_{i:05d}")]
        return i, pdir / f

    fresh = _port_engine(_cfg("adamw"), seed=7)
    before = _state(fresh)
    os.remove(leaf_file("['layers']['attn']['wq']")[1])
    with pytest.raises(FileNotFoundError, match="missing leaf"):
        fresh.load_checkpoint(str(tmp_path))
    i, f = leaf_file("['embed']['tok']")
    os.remove(f)
    np.save(pdir / f"leaf_{i:05d}.shard.0-7_0-128.npy", np.zeros((7, 128), np.float32))
    with pytest.raises(ValueError, match="shape"):
        fresh.load_checkpoint(str(tmp_path))
    # a refused load changes nothing: every leaf is checked before the copies
    assert all(torch.equal(a, b) for a, b in zip(_state(fresh), before))
    assert fresh.global_steps == 0
    fresh.load_checkpoint(str(tmp_path), strict=False)
    kept = {"['layers']['attn']['wq']", "['embed']['tok']"}
    saved = dict(tree_items(eng.params, True))
    own = dict(zip(names, before))  # _state lists the params first, in the stored order
    for name, t in tree_items(fresh.params, True):
        assert torch.equal(t, own[name] if name in kept else saved[name]), name
    assert fresh.global_steps == 1

    meta["global_steps"] = 5  # counts of 1 update against 5 steps
    (tmp_path / "global_step1/metadata.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="count"):
        fresh.load_checkpoint(str(tmp_path), strict=False)
    (pdir / "orbax").mkdir()
    with pytest.raises(NotImplementedError, match="Orbax"):
        fresh.load_checkpoint(str(tmp_path), strict=False)
    with pytest.raises(DeepSpeedConfigError, match="orbax"):
        _port_engine(_cfg("adamw", checkpoint={"engine": "orbax"}))


def test_fp16_loss_scale_is_refused(tmp_path):
    """Once refused, a dynamic fp16 scaler's state now loads: the stored
    scale, good steps and hysteresis become the engine's (kept, not applied,
    by this fp32 engine, as the JAX package's no-op update keeps them), and
    a save writes them back."""
    eng = _port_engine(_cfg("adamw"))
    eng.save_checkpoint(str(tmp_path))
    meta = json.loads((tmp_path / "global_step0/metadata.json").read_text())
    names = meta["components"]["loss_scale"]["leaf_names"]
    for name, value in ((".scale", np.asarray(65536.0, np.float32)),
                        (".good_steps", np.asarray(7, np.int32)),
                        (".hysteresis_left", np.asarray(1, np.int32))):
        np.save(tmp_path / f"global_step0/loss_scale/leaf_{names.index(name):05d}.shard.0d.npy",
                value)
    eng.load_checkpoint(str(tmp_path))
    assert eng.loss_scale == 65536.0
    assert tuple(eng._loss_scale) == (65536.0, 7, 1)
    saved = dict(eng.checkpoint_components()["loss_scale"])
    assert (float(saved[".scale"]), int(saved[".good_steps"]),
            int(saved[".hysteresis_left"])) == (65536.0, 7, 1)


# ------------------------------------------- serving and the fp32 export
def test_init_inference_from_checkpoint_matches_jax(tmp_path):
    cfg = _cfg("adamw")
    eng = _port_engine(cfg)
    for b in _batches(2):
        eng.train_batch(batch=b)
    eng.save_checkpoint(str(tmp_path))
    jm = jax_llama("llama-tiny", **ONE_LAYER)
    jeng = deepspeed_tpu.init_inference(jm, dtype=jnp.float32, checkpoint=str(tmp_path),
                                        max_tokens=128)
    peng = deepspeed_tpu_torch.init_inference(eng.model, dtype=torch.float32,
                                              checkpoint=str(tmp_path), max_tokens=128,
                                              device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(tree_items(peng.params), tree_items(eng.params)))
    ids = np.random.RandomState(4).randint(0, 256, size=(2, 20))
    np.testing.assert_array_equal(peng.generate(ids, max_new_tokens=8).numpy(),
                                  np.asarray(jeng.generate(ids, max_new_tokens=8)))
    with pytest.raises(ValueError, match="either checkpoint= or params="):
        deepspeed_tpu_torch.init_inference(eng.model, checkpoint=str(tmp_path),
                                           params=eng.params, device="cpu")


@pytest.mark.parametrize("drop", ["leaf_names", "metadata"])
def test_init_inference_from_checkpoint_without_names(drop, tmp_path):
    """A checkpoint that records no leaf names (or no manifest) is matched
    by position in the writers' order: on a model with as many KV heads as
    query heads, where wq/wk and wv/wo have equal shapes, each leaf still
    lands on its own name."""
    model = TransformerModel(port_config(jax_llama(
        "llama-tiny", **{**ONE_LAYER, "num_kv_heads": ONE_LAYER["num_heads"]}).config))
    eng = _port_engine(_cfg("adamw"), model=model)
    eng.train_batch(batch=_batches(1)[0])
    eng.save_checkpoint(str(tmp_path))
    meta_path = tmp_path / "global_step1/metadata.json"
    if drop == "metadata":
        os.remove(meta_path)
    else:
        meta = json.loads(meta_path.read_text())
        del meta["components"]["params"]["leaf_names"]
        meta_path.write_text(json.dumps(meta))
    peng = deepspeed_tpu_torch.init_inference(model, dtype=torch.float32,
                                              checkpoint=str(tmp_path), max_tokens=128,
                                              device="cpu")
    got, want = dict(tree_items(peng.params)), dict(tree_items(eng.params))
    assert list(got) == list(want)
    for name, t in want.items():
        assert torch.equal(got[name], t), name


def test_zero_to_fp32_matches_jax(tmp_path):
    jparams = jax_llama("llama-tiny", **ONE_LAYER).init(jax.random.PRNGKey(2))
    jax_ckpt.save_checkpoint(_jax_stub(jparams), str(tmp_path / "jax"))
    eng = _port_engine(_cfg("adamw"))
    eng.train_batch(batch=_batches(1)[0])
    eng.save_checkpoint(str(tmp_path / "port"))
    for src in ("jax", "port"):
        d = str(tmp_path / src)
        jax_zero.convert_zero_checkpoint_to_fp32_state_dict(d, str(tmp_path / f"{src}_j.npz"))
        deepspeed_tpu_torch.zero.convert_zero_checkpoint_to_fp32_state_dict(
            d, str(tmp_path / f"{src}_p.npz"))
        want, got = np.load(tmp_path / f"{src}_j.npz"), np.load(tmp_path / f"{src}_p.npz")
        assert list(got) == list(want)
        for k in want:
            assert np.array_equal(got[k], want[k]) and got[k].dtype == want[k].dtype


def test_save_over_ranks_and_the_dropped_script(tmp_path):
    """A dp=2 gloo world of spawned ranks (importing no jax): rank 0 writes,
    every rank resumes the second step bitwise, and the ``zero_to_fp32.py``
    the save dropped into the root runs in the rank with jax unimportable,
    giving JAX's npz of the same directory."""
    jm = jax_llama("llama-tiny", **ONE_LAYER)
    cfg = _cfg("adamw")
    cfg.pop("serving")
    run = {"model": dataclasses.asdict(port_config(jm.config)),
           "tree": _host(jm.init(jax.random.PRNGKey(0))), "config": cfg,
           "batches": _batches(2)}
    npz = str(tmp_path / "script.npz")
    out = launch_local(torch_sp_worker.checkpoint_rank, 2, (run, str(tmp_path / "ck"), npz),
                       backend="gloo")
    assert out[0] == out[1] and out[0][0] == out[0][1]
    assert ckpt.list_checkpoints(str(tmp_path / "ck")) == ["global_step1"]
    jax_zero.convert_zero_checkpoint_to_fp32_state_dict(str(tmp_path / "ck"),
                                                        str(tmp_path / "j.npz"))
    got, want = np.load(npz), np.load(tmp_path / "j.npz")
    assert list(got) == list(want) and all(np.array_equal(got[k], want[k]) for k in want)
