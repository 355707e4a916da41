"""ZeRO stages at world 1 and optimizer/parameter offload
(``runtime/bucketed_opt.py``, ``runtime/swap_tensor.py``, ``TorchEngine``) on
llama-tiny with 2 layers (the per-layer update needs L >= 2), S=32, batch 4,
fp32, on the CPU.

- inside the port, bitwise (losses, masters, every optimizer moment under its
  resident name): stages 1/2/3 equal stage 0; ``offload_optimizer: cpu``
  equals the resident run for adamw (plain and through the fused kernel's
  plain version), lion, adagrad and sgd at momentum 0.9;
  ``offload_double_buffer`` and its alias are accepted and change nothing
  (the CPU steps the layers serially; a card always double buffers, held
  bitwise there by ``chip_smoke.py``); ``nvme`` equals it,
  with the ``.bin`` files on disk while the state is swapped out;
  ``offload_param`` + ``offload_optimizer`` equals it; so do ``mixtral-tiny``
  and ``gpt2-tiny`` (tied head) under ``cpu`` offload;
- against the JAX package's bucketed engine (``TpuEngine`` on one CPU device,
  stage 3 + ``offload_optimizer: cpu``, its ``BucketedOptimizer``), 2 steps,
  adamw and lamb (whose trust ratio is per layer slice there and here): losses
  rtol 1e-5, masters atol 2e-5 (``tests/test_torch_training.py``'s);
- checkpoints of the bucketed layout load in either package (the JAX side
  through its legacy ``runtime/checkpointing.py``), an ``nvme`` engine saves
  while swapped out and resumes bitwise, a resident checkpoint into a
  bucketed engine (and the reverse) is refused naming both layouts;
  ``zero_to_fp32`` and ``save_16bit_model`` read an offloaded engine;
- the config errors of JAX ``ZeroConfig.validate``;
- ``models/transformer.py:_LayerSlice``: a layer's fp32 slice is a view of
  the stacked leaf when no cast is needed (no saved tensor copies it), and a
  backward it cannot land in ``.grad`` (``torch.autograd.grad``,
  ``create_graph``, a hook on the leaf) is refused.

The JAX engines are built once per optimizer (module scope) and reset to
their initial state between cases, with the "auto" knobs pinned.
"""

import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.topology import MeshTopology, ParallelDims
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.runtime import checkpointing as jax_ckpt
from deepspeed_tpu.runtime.engine import TrainState
from deepspeed_tpu_torch import zero
from deepspeed_tpu_torch.config import DeepSpeedConfigError
from deepspeed_tpu_torch.models import TransformerModel, gpt2, mixtral
from deepspeed_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from deepspeed_tpu_torch.utils.tree import tree_leaves

from torch_bridge import TINY, port_config

S = 32
OPTIMIZERS = {
    # eps 1e-6: at 1e-8 one near-cancelled gradient element of wo turns fp32
    # summation-order noise into 2.3e-5 (the resident port run lands there too)
    "adamw": ({"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.01, "eps": 1e-6}},
              {}),
    "fusedadam": ({"type": "FusedAdam", "params": {"lr": 1e-3, "weight_decay": 0.01}},
                  {"fused_adam": True}),
    "lion": ({"type": "lion", "params": {"lr": 1e-3, "weight_decay": 0.1,
                                         "betas": [0.9, 0.99]}}, {}),
    "adagrad": ({"type": "adagrad", "params": {"lr": 1e-2, "weight_decay": 0.1}}, {}),
    "lamb": ({"type": "lamb", "params": {"lr": 1e-3, "weight_decay": 0.1, "eps": 1e-6}}, {}),
    "sgd-momentum": ({"type": "sgd", "params": {"lr": 1e-2, "weight_decay": 0.1,
                                                "momentum": 0.9}}, {}),
}
CPU = {"offload_optimizer": {"device": "cpu"}}


def _cfg(name="adamw", stage=0, accum=2, **zo):
    opt, kernels = OPTIMIZERS[name]
    return {
        "train_batch_size": 4, "gradient_accumulation_steps": accum, "optimizer": opt,
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_num_steps": 4, "warmup_type": "linear"}},
        "gradient_clipping": 1.0, "steps_per_print": 100, "tpu_kernels": kernels,
        # explicit values for the JAX engine's "auto" knobs (ROADMAP C)
        "zero_optimization": {"stage": stage, "grad_wire": "fp32", "param_wire": "fp32",
                              **zo},
        "serving": {"moe_a2a": "stock", "kv_cache_dtype": "bf16"},
    }


def _batches(n=2, seed=0, vocab=256):
    r = np.random.RandomState(seed)
    return [{"input_ids": r.randint(0, vocab, size=(4, S))} for _ in range(n)]


def _model(family="llama"):
    if family == "mixtral":
        return mixtral("mixtral-tiny", vocab_size=256, max_seq_len=64)
    if family == "gpt2":
        return gpt2("gpt2-tiny", vocab_size=256, max_seq_len=64)
    return TransformerModel(port_config(jax_llama("llama-tiny", **TINY).config))


def _port(cfg, family="llama", masters=None, seed=0):
    extra = {"moe": {"enabled": True, "ep_size": 1}} if family == "mixtral" else {}
    kw = ({"model_parameters": masters} if masters is not None
          else {"rng": torch.Generator().manual_seed(seed)})
    eng, *_ = deepspeed_tpu_torch.initialize(model=_model(family), config={**cfg, **extra},
                                             device="cpu", **kw)
    return eng


def resident_name(name: str) -> str:
    """A bucketed state leaf's name in the resident chain's layout:
    ``['layers'][0][0].mu['attn']['wq']`` → ``[0][0].mu['layers']['attn']['wq']``
    (update counts, which have no tree path, unchanged)."""
    for group, prefix in (("['layers']", "['layers']"), ("['rest']", "")):
        if name.startswith(group):
            rest = name[len(group):]
            at = rest.find("['")
            return rest if at < 0 else rest[:at] + prefix + rest[at:]
    return name


def _state(eng):
    """{resident name: tensor} of the masters and every optimizer tensor."""
    eng._swap_in_opt()
    comps = eng.checkpoint_components()
    out = {f"params{n}": t.detach().clone() for n, t in comps["params"]}
    out.update({resident_name(n): t.detach().clone()
                for n, t in comps["opt_state"] if torch.is_tensor(t)})
    eng._swap_out_opt()
    return out


def _train(eng, batches):
    return [eng.train_batch(batch=b).item() for b in batches]


@functools.lru_cache(maxsize=None)
def _resident(name, family):
    eng = _port(_cfg(name), family)
    losses = _train(eng, _batches(vocab=256))
    return losses, _state(eng)


CASES = {
    "stage1": ("adamw", "llama", dict(stage=1)),
    "stage2": ("adamw", "llama", dict(stage=2)),
    "stage3": ("adamw", "llama", dict(stage=3)),
    "cpu-adamw": ("adamw", "llama", dict(stage=3, **CPU)),
    "cpu-fusedadam": ("fusedadam", "llama", dict(stage=3, **CPU)),
    "cpu-lion": ("lion", "llama", dict(stage=3, **CPU)),
    "cpu-adagrad": ("adagrad", "llama", dict(stage=3, **CPU)),
    "cpu-sgd-momentum": ("sgd-momentum", "llama", dict(stage=2, **CPU)),
    "cpu-double-buffer": ("adamw", "llama", dict(stage=3, offload_double_buffer=True, **CPU)),
    "nvme": ("adamw", "llama", dict(stage=2)),
    "param-and-optimizer": ("adamw", "llama", dict(
        stage=3, offload_param={"device": "cpu"}, sub_group_prefetch=True, **CPU)),
    "mixtral-cpu": ("adamw", "mixtral", dict(stage=3, **CPU)),
    "gpt2-tied-cpu": ("adamw", "gpt2", dict(stage=3, **CPU)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_offload_and_stages_equal_resident_bitwise(case, tmp_path):
    name, family, zo = CASES[case]
    if case == "nvme":
        zo = {**zo, "offload_optimizer": {"device": "nvme", "nvme_path": str(tmp_path)}}
    want_losses, want = _resident(name, family)
    eng = _port(_cfg(name, **zo), family)
    assert (eng._bucketed is not None) == ("offload_optimizer" in zo
                                           and zo["offload_optimizer"]["device"] == "cpu")
    losses = _train(eng, _batches(vocab=256))
    if case == "nvme":  # the state is on disk between steps, not in the engine
        assert eng.opt_state is None
        assert glob.glob(os.path.join(str(tmp_path), "zero_opt_swap", "*.bin"))
    assert losses == want_losses
    got = _state(eng)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    if eng._bucketed is not None:  # the CPU's serial stream, whatever the knobs
        stream = eng.offload_stream
        assert stream["layers"] == 2 and stream["slots"] == 1 and not stream["double_buffer"]
        assert stream["bytes_in"] == eng.host_state_bytes()
        masters = sum(t.numel() * 4 for t in tree_leaves(eng.params))
        assert stream["forward_bytes_in"] == (masters if "offload_param" in zo else 0)


# -------------------------------------------------- against the JAX package
@functools.lru_cache(maxsize=None)
def _jax(name):
    """A bucketed JAX engine (stage 3 + cpu offload: its BucketedOptimizer on a
    CPU device) and a host copy of its initial state."""
    jm = jax_llama("llama-tiny", **TINY)
    topo = MeshTopology(dims=ParallelDims(), devices=jax.devices()[:1])
    eng, *_ = deepspeed_tpu.initialize(model=jm, config=_cfg(name, 3, 1, **CPU),
                                       topology=topo, rng=jax.random.PRNGKey(0))
    assert eng._bucketed_opt is not None
    return eng, jax.tree.map(np.array, eng.state.astuple())


def _jax_reset(name):
    eng, init = _jax(name)
    eng.state = TrainState(*jax.tree.map(jnp.asarray, init))
    eng.global_steps = eng.micro_steps = 0
    return eng, init[0]


def _masters_close(port_params, jax_params, atol=2e-5):
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, atol=atol),
                 params_to_numpy(port_params), jax.tree.map(np.asarray, jax_params))


def _port_from(name, masters, **zo):
    model = _model()
    return _port(_cfg(name, 3, 1, **zo), masters=params_from_numpy(model.config, masters))


@pytest.mark.parametrize("name", ["adamw", "lamb"])
def test_bucketed_update_matches_jax(name):
    jeng, m0 = _jax_reset(name)
    batches = _batches(seed=1)
    want = [float(jeng.train_batch(batch=b)) for b in batches]
    peng = _port_from(name, m0, **CPU)
    got = _train(peng, batches)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _masters_close(peng.params, jeng.state.params)
    if name == "lamb":  # the per-slice trust ratio: the resident lamb lands elsewhere
        res = _port_from(name, m0)
        _train(res, batches)
        gap = max(float((a - b).abs().max().detach()) for a, b in
                  zip(tree_leaves(res.params["layers"]), tree_leaves(peng.params["layers"])))
        assert gap > 1e-6


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_bucketed_checkpoint_loads_in_either_package(direction, tmp_path):
    jeng, m0 = _jax_reset("adamw")
    batches = _batches(3, seed=2)
    want = [float(jeng.train_batch(batch=b)) for b in batches]
    want_params = jax.tree.map(np.asarray, jeng.state.params)
    if direction == "port-to-jax":
        peng = _port_from("adamw", m0, **CPU)
        np.testing.assert_allclose(_train(peng, batches[:2]), want[:2], rtol=1e-5)
        peng.save_checkpoint(str(tmp_path))
        jeng, _ = _jax_reset("adamw")
        jax_ckpt.load_checkpoint(jeng, str(tmp_path))
        assert (jeng.global_steps, int(jeng.state.step)) == (2, 2)
        counts = jeng.state.opt_state["layers"][0][0].count
        assert np.asarray(counts).tolist() == [2, 2]
        np.testing.assert_allclose(float(jeng.train_batch(batch=batches[2])), want[2],
                                   rtol=1e-5)
        jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, atol=2e-5),
                     jax.tree.map(np.asarray, jeng.state.params), want_params)
    else:
        jeng, _ = _jax_reset("adamw")
        for b in batches[:2]:
            jeng.train_batch(batch=b)
        jax_ckpt.save_checkpoint(jeng, str(tmp_path))
        peng = _port(_cfg("adamw", 3, 1, **CPU), seed=5)
        path, _ = peng.load_checkpoint(str(tmp_path))
        assert path.endswith("global_step2") and peng.global_steps == 2
        np.testing.assert_allclose(_train(peng, batches[2:]), want[2:], rtol=1e-5)
        _masters_close(peng.params, want_params)


# ---------------------------------------------------------- checkpoints
def test_nvme_engine_saves_swapped_out_and_resumes_bitwise(tmp_path):
    zo = dict(stage=2, offload_optimizer={"device": "nvme",
                                          "nvme_path": str(tmp_path / "swap")})
    batches = _batches(4, seed=3)
    eng = _port(_cfg("adamw", **zo))
    _train(eng, batches[:2])
    eng.save_checkpoint(str(tmp_path / "ckpt"))
    assert eng.opt_state is None  # swapped out again after the save
    want = _train(eng, batches[2:])
    want_state = _state(eng)
    again = _port(_cfg("adamw", **zo), seed=9)
    again.load_checkpoint(str(tmp_path / "ckpt"))
    assert again.opt_state is None and again.global_steps == 2
    assert _train(again, batches[2:]) == want
    got = _state(again)
    assert all(torch.equal(got[k], want_state[k]) for k in want_state)
    # the resident engine reads the NVMe engine's checkpoint: the same layout
    res = _port(_cfg("adamw"), seed=9)
    res.load_checkpoint(str(tmp_path / "ckpt"))
    assert _train(res, batches[2:]) == want


@pytest.mark.parametrize("saver,loader", [("resident", "bucketed"), ("bucketed", "resident")])
def test_resident_and_bucketed_layouts_refused(saver, loader, tmp_path):
    kinds = {"resident": {}, "bucketed": CPU}
    eng = _port(_cfg("adamw", 3, **kinds[saver]))
    _train(eng, _batches(1))
    eng.save_checkpoint(str(tmp_path))
    other = _port(_cfg("adamw", 3, **kinds[loader]), seed=4)
    before = [t.clone() for t in tree_leaves(other.params)]
    with pytest.raises(ValueError, match="bucketed per-layer layout.*resident layout"
                       if saver == "bucketed" else "resident layout.*bucketed per-layer"):
        other.load_checkpoint(str(tmp_path))
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(other.params)))


def test_zero_to_fp32_and_16bit_export_of_an_offloaded_engine(tmp_path):
    eng = _port(_cfg("adamw", 3, offload_param={"device": "cpu"}, **CPU))
    _train(eng, _batches(1))
    eng.save_checkpoint(str(tmp_path / "ckpt"))
    flat = zero.get_fp32_state_dict_from_zero_checkpoint(str(tmp_path / "ckpt"))
    masters = dict(eng.checkpoint_components()["params"])
    assert set(flat) == set(masters)
    assert all(np.array_equal(np.asarray(flat[k]), masters[k].numpy()) for k in masters)
    path = eng.save_16bit_model(str(tmp_path / "hf"))
    assert os.path.getsize(path) > 0


# ------------------------------------------------------------- config
@pytest.mark.parametrize("zo,match", [
    ({"offload_optimizer": {"device": "disk"}}, "none\\|cpu\\|nvme"),
    ({"offload_optimizer": {"device": "nvme"}}, "nvme_path"),
    ({"stage": 2, "offload_param": {"device": "cpu"}}, "requires ZeRO stage 3"),
    ({"stage": 4}, "0-3"),
])
def test_config_errors_mirror_jax(zo, match):
    with pytest.raises(DeepSpeedConfigError, match=match):
        _port({**_cfg(), "zero_optimization": zo})


# ------------------------------------------------- the layer slices' backward
def _slice_forward(dtype, remat=None):
    model = _model()
    params = model.init(torch.Generator().manual_seed(0), dtype=torch.float32)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    ids = torch.from_numpy(_batches(1)[0]["input_ids"])
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        out = model.apply(params, ids, dtype=dtype, remat_policy=remat)
    return params, out.float().square().mean(), saved


SLICE_CASES = ["fp32-view", "bf16-cast", "autograd-grad", "create-graph", "hook"]


@pytest.mark.parametrize("case", SLICE_CASES)
def test_layer_slices_alias_without_cast_and_refuse_other_backwards(case):
    dtype = torch.bfloat16 if case == "bf16-cast" else torch.float32
    params, loss, saved = _slice_forward(dtype)
    stacked = tree_leaves(params["layers"])
    if case in ("fp32-view", "bf16-cast"):
        # no saved tensor holds a copy of an fp32 layer slice: fp32 compute
        # reads views of the stacked masters; bf16 compute its cast slices
        storages = {w.untyped_storage().data_ptr() for w in stacked}
        leaves = {w.untyped_storage().data_ptr() for w in tree_leaves(params)}
        copies = [t for t in saved if t.dtype == torch.float32 and any(
            t.shape == w.shape[1:] and t.untyped_storage().data_ptr() not in leaves
            and any(torch.equal(t, w[i].detach()) for i in range(w.shape[0]))
            for w in stacked if w.dim() >= 3)]  # the matrices (norm scales start as ones)
        assert not copies
        views = [t for t in saved if t.untyped_storage().data_ptr() in storages]
        assert bool(views) == (dtype == torch.float32)
        loss.backward()
        assert all(w.grad is not None and w.grad.shape == w.shape for w in stacked)
        return
    with pytest.raises(RuntimeError, match="lands in its .grad in place"):
        if case == "autograd-grad":
            torch.autograd.grad(loss, stacked, allow_unused=True)
        elif case == "create-graph":
            loss.backward(create_graph=True)
        else:
            stacked[0].register_hook(lambda g: g)
            loss.backward()

