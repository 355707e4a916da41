"""The port stands alone: it imports neither jax nor deepspeed_tpu, its entry
point refuses to carry on without a card unless asked for the CPU, and a
kernel wrapper given a non-CPU tensor raises rather than falling back."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import llama, mixtral
from deepspeed_tpu_torch.ops import quantizer
from deepspeed_tpu_torch.ops.cuda import (_build, decode_attention, flash_attention,
                                         fused_adam, quantized_matmul, rmsnorm)

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = r"""
import pkgutil, sys
sys.path.insert(0, sys.argv[1])
assert "jax" not in sys.modules, "jax preloaded before the port"
import deepspeed_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    __import__(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "deepspeed_tpu"
             or m.startswith("deepspeed_tpu."))
missing = {"deepspeed_tpu_torch.moe", "deepspeed_tpu_torch.moe.sharded_moe",
           "deepspeed_tpu_torch.models.mixtral", "deepspeed_tpu_torch.runtime.ckpt",
           "deepspeed_tpu_torch.runtime.ckpt.async_writer",
           "deepspeed_tpu_torch.runtime.ckpt.load",
           "deepspeed_tpu_torch.runtime.checkpointing", "deepspeed_tpu_torch.zero",
           "deepspeed_tpu_torch.integrations.hf"} - set(names)
print(len(names), bad, sorted(missing))
sys.exit(1 if bad or missing else 0)
"""


def test_every_module_imports_without_jax_or_the_jax_package():
    # -I: no user site or PYTHON* variables, so nothing preloads jax
    proc = subprocess.run(
        [sys.executable, "-I", "-c", _IMPORT_ALL, str(REPO)],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 15


def test_init_inference_needs_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = llama("llama-tiny", vocab_size=64, max_seq_len=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.init_inference(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.init_inference(model, device="cuda")
    eng = deepspeed_tpu_torch.init_inference(model, dtype=torch.float32,
                                             device="cpu")
    assert eng.device.type == "cpu"


def test_moe_init_inference_needs_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = mixtral("mixtral-tiny", vocab_size=64, max_seq_len=64)
    for kw in ({}, {"dtype": "int8"}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            deepspeed_tpu_torch.init_inference(model, **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.init_serving(model, serving={"paged": True})
    eng = deepspeed_tpu_torch.init_inference(model, dtype="int8", device="cpu")
    assert eng.device.type == "cpu"
    assert eng.params["layers"]["mlp"]["wi"].qdata.device.type == "cpu"


def test_init_serving_needs_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = llama("llama-tiny", vocab_size=64, max_seq_len=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.init_serving(model, serving={"paged": True})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.init_serving(model, device="cuda")
    srv = deepspeed_tpu_torch.init_serving(model, serving={"paged": True},
                                           dtype=torch.float32, device="cpu")
    assert srv.device.type == "cpu"
    assert all(t.device.type == "cpu" for t in srv._caches.values())


def test_initialize_needs_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = llama("llama-tiny", vocab_size=64, max_seq_len=64)
    cfg = {"train_batch_size": 2}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.initialize(model=model, config=cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cuda")
    eng, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")
    assert eng.device.type == "cpu"
    assert all(t.device.type == "cpu" for t in eng.opt_state["mu"]["layers"]["mlp"].values())


def test_accelerator_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    acc = deepspeed_tpu_torch.get_accelerator()
    assert acc is deepspeed_tpu_torch.get_accelerator()
    assert (acc.device_name(), acc.device_name(1)) == ("cuda", "cuda:1")
    assert not acc.is_available() and acc.device_count() == 0
    assert not acc.is_bf16_supported()
    assert not acc.on_accelerator(torch.zeros(1))


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", REPO / "no-such-nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library()


@pytest.mark.parametrize("call", [
    lambda t: rmsnorm.rmsnorm_fwd(t(4, 64), t(64)),
    lambda t: flash_attention.flash_attention_fwd(t(1, 8, 2, 64), t(1, 8, 2, 64),
                                                  t(1, 8, 2, 64)),
    lambda t: decode_attention.decode_attention(t(1, 1, 2, 64), t(1, 8, 2, 64),
                                                t(1, 8, 2, 64), 3),
    lambda t: rmsnorm.rmsnorm_bwd(t(4, 64), t(64), t(4, 64)),
    lambda t: flash_attention.flash_attention_bwd_dq(
        t(1, 8, 2, 64), t(1, 8, 2, 64), t(1, 8, 2, 64), t(1, 8, 2, 64), t(1, 2, 8),
        t(1, 8, 2, 64)),
    lambda t: flash_attention.flash_attention_bwd_dkv(
        t(1, 8, 2, 64), t(1, 8, 2, 64), t(1, 8, 2, 64), t(1, 2, 8), t(1, 2, 8),
        t(1, 8, 2, 64)),
    lambda t: fused_adam.adam_update(t(64), t(64), t(64), t(64), lr=1e-3, b1=0.9,
                                     b2=0.999, eps=1e-8, wd=0.0, bc1=0.1, bc2=0.001),
    lambda t: decode_attention.decode_attention(
        t(1, 1, 2, 64), t(1, 8, 2, 64), t(1, 8, 2, 64), 3, t(1, 2, 8), t(1, 2, 8)),
    lambda t: quantized_matmul.packed_proj(t(1, 256), quantizer.PackedWeight(
        t(2, 128, 128), t(2, 1, 128), (256, 128), 8, torch.bfloat16)),
    lambda t: quantized_matmul.packed_expert_proj(t(4, 2, 256), quantizer.PackedWeight(
        t(4, 2, 128, 128), t(4, 2, 1, 128), (4, 256, 128), 8, torch.bfloat16)),
    lambda t: decode_attention.decode_attention(t(4, 1, 2, 64), t(2, 8, 2, 64),
                                                t(2, 8, 2, 64), t(4), rows_per_seq=2),
    lambda t: decode_attention.paged_decode_attention(
        t(2, 1, 2, 64), t(5, 4, 2, 64), t(5, 4, 2, 64), t(2),
        torch.zeros(2, 2, dtype=torch.int32, device="meta")),
    lambda t: decode_attention.paged_decode_attention(
        t(2, 1, 2, 64), t(5, 4, 2, 64), t(5, 4, 2, 64), t(2),
        torch.zeros(2, 2, dtype=torch.int32, device="meta"), t(5, 2, 4), t(5, 2, 4)),
    # the masked forms: segment ids, a dense bias (with its dbias), a layout
    lambda t: flash_attention.flash_attention_fwd(
        t(1, 8, 2, 64), t(1, 8, 2, 64), t(1, 8, 2, 64),
        segment_ids=torch.zeros(1, 8, dtype=torch.int32, device="meta")),
    lambda t: flash_attention.flash_attention_fwd(
        t(1, 256, 2, 64), t(1, 256, 2, 64), t(1, 256, 2, 64),
        layout=np.tril(np.ones((2, 2), np.int32))),
    lambda t: flash_attention.flash_attention_bwd_dq(
        t(1, 8, 2, 64), t(1, 8, 2, 64), t(1, 8, 2, 64), t(1, 8, 2, 64), t(1, 2, 8),
        t(1, 8, 2, 64), bias=t(1, 2, 8, 8), emit_dbias=True),
    lambda t: flash_attention.flash_attention_bwd_dkv(
        t(1, 8, 2, 64), t(1, 8, 2, 64), t(1, 8, 2, 64), t(1, 2, 8), t(1, 2, 8),
        t(1, 8, 2, 64), bias=t(1, 1, 8, 8)),
    lambda t: flash_attention.flash_attention_bias_grad(
        t(1, 8, 2, 64), t(1, 8, 2, 64), t(1, 8, 2, 64), t(1, 1, 8, 8), t(1, 2, 8),
        t(1, 2, 8), t(1, 8, 2, 64)),
])
def test_kernel_wrappers_raise_instead_of_falling_back(monkeypatch, call):
    """A tensor off the CPU goes to the kernel path; where the kernel cannot
    be built or launched, the wrapper raises (no plain fallback)."""
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("cannot build: nvcc not found")))
    meta = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
    with pytest.raises((RuntimeError, ValueError)):
        call(meta)
