"""``TorchEngine.save_16bit_model`` against the JAX package's
``TpuEngine.save_16bit_model`` on the same fp32 masters: the safetensors
files are byte-identical (the HF names and layouts of llama, gpt2, bloom and
mixtral, the keystr names of a model with no HF exporter; bf16 rounded to
nearest even on both sides), and the port's reader gives back the masters'
bf16 cast. GPT-2 and BLOOM use ``torch_bridge.family_pair``'s perturbed
weights (the JAX init's zero biases and unit scales would hide a misplaced
bias or scale)."""

import dataclasses
import json
import struct
import types

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.models import mixtral as jax_mixtral
from deepspeed_tpu.runtime.engine import TpuEngine
from deepspeed_tpu_torch.integrations.hf import (export_hf_state_dict, read_safetensors,
                                                 write_safetensors)
from deepspeed_tpu_torch.models import TransformerModel
from deepspeed_tpu_torch.models.convert import params_from_numpy

from torch_bridge import TINY, family_pair, port_config


def _pair(family):
    if family in ("gpt2", "bloom"):
        jm, jparams, pm, _ = family_pair(family)
        return jm.config, jax.tree.map(np.asarray, jparams)
    if family == "mixtral":
        jm = jax_mixtral("mixtral-tiny", vocab_size=256, max_seq_len=64, num_layers=2)
    else:
        jm = jax_llama("llama-tiny", **TINY)
    cfg = jm.config
    if family == "other":  # a model no HF exporter knows: keystr names
        cfg = dataclasses.replace(cfg, name="tiny-custom")
    return cfg, jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))


@pytest.mark.parametrize("family", ["llama", "gpt2", "bloom", "mixtral", "other"])
def test_save_16bit_model_is_byte_identical_to_jax(family, tmp_path):
    jcfg, tree = _pair(family)
    stub = types.SimpleNamespace(state=types.SimpleNamespace(params=tree),
                                 model=types.SimpleNamespace(config=jcfg))
    want = TpuEngine.save_16bit_model(stub, str(tmp_path / "jax"))
    pm = TransformerModel(port_config(jcfg))
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=pm, config={"train_batch_size": 1, "moe": {"enabled": family == "mixtral"}},
        model_parameters=params_from_numpy(pm.config, tree), device="cpu")
    got = eng.save_16bit_model(str(tmp_path / "port"), "weights.safetensors")
    assert got.endswith("weights.safetensors")
    raw = open(got, "rb").read()
    assert raw == open(want, "rb").read()
    (hlen,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + hlen])
    assert all(v["dtype"] == "BF16" for v in header.values())
    if family != "other":
        assert all(k.startswith(("model.", "transformer.", "lm_head.")) for k in header)
    # read back: the masters' bf16 cast under each name, exactly
    flat = export_hf_state_dict(eng.params, pm.config, jcfg.name.split("-")[0]) \
        if family != "other" else None
    back = read_safetensors(got)
    if flat is not None:
        assert list(back) == list(flat)
        for k, t in flat.items():
            assert np.array_equal(back[k], t.detach().to(torch.bfloat16).float().numpy()), k


def test_safetensors_round_trip_and_rounding(tmp_path):
    """bf16 rounds to nearest even (ml_dtypes' rule) and goes out as raw
    little-endian uint16; other dtypes keep theirs; an unknown one goes F32."""
    x = torch.tensor([1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, -2.5, 3.0e38])
    tensors = {"b": x.to(torch.bfloat16), "f": x, "i": np.arange(4, dtype=np.int32),
               "u": np.arange(3, dtype=np.uint16)}
    write_safetensors(str(tmp_path / "t.safetensors"), tensors)
    back = read_safetensors(str(tmp_path / "t.safetensors"))
    assert back["b"].tolist() == [1.0, 1.0 + 2 ** -6, -2.5, x[3].to(torch.bfloat16).item()]
    assert back["f"].dtype == np.float32 and np.array_equal(back["f"], x.numpy())
    assert back["i"].dtype == np.int32 and back["u"].dtype == np.float32
    assert back["u"].tolist() == [0.0, 1.0, 2.0]


def test_llama3_presets_export_hf_names(tmp_path):
    """A ``llama3-*`` config exports under the HF Llama names: its file is
    byte for byte JAX's for the same weights under a ``llama-*`` name (the
    JAX package takes the family up to the first "-" and writes keystr names
    for ``llama3``)."""
    jcfg, tree = _pair("llama")
    stub = types.SimpleNamespace(state=types.SimpleNamespace(params=tree),
                                 model=types.SimpleNamespace(config=jcfg))
    want = TpuEngine.save_16bit_model(stub, str(tmp_path / "jax"))
    pm = TransformerModel(port_config(dataclasses.replace(jcfg, name="llama3-tiny")))
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=pm, config={"train_batch_size": 1},
        model_parameters=params_from_numpy(pm.config, tree), device="cpu")
    got = eng.save_16bit_model(str(tmp_path / "port"))
    assert open(got, "rb").read() == open(want, "rb").read()
