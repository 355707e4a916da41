"""Shared helpers of the tests/test_torch_*.py files: one tiny Llama built in
both packages with the same weights (the JAX init, bridged through
``deepspeed_tpu_torch.models.convert.params_from_numpy``)."""

import dataclasses

import jax
import numpy as np
import torch

from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu_torch.models import TransformerConfig, TransformerModel
from deepspeed_tpu_torch.models.convert import params_from_numpy

TINY = dict(vocab_size=256, max_seq_len=512, hidden_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, intermediate_size=256)


def port_config(jax_cfg) -> TransformerConfig:
    fields = {f.name for f in dataclasses.fields(TransformerConfig)}
    return TransformerConfig(**{k: v for k, v in dataclasses.asdict(jax_cfg).items()
                                if k in fields})


def tiny_pair(seed: int = 0, **overrides):
    """(jax model, jax fp32 params, port model, port fp32 params)."""
    jm = jax_llama("llama-tiny", **{**TINY, **overrides})
    jparams = jm.init(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, jparams)
    pm = TransformerModel(port_config(jm.config))
    return jm, jparams, pm, params_from_numpy(pm.config, tree)


def to_torch(a, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
    return t.to(dtype) if dtype is not None else t
