"""Shared helpers of the tests/test_torch_*.py files: one tiny Llama, and the
tiny GPT-2 and BLOOM, built in both packages with the same weights (the JAX
init, bridged through ``deepspeed_tpu_torch.models.convert.params_from_numpy``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deepspeed_tpu.models import bloom as jax_bloom
from deepspeed_tpu.models import gpt2 as jax_gpt2
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


V = 256  # the GPT-2/BLOOM pairs' vocab
FAMILIES = {"gpt2": (jax_gpt2, "gpt2-tiny"), "bloom": (jax_bloom, "bloom-tiny")}
# leaves the JAX init leaves at zero or one; the others are random already
PERTURBED = ("bq", "bk", "bv", "bo", "bi", "bias", "scale")


def _perturb(tree, r, name=None):
    if isinstance(tree, dict):
        return {k: _perturb(v, r, k) for k, v in tree.items()}
    a = np.array(tree, np.float32)
    if name in PERTURBED:
        a = a + 0.1 * r.randn(*a.shape).astype(np.float32)
    return a


def family_pair(family: str, seed: int = 0):
    """(jax model, jax fp32 params, port model, port fp32 params) of
    ``gpt2-tiny`` or ``bloom-tiny`` (vocab 256, 256 positions), the same
    weights in both, perturbed by seeded numpy noise: the JAX init sets every
    bias to zero and every norm scale to one, which would hide a missing or
    misplaced bias or scale."""
    make, size = FAMILIES[family]
    jm = make(size, vocab_size=V, max_seq_len=256)
    tree = _perturb(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed))),
                    np.random.RandomState(seed + 1))
    pm = TransformerModel(port_config(jm.config))
    return jm, jax.tree.map(jnp.asarray, tree), pm, params_from_numpy(pm.config, tree)
