"""Flash attention forward: the port's plain version (what the CUDA kernel
computes) against the JAX package's Pallas kernel in interpret mode, causal
GQA H=4/KV=2, atol 2e-5; against xla_attention at S=160, the shape the JAX
entry sends to XLA; and its lse against a numpy logsumexp."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention import xla_attention
from deepspeed_tpu.ops.pallas.flash_attention import flash_attention
from deepspeed_tpu_torch.ops.attention import attention, attention_impl
from deepspeed_tpu_torch.ops.cuda.flash_attention import flash_attention_fwd


def _qkv(S, B=2, H=4, KV=2, D=64, seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(B, S, H, D).astype(np.float32),
            r.randn(B, S, KV, D).astype(np.float32),
            r.randn(B, S, KV, D).astype(np.float32))


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_kernel(S, causal):
    q, k, v = _qkv(S)
    want = np.asarray(flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=128, block_k=128, interpret=True,
    ))
    out, _ = flash_attention_fwd(*_torch(q, k, v), causal=causal)
    np.testing.assert_allclose(out.numpy(), want, atol=2e-5)


def test_plain_matches_xla_at_fallback_shape():
    """S=160 has no 128-aligned tile: the JAX entry runs XLA there, the
    port's kernel runs it (masking ragged S itself)."""
    q, k, v = _qkv(160, seed=1)
    want = np.asarray(xla_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True))
    out, _ = flash_attention_fwd(*_torch(q, k, v), causal=True)
    np.testing.assert_allclose(out.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("S", [128, 160])
def test_lse_matches_numpy_logsumexp(S):
    q, k, v = _qkv(S, seed=2)
    B, _, H, D = q.shape
    kr = np.repeat(k, H // k.shape[2], axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  kr.astype(np.float64)) / np.sqrt(D)
    s = np.where(np.triu(np.ones((S, S), bool), 1), -np.inf, s)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    _, lse = flash_attention_fwd(*_torch(q, k, v), causal=True)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, atol=2e-5)


def test_attention_registry_on_cpu():
    q, k, v = _torch(*_qkv(64, seed=3))
    with attention_impl("flash"):
        flash = attention(q, k, v)
    with attention_impl("plain"):
        plain = attention(q, k, v)
    assert torch.equal(flash, plain)
    assert torch.equal(attention(q, k, v), plain)  # "auto" is plain on CPU
    with pytest.raises(KeyError):
        attention_impl("xla")
