"""Flash attention with ALiBi: the port's plain forward and backward (what the
CUDA kernels compute with slopes) and its autograd path through the attention
registry, on the CPU, against the JAX package's Pallas flash attention with
``alibi_slopes`` in interpret mode: causal, S=256 (two 128-row tiles), D=64,
H=4 (power-of-two slopes) and H=12 (the slopes' interpolated branch), MHA and
GQA. fp32 within atol 2e-5 (the slope-free tests' tolerance); bf16 within
2e-2 of the largest value. The port's ``alibi_slopes`` equals the JAX
package's for every preset's head count."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.transformer import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from deepspeed_tpu_torch.ops.attention import attention, attention_impl
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
from deepspeed_tpu_torch.models.transformer import alibi_slopes

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
S, D, B = 256, 64, 1


def _inputs(H, KV):
    r = np.random.RandomState(H * 100 + KV)
    return [r.randn(*shape).astype(np.float32)
            for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D))]


@functools.lru_cache(maxsize=None)
def _jax(H, KV, dtype):
    """(out, dq, dk, dv) of the Pallas kernel in interpret mode, fp32 numpy."""
    jdt = DTYPES[dtype][0]
    q, k, v, do = _inputs(H, KV)
    slopes = jnp.asarray(jax_alibi_slopes(H))

    @jax.jit
    def run(q, k, v, do):
        out, vjp = jax.vjp(lambda q, k, v: jax_flash(
            q, k, v, causal=True, alibi_slopes=slopes, block_q=128, block_k=128,
            interpret=True), q, k, v)
        return (out, *vjp(do))

    return [np.asarray(t.astype(jnp.float32))
            for t in run(*(jnp.asarray(a, jdt) for a in (q, k, v, do)))]


def _close(got, want, dtype):
    tol = 2e-5 if dtype == "float32" else 2e-2 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("num_heads", [1, 4, 12, 16, 25, 32, 112])
def test_slopes_equal_jax(num_heads):
    np.testing.assert_array_equal(alibi_slopes(num_heads).numpy(),
                                  jax_alibi_slopes(num_heads))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("H,KV", [(4, 4), (12, 4)])
def test_plain_forward_and_backward_match_pallas(H, KV, dtype):
    tdt = DTYPES[dtype][1]
    q, k, v, do = _inputs(H, KV)
    slopes = alibi_slopes(H)
    want = _jax(H, KV, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    out, lse = fa.flash_attention_plain(tq, tk, tv, True, slopes)
    grads = fa.flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo, True, slopes)
    for got, w in zip((out, *grads), want):
        _close(got.float().numpy(), w, dtype)


@pytest.mark.parametrize("H,KV", [(4, 4), (12, 4)])
def test_registry_autograd_matches_pallas(H, KV):
    """``attention(..., alibi_slopes=)`` under the flash implementation (the
    autograd Function carries the slopes, which take no gradient, into the
    backward) and under the plain one (torch's autograd)."""
    q, k, v, do = _inputs(H, KV)
    slopes = alibi_slopes(H)
    want = _jax(H, KV, "float32")
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    for impl in ("flash", "plain"):
        for t in leaves:
            t.grad = None
        with attention_impl(impl):
            out = attention(*leaves, causal=True, alibi_slopes=slopes)
        out.backward(torch.from_numpy(do))
        for got, w in zip((out.detach(), *(t.grad for t in leaves)), want):
            _close(got.numpy(), w, "float32")
