"""Flash attention backward: the port's plain backward (what the dq and dk/dv
CUDA kernels compute) and its autograd path on the CPU against ``jax.vjp`` of
the JAX package's Pallas flash attention in interpret mode, causal, S=256
(two 128-row tiles), D=64, GQA group 1 and 4. fp32 within atol 2e-5
(measured at most 6.7e-6); bf16 within 2e-2 of the largest gradient
(measured at most 5.6e-3 of it: the port rounds once at the end, the TPU
kernel also rounds p and ds to bf16 before its products). S=200 has no
128-aligned tile, so the JAX entry runs its XLA fallback there: the port's
path is held against that."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from deepspeed_tpu_torch.ops.attention import attention, attention_impl
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(S, H, KV, D=64, B=2, seed=0):
    r = np.random.RandomState(seed)
    return [r.randn(*shape).astype(np.float32)
            for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D))]


def _jax_grads(q, k, v, do, jdt, **kw):
    args = [jnp.asarray(a, jdt) for a in (q, k, v)]
    out, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, causal=True, **kw), *args)
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do, jdt))]


def _port_grads(q, k, v, do, tdt, impl="flash"):
    """Gradients through the port's attention registry (autograd)."""
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (q, k, v)]
    with attention_impl(impl):
        out = attention(*leaves, causal=True)
    out.backward(torch.from_numpy(do).to(tdt))
    return [t.grad.float().numpy() for t in leaves]


def _assert_close(got, want, dtype):
    for g, w in zip(got, want):
        tol = 2e-5 if dtype == "float32" else 2e-2 * np.abs(w).max()
        np.testing.assert_allclose(g, w, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2)])
def test_autograd_matches_pallas_vjp(H, KV, dtype):
    jdt, tdt = DTYPES[dtype]
    q, k, v, do = _inputs(256, H, KV)
    want = _jax_grads(q, k, v, do, jdt, block_q=128, block_k=128, interpret=True)
    _assert_close(_port_grads(q, k, v, do, tdt), want, dtype)


@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2)])
def test_plain_bwd_matches_pallas_vjp(H, KV):
    """The plain backward from the forward's saved (out, lse), and its two
    halves (the dq kernel's delta feeding the dk/dv kernel)."""
    q, k, v, do = _inputs(256, H, KV, seed=1)
    want = _jax_grads(q, k, v, do, jnp.float32, block_q=128, block_k=128,
                      interpret=True)
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = fa.flash_attention_fwd(qt, kt, vt)
    got = fa.flash_attention_bwd(qt, kt, vt, out, lse, dot)
    _assert_close([t.numpy() for t in got], want, "float32")
    dq, delta = fa.flash_attention_bwd_dq(qt, kt, vt, out, lse, dot)
    assert delta.shape == (2, H, 256) and delta.dtype == torch.float32
    np.testing.assert_allclose(
        delta.numpy(), np.einsum("bshd,bshd->bhs", do, out.numpy()), atol=1e-4)
    dk, dv = fa.flash_attention_bwd_dkv(qt, kt, vt, lse, delta, dot)
    assert torch.equal(dq, got[0]) and torch.equal(dk, got[1]) and torch.equal(dv, got[2])


def test_ragged_length_matches_xla_fallback():
    q, k, v, do = _inputs(200, 8, 2, seed=2)
    want = _jax_grads(q, k, v, do, jnp.float32)  # no 128-aligned tile: XLA
    _assert_close(_port_grads(q, k, v, do, torch.float32), want, "float32")


def test_plain_impl_stays_differentiable():
    """The plain registry entry is differentiated by torch and agrees with
    the flash entry's kernel-path backward."""
    q, k, v, do = _inputs(64, 8, 2, seed=3)
    flash = _port_grads(q, k, v, do, torch.float32, impl="flash")
    plain = _port_grads(q, k, v, do, torch.float32, impl="plain")
    _assert_close(flash, plain, "float32")


def test_no_grad_skips_the_autograd_function():
    q, k, v, _ = (torch.from_numpy(a).requires_grad_(True) for a in _inputs(64, 4, 2))
    with attention_impl("flash"), torch.no_grad():
        out = attention(q, k, v)
    assert out.grad_fn is None
    with attention_impl("flash"):
        out = attention(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
