"""RMSNorm backward: the port's plain backward (what the CUDA kernel computes)
and its autograd path on the CPU against the VJP of the JAX package's Pallas
rmsnorm (interpret mode), with 300 rows (ragged against the Pallas kernel's
256-row block), fp32, atol 1e-5 on dx (measured at most 9.6e-7) and
atol 1e-5 + rtol 1e-5 on dscale; in bf16, dx
is the fp32 result rounded once, within one bf16 rounding step of JAX's
``_norm`` gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.transformer import _norm as jax_norm
from deepspeed_tpu.ops.pallas.rmsnorm import rmsnorm as pallas_rmsnorm
from deepspeed_tpu_torch.models.transformer import _norm as port_norm
from deepspeed_tpu_torch.ops.cuda.rmsnorm import rmsnorm_bwd, rmsnorm_bwd_plain
from deepspeed_tpu_torch.ops.normalization import kernel_rmsnorm_scope, rmsnorm

from torch_bridge import port_config, tiny_pair


def _inputs(shape, seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(*shape).astype(np.float32),
            (1.0 + 0.1 * r.randn(shape[-1])).astype(np.float32),
            r.randn(*shape).astype(np.float32))


def _pallas_vjp(x, s, g, eps=1e-5):
    _, vjp = jax.vjp(lambda x, s: pallas_rmsnorm(x, s, eps), jnp.asarray(x),
                     jnp.asarray(s))
    return [np.asarray(t) for t in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("shape", [(300, 256), (2, 3, 128)])
def test_plain_bwd_matches_pallas_vjp(shape):
    x, s, g = _inputs(shape)
    want_dx, want_ds = _pallas_vjp(x, s, g)
    dx, ds = rmsnorm_bwd(*(torch.from_numpy(a) for a in (x, s, g)))
    assert dx.shape == x.shape and ds.dtype == torch.float32
    np.testing.assert_allclose(dx.numpy(), want_dx, atol=1e-5)
    np.testing.assert_allclose(ds.numpy(), want_ds, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel", [False, True])
def test_autograd_matches_pallas_vjp(kernel):
    """Under the kernel scope the autograd Function (plain versions on the
    CPU), off it torch's own gradient of the plain expression."""
    x, s, g = _inputs((300, 256), seed=1)
    want_dx, want_ds = _pallas_vjp(x, s, g)
    xt, st = (torch.from_numpy(a).requires_grad_(True) for a in (x, s))
    with kernel_rmsnorm_scope(kernel):
        out = rmsnorm(xt, st, 1e-5)
    assert (type(out.grad_fn).__name__ == "RMSNormFunctionBackward") == kernel
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, atol=1e-5)
    np.testing.assert_allclose(st.grad.numpy(), want_ds, rtol=1e-5, atol=1e-5)


def test_no_grad_calls_the_forward_directly():
    x, s, _ = (torch.from_numpy(a).requires_grad_(True) for a in _inputs((4, 128)))
    with kernel_rmsnorm_scope(True), torch.no_grad():
        assert rmsnorm(x, s).grad_fn is None


def test_bf16_grad_is_fp32_result_rounded_once():
    """The model's _norm in bf16 under the kernel scope: dx within one bf16
    rounding step of the gradient of JAX's _norm (fp32 casts around the
    kernel), dscale (bf16 scale) within the same."""
    jm, _, _, _ = tiny_pair()
    x, s, g = _inputs((2, 8, 128), seed=2)
    xb, sb, gb = (jnp.asarray(a, jnp.bfloat16) for a in (x, s, g))
    _, vjp = jax.vjp(lambda x, s: jax_norm(jm.config, {"scale": s}, x), xb, sb)
    want_dx, want_ds = (np.asarray(t.astype(jnp.float32)) for t in vjp(gb))
    xt, st = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True) for a in (x, s))
    with kernel_rmsnorm_scope(True):
        out = port_norm(port_config(jm.config), {"scale": st}, xt)
    out.backward(torch.from_numpy(g).to(torch.bfloat16))
    assert xt.grad.dtype == torch.bfloat16 and st.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(xt.grad.float().numpy(), want_dx, rtol=2 ** -7, atol=1e-2)
    np.testing.assert_allclose(st.grad.float().numpy(), want_ds, rtol=2 ** -7, atol=1e-2)
    dx, _ = rmsnorm_bwd_plain(*(t.detach() for t in (xt, st)),
                              torch.from_numpy(g).to(torch.bfloat16))
    assert torch.equal(xt.grad, dx)
