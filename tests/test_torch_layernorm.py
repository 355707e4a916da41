"""LayerNorm: the port's plain forward and backward (what the CUDA kernels
compute) and its dispatch under the kernel scope, on the CPU, against the JAX
package's Pallas layernorm and its custom VJP in interpret mode. D 128 and
1600, ragged row counts (not a multiple of the Pallas row block), and rows
whose mean is 100 against a spread of 1. fp32 within atol 1e-5 (forward) and
atol 1e-5 + rtol 1e-5 (backward; dscale and dbias are sums over up to 300
rows), plus 4e-7 * |mean| in atol (times the row count for dscale and
dbias, where every row's term carries it): the fp32 mean of values near 100
is summed in another order (one fp32 ulp at 100 is 7.6e-6; measured 3.1e-5
in the output and 2.1e-4 in dscale over 20 rows at mean 100). A one-pass
variance, E[x^2] - mean^2, loses most of the variance's digits there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.layernorm import layernorm as pallas_layernorm
from deepspeed_tpu_torch.ops.cuda import layernorm as ln
from deepspeed_tpu_torch.ops.normalization import kernel_rmsnorm_scope, layernorm

ATOL, RTOL = 1e-5, 1e-5
EPS = 1e-5


def _inputs(rows, D, shift=0.0, seed=0):
    r = np.random.RandomState(seed)
    x = (shift + r.randn(rows, D)).astype(np.float32)
    scale = (1 + 0.1 * r.randn(D)).astype(np.float32)
    bias = (0.1 * r.randn(D)).astype(np.float32)
    g = r.randn(rows, D).astype(np.float32)
    return x, scale, bias, g


@jax.jit
def _pallas_vjp(x, scale, bias, g):
    out, vjp = jax.vjp(lambda x, s, b: pallas_layernorm(x, s, b, EPS), x, scale, bias)
    return (out, *vjp(g))


def _pallas(x, scale, bias, g):
    return [np.asarray(t) for t in _pallas_vjp(*map(jnp.asarray, (x, scale, bias, g)))]


CASES = [(7, 128, 0.0), (300, 128, 0.0), (33, 1600, 0.0), (20, 1600, 100.0)]


@pytest.mark.parametrize("rows,D,shift", CASES)
def test_plain_forward_and_backward_match_pallas(rows, D, shift):
    x, scale, bias, g = _inputs(rows, D, shift)
    want_out, want_dx, want_ds, want_db = _pallas(x, scale, bias, g)
    tx, ts, tb, tg = map(torch.from_numpy, (x, scale, bias, g))
    atol = ATOL + 4e-7 * shift
    np.testing.assert_allclose(ln.layernorm_plain(tx, ts, tb, EPS).numpy(), want_out,
                               atol=atol, rtol=0)
    dx, ds, db = ln.layernorm_bwd_plain(tx, ts, tg, EPS)
    np.testing.assert_allclose(dx.numpy(), want_dx, atol=atol, rtol=RTOL)
    for got, want in ((ds, want_ds), (db, want_db)):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL + 4e-7 * shift * rows,
                                   rtol=RTOL)


@pytest.mark.parametrize("rows,D,shift", CASES[:3])
def test_kernel_scope_autograd_matches_pallas(rows, D, shift):
    """Under the kernel scope a CPU tensor goes through LayerNormFunction
    (the wrappers' plain versions); its gradients are the custom VJP's."""
    x, scale, bias, g = _inputs(rows, D, shift, seed=1)
    want_out, want_dx, want_ds, want_db = _pallas(x, scale, bias, g)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, scale, bias)]
    with kernel_rmsnorm_scope(True):
        out = layernorm(*leaves, EPS)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=ATOL, rtol=0)
    for t, want in zip(leaves, (want_dx, want_ds, want_db)):
        np.testing.assert_allclose(t.grad.numpy(), want, atol=ATOL, rtol=RTOL)


def test_off_scope_is_the_plain_expression_and_bf16_rounds_once():
    x, scale, bias, _ = _inputs(5, 128, seed=2)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    ts, tb = torch.from_numpy(scale), torch.from_numpy(bias)
    off = layernorm(tx, ts, tb, EPS)
    with kernel_rmsnorm_scope(True):
        on = layernorm(tx, ts, tb, EPS)
    assert off.dtype == torch.bfloat16 and torch.equal(on, off)
    # the fp32 result rounded once to bf16
    assert torch.equal(off, ln.layernorm_plain(tx.float(), ts, tb, EPS).to(torch.bfloat16))


def test_cpu_tensors_never_launch():
    x, scale, bias, g = map(torch.from_numpy, _inputs(4, 128))
    before = dict(ln.launches)
    ln.layernorm_fwd(x, scale, bias)
    ln.layernorm_bwd(x, scale, g)
    assert ln.launches == before
