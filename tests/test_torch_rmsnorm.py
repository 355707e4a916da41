"""RMSNorm: the port's plain version (what the CUDA kernel computes) against
the JAX package's Pallas kernel (interpret mode on the CPU) and its XLA
expression, fp32, atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.transformer import _norm as jax_norm
from deepspeed_tpu.ops.normalization import rmsnorm as jax_rmsnorm
from deepspeed_tpu.ops.pallas.rmsnorm import rmsnorm as pallas_rmsnorm
from deepspeed_tpu_torch.models.transformer import _norm as port_norm
from deepspeed_tpu_torch.ops.cuda.rmsnorm import rmsnorm_fwd, rmsnorm_plain
from deepspeed_tpu_torch.ops.normalization import kernel_rmsnorm_scope, rmsnorm

from torch_bridge import port_config, tiny_pair


def _inputs(shape, seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(*shape).astype(np.float32)
    s = (1.0 + 0.1 * r.randn(shape[-1])).astype(np.float32)
    return x, s


# 300 rows is ragged against the Pallas kernel's 256-row block
@pytest.mark.parametrize("shape", [(8, 128), (300, 256), (2, 3, 4096)])
def test_plain_matches_pallas_kernel(shape):
    x, s = _inputs(shape)
    want = np.asarray(pallas_rmsnorm(jnp.asarray(x), jnp.asarray(s), 1e-5))
    got = rmsnorm_fwd(torch.from_numpy(x), torch.from_numpy(s), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("kernel", [False, True])
def test_dispatch_matches_jax_normalization(kernel):
    """Off-kernel the plain expression, under the kernel scope the wrapper
    (its plain version on CPU tensors): both equal the JAX op."""
    x, s = _inputs((4, 16, 128), seed=1)
    want = np.asarray(jax_rmsnorm(jnp.asarray(x), jnp.asarray(s), 1e-6))
    with kernel_rmsnorm_scope(kernel):
        got = rmsnorm(torch.from_numpy(x), torch.from_numpy(s), 1e-6)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_bf16_is_fp32_result_rounded_once():
    """The model's _norm in bf16: fp32 math, one rounding, as JAX's
    _norm casts around the kernel (within one bf16 rounding step)."""
    jm, _, _, _ = tiny_pair()
    x, s = _inputs((2, 8, 128), seed=2)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax_norm(jm.config, {"scale": jnp.asarray(s, jnp.bfloat16)},
                               xb).astype(jnp.float32))
    got = port_norm(port_config(jm.config),
                    {"scale": torch.from_numpy(s).to(torch.bfloat16)},
                    torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8, atol=1e-6)
    assert torch.equal(got, rmsnorm_plain(torch.from_numpy(x).to(torch.bfloat16),
                                          torch.from_numpy(s).to(torch.bfloat16)))
