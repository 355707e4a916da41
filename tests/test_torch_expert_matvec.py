"""The expert form of the quantized matvec: the port's ``packed_expert_proj``
on the CPU (the plain version, what the CUDA kernel computes per expert)
against the JAX package's ``packed_expert_proj`` (the Pallas kernel once per
expert, in interpret mode), int8 and int4, fp32 (rtol 1e-5, atol 1e-6: fp32
sums in another order) and bf16 (atol 2 bf16 ulps of the output's largest
value); both return None above the row threshold and for columns off the 128
grid; and each expert's rows equal the 2-D plain matvec on that expert."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import quantizer as jq
from deepspeed_tpu.ops.pallas import quantized_matmul as jqm
from deepspeed_tpu_torch.ops import quantizer as pq
from deepspeed_tpu_torch.ops.cuda import quantized_matmul as pqm

E, D, N = 4, 256, 384  # two contraction blocks (int4 nibble-packs), 3 tiles


def _bank(bits, seed=0, n=N):
    w = np.random.RandomState(seed).randn(E, D, n).astype(np.float32) * 0.05
    return (jq.pack_quantize_blockwise(jnp.asarray(w), bits=bits),
            pq.pack_quantize_blockwise(torch.from_numpy(w), bits=bits))


def _x(C, seed=1):
    return np.random.RandomState(seed).randn(E, C, D).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("C", [1, 4, 8])
def test_plain_expert_proj_matches_pallas(bits, C, dtype):
    jw, pw = _bank(bits, seed=C)
    planes = D // 128 // (2 if bits == 4 else 1)
    assert pw.nibbles == (bits == 4) and pw.qdata.shape == (E, planes, 128, N)
    np.testing.assert_array_equal(pw.qdata.numpy(), np.asarray(jw.qdata))
    x = _x(C, seed=C + 10)
    jt, pt = getattr(jnp, dtype), getattr(torch, dtype)
    jqm.reset_streaming_trace_counts()
    want = jqm.packed_expert_proj(jnp.asarray(x, jt), jw)
    assert want is not None and jqm.streaming_trace_counts()["expert_single"] == 1
    before = dict(pqm.launches)
    got = pqm.packed_expert_proj(torch.from_numpy(x).to(pt), pw)
    assert pqm.launches == before  # the CPU takes the plain version, no launch
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == pt and got.shape == (E, C, N)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    else:
        peak = float(np.abs(want).max())
        ulp = 2.0 ** (np.floor(np.log2(peak)) - 7)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2 * ulp)


@pytest.mark.parametrize("bits", [8, 4])
def test_each_expert_equals_the_2d_matvec(bits):
    _, pw = _bank(bits, seed=3)
    x = torch.from_numpy(_x(5, seed=4))
    got = pqm.packed_expert_matvec(x, pw)
    for e in range(E):
        torch.testing.assert_close(got[e], pqm.packed_matvec_plain(x[e], pw[e]),
                                   rtol=0, atol=0)


def test_none_above_the_row_threshold_and_off_the_grid():
    jw, pw = _bank(8)
    for C, scope in ((9, None), (5, 4)):
        x = _x(C)
        with jqm.matvec_max_rows_scope(scope), pqm.matvec_max_rows_scope(scope):
            assert jqm.packed_expert_proj(jnp.asarray(x), jw) is None
            assert pqm.packed_expert_proj(torch.from_numpy(x), pw) is None
    jw, pw = _bank(8, n=200)
    assert jqm.packed_expert_proj(jnp.asarray(_x(2)), jw) is None
    assert pqm.packed_expert_proj(torch.from_numpy(_x(2)), pw) is None
    # a 2-D weight is not a bank
    x2 = torch.from_numpy(_x(2))
    assert pqm.packed_expert_proj(x2, pw[0]) is None


def test_expert_bank_indexing_gives_the_layer_and_expert_slices():
    w = torch.from_numpy(np.random.RandomState(5).randn(2, E, D, 128).astype(np.float32))
    pw = pq.pack_quantize_blockwise(w, bits=4)
    assert pw.qdata.shape == (2, E, 1, 128, 128) and pw.scale.shape == (2, E, 2, 1, 128)
    layer = pw[1]
    assert layer.shape == (E, D, 128) and layer.qdata.ndim == 4
    torch.testing.assert_close(layer[2].dequantize(),
                               pq.pack_quantize_blockwise(w[1, 2], bits=4).dequantize(),
                               rtol=0, atol=0)
