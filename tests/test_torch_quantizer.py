"""Weight quantizer: the port's packed bytes and scales against the JAX
package's (``deepspeed_tpu/ops/quantizer.py``) on the same seeded weights,
bit for bit: int8, int4 nibble-packed (even block count), int4 with one block
(no nibbles), a contraction dim off the 128 grid, and stacked layers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import quantizer as jq
from deepspeed_tpu_torch.ops import quantizer as pq

# (shape, bits, nibbles expected)
CASES = [
    ((256, 128), 8, False),
    ((512, 256), 4, True),        # G = 4: two nibble planes
    ((128, 256), 4, False),       # G = 1: one int4 value a byte
    ((200, 128), 8, False),       # d % 128 != 0: one block over d
    ((200, 128), 4, False),
    ((3, 256, 384), 4, True),     # stacked [L, d, n]
    ((3, 384, 128), 8, False),    # stacked, G = 3
]


def _weight(shape, seed=0):
    w = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    w[..., 0, 0] = 0.0  # an exact zero
    return w


@pytest.mark.parametrize("shape,bits,nibbles", CASES)
def test_packed_bytes_and_scales_equal_jax(shape, bits, nibbles):
    w = _weight(shape)
    want = jq.pack_quantize_blockwise(jnp.asarray(w), block=128, bits=bits)
    got = pq.pack_quantize_blockwise(torch.from_numpy(w), bits=bits)
    assert got.nibbles == want.nibbles == nibbles
    assert got.qdata.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.qdata.numpy(), np.asarray(want.qdata))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.shape == tuple(want.shape) == shape
    np.testing.assert_array_equal(got.dequantize().numpy(),
                                  np.asarray(want.dequantize()))


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_dequantize_equal_jax(bits):
    w = _weight((384, 256), seed=1)
    want = jq.quantize_dequantize(jnp.asarray(w), block=128, bits=bits)
    got = pq.quantize_dequantize(torch.from_numpy(w), bits=bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_round_half_to_even_like_jnp_round():
    # values exactly halfway between two integers after the scale division
    w = np.zeros((128, 128), np.float32)
    w[:8, 0] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]
    got, _ = pq.quantize_blockwise(torch.from_numpy(w), bits=8)
    want = jq.quantize_blockwise(jnp.asarray(w), bits=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.qdata))
    assert got[0, :8, 0].tolist() == [127, 0, 2, 2, 0, -2, -2, 4]


def test_layer_slice_unbind_and_device_move():
    w = _weight((3, 256, 128), seed=2)
    pw = pq.pack_quantize_blockwise(torch.from_numpy(w), bits=4)
    layer = pw[1]
    assert layer.shape == (256, 128) and layer.qdata.shape == (1, 128, 128)
    ref = pq.pack_quantize_blockwise(torch.from_numpy(w[1]), bits=4)
    assert torch.equal(layer.qdata, ref.qdata) and torch.equal(layer.scale, ref.scale)
    assert [p.shape for p in pw.unbind(0)] == [(256, 128)] * 3
    assert torch.equal(pw.dequantize()[2], pw[2].dequantize())
    moved = pw.to("cpu")
    assert moved.bits == 4 and moved.nibbles and moved.numel() == w.size
    assert pw.nbytes == 3 * 128 * 128 + 3 * 2 * 128 * 4


def test_cast_floating_and_materialize_keep_packed_leaves():
    w = torch.from_numpy(_weight((2, 256, 128), seed=3))
    tree = {"w": pq.pack_quantize_blockwise(w, bits=8), "b": torch.ones(4),
            "ids": torch.arange(3)}
    cast = pq.cast_floating(tree, torch.bfloat16)
    assert cast["w"] is tree["w"]
    assert cast["w"].qdata.dtype == torch.int8 and cast["w"].scale.dtype == torch.float32
    assert cast["b"].dtype == torch.bfloat16 and cast["ids"].dtype == torch.int64
    dense = pq.materialize_packed(tree, torch.float64)
    assert dense["w"].dtype == torch.float64 and dense["w"].shape == (2, 256, 128)
    assert dense["b"] is tree["b"]


def test_bad_bits_raise():
    with pytest.raises(ValueError):
        pq.quantize_blockwise(torch.zeros(128, 128), bits=2)
