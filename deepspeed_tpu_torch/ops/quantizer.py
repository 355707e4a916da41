"""Symmetric int8/int4 block quantization of weights.

Counterpart of ``deepspeed_tpu/ops/quantizer.py`` (plain tensor code there
and here: the kernel that consumes the packed weights is
``ops/cuda/quantized_matmul.py``). Weights are quantized over blocks of 128
along dim -2, the contraction dim of the ``[in, out]`` projections, with one
fp32 scale per (block, column). The packed layout is byte-identical to the
JAX package's: qdata int8 ``[..., G, 128, N]``; int4 with an even block count
G nibble-packs blocks g (low nibble) and g + G/2 (high nibble) into byte plane
g, so qdata is ``[..., G/2, 128, N]``; scale fp32 ``[..., G, 1, N]``. A
contraction dim that is not a multiple of 128 is one block over the whole dim.

Rounding is half to even (``torch.round``, as ``jnp.round``).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

BLOCK = 128


def quantize_blockwise(w: torch.Tensor, block: int = BLOCK, bits: int = 8
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(qdata int8 [..., G, block, N], scale fp32 [..., G, 1, N]): symmetric
    per-block quantization along dim -2."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    d = w.shape[-2]
    if d % block != 0:
        block = d  # one block over the whole contraction dim
    G = d // block
    wb = w.float().reshape(*w.shape[:-2], G, block, w.shape[-1])
    qmax = 2.0 ** (bits - 1) - 1
    amax = wb.abs().amax(dim=-2, keepdim=True)
    scale = amax.clamp_min(1e-8) / qmax
    q = torch.round(wb / scale).clamp(-qmax - 1, qmax).to(torch.int8)
    return q, scale


def dequantize_blockwise(qdata: torch.Tensor, scale: torch.Tensor, shape,
                         dtype=torch.bfloat16) -> torch.Tensor:
    return (qdata.float() * scale).reshape(shape).to(dtype)


def quantize_dequantize(w: torch.Tensor, block: int = BLOCK,
                        bits: int = 8) -> torch.Tensor:
    """Fake-quant round trip, returned in w's dtype."""
    q, s = quantize_blockwise(w, block, bits)
    return dequantize_blockwise(q, s, w.shape, w.dtype)


class PackedWeight:
    """Weight-only quantized storage that lives in a parameter tree.

    ``qdata`` int8 and ``scale`` fp32 are the only tensors; ``shape`` is the
    dense weight's shape, ``dtype`` the dtype :meth:`dequantize` returns and
    ``nibbles`` whether int4 pairs share a byte (split-half, see the module
    docstring). Indexing the leading dim gives one layer's slice (the stacked
    [L, ...] leaves of the model), as views."""

    def __init__(self, qdata: torch.Tensor, scale: torch.Tensor, shape,
                 bits: int, dtype: torch.dtype, nibbles: bool = False):
        self.qdata, self.scale = qdata, scale
        self.shape, self.bits, self.dtype = tuple(shape), int(bits), dtype
        self.nibbles = bool(nibbles)

    def __repr__(self) -> str:
        return (f"PackedWeight(shape={self.shape}, bits={self.bits}, "
                f"nibbles={self.nibbles}, dtype={self.dtype}, "
                f"device={self.qdata.device})")

    @property
    def nbytes(self) -> int:
        """Bytes the packed storage holds (qdata and scales)."""
        return (self.qdata.numel() * self.qdata.element_size()
                + self.scale.numel() * self.scale.element_size())

    def numel(self) -> int:
        """Elements of the dense weight."""
        n = 1
        for s in self.shape:
            n *= s
        return n

    def __getitem__(self, i) -> "PackedWeight":
        if len(self.shape) < 3:
            raise IndexError("a PackedWeight indexes only its leading (layer) dim")
        return PackedWeight(self.qdata[i], self.scale[i], self.shape[1:],
                            self.bits, self.dtype, self.nibbles)

    def unbind(self, dim: int = 0) -> List["PackedWeight"]:
        if dim != 0:
            raise ValueError("a PackedWeight unbinds only its leading dim")
        return [self[i] for i in range(self.shape[0])]

    def to(self, device=None) -> "PackedWeight":
        """The same weight with qdata and scales on ``device``."""
        if device is None:
            return self
        return PackedWeight(self.qdata.to(device), self.scale.to(device),
                            self.shape, self.bits, self.dtype, self.nibbles)

    def unpacked_qdata(self) -> torch.Tensor:
        """int8 values [..., G, B, N] in natural block order (int4 nibble
        planes unpacked: low nibbles are blocks 0..G/2-1, high the rest)."""
        q = self.qdata
        if self.nibbles:
            # arithmetic shifts sign-extend int8: (q << 4) >> 4 is the
            # signed low value, q >> 4 the signed high
            low = torch.bitwise_right_shift(torch.bitwise_left_shift(q, 4), 4)
            high = torch.bitwise_right_shift(q, 4)
            q = torch.cat([low, high], dim=-3)
        return q

    def dequantize(self) -> torch.Tensor:
        q = self.unpacked_qdata()
        # the dense shape from qdata's own dims, so a layer slice works too
        shape = (*q.shape[:-3], q.shape[-3] * q.shape[-2], q.shape[-1])
        return dequantize_blockwise(q, self.scale, shape, self.dtype)


def pack_quantize_blockwise(w: torch.Tensor, block: int = BLOCK,
                            bits: int = 8) -> PackedWeight:
    """Quantize ``w`` into packed storage (see :class:`PackedWeight`).

    int4 with an even block count nibble-packs blocks g and g + G/2 into one
    byte plane; a weight with an odd block count keeps one int4 value per
    byte. A stacked weight [L, d, n] is quantized one layer at a time, so the
    fp32 temporaries stay one layer wide."""
    if w.ndim > 2:
        parts = [pack_quantize_blockwise(w[i], block, bits) for i in range(w.shape[0])]
        return PackedWeight(torch.stack([p.qdata for p in parts]),
                            torch.stack([p.scale for p in parts]),
                            w.shape, bits, w.dtype, parts[0].nibbles)
    q, scale = quantize_blockwise(w, block, bits)
    nibbles = False
    if bits == 4 and q.shape[-3] % 2 == 0:
        half = q.shape[-3] // 2
        low, high = q[..., :half, :, :], q[..., half:, :, :]
        q = torch.bitwise_or(torch.bitwise_and(low, 0x0F),
                             torch.bitwise_left_shift(high, 4))
        nibbles = True
    return PackedWeight(q, scale, w.shape, bits, w.dtype, nibbles)


def cast_floating(tree, dtype: torch.dtype, device=None):
    """``.to(dtype)`` for every floating tensor of a parameter tree, every
    leaf moved to ``device`` when given. PackedWeight leaves pass through
    intact apart from the move: qdata stays int8 (the bytes the matvec
    streams) and the scales fp32."""
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, PackedWeight):
        return tree.to(device)
    if tree.is_floating_point():
        return tree.to(device=device, dtype=dtype)
    return tree.to(device) if device is not None else tree


def materialize_packed(tree, dtype=None):
    """Every PackedWeight leaf dequantized (to ``dtype`` when given); other
    leaves pass through. An export and inspection utility: serving consumes
    the packed leaves directly."""
    if isinstance(tree, dict):
        return {k: materialize_packed(v, dtype) for k, v in tree.items()}
    if isinstance(tree, PackedWeight):
        w = tree.dequantize()
        return w.to(dtype) if dtype is not None else w
    return tree
