"""Weight-only int8/int4 projection: the CUDA kernel
``csrc/quantized_matvec.cu``, its plain version and the dispatch.

Replaces ``deepspeed_tpu/ops/pallas/quantized_matmul.py:_kernel`` (line 38),
reached through ``_packed_matvec`` (line 89) from ``packed_proj`` (line 436),
and its per-expert use (``_packed_expert_matvec_local``, line 330, one launch
per expert from ``packed_expert_proj``, line 391): here one launch covers
every expert of a bank (:func:`packed_expert_matvec`). x and y are bf16, or
fp16 (fp16 serving over packed weights: the ``dst_quantized_expert_matvec_f16``
entry, ``csrc/quantized_matvec_f16.cu``, whose launches count under the bf16
names plus ``_f16``); the TPU kernel writes y in x's dtype too (lines 85, 104).
Dequantize-then-multiply would write a full-width copy of the weights every
decode step; the kernel dequantizes in registers, so device memory streams
only the int8/int4 bytes and the fp32 scales.

:func:`packed_proj` is the JAX dispatch: a dense weight is ``x @ w``; a
:class:`~deepspeed_tpu_torch.ops.quantizer.PackedWeight` with at most
:func:`matvec_max_rows` rows of x and 128-aligned columns takes the matvec
(the kernel for CUDA tensors, its plain version for CPU tensors); more rows
are the dense product over the dequantized weight, as the JAX package leaves
them to XLA. On the card a shape the kernel does not take raises.

Bound on the H100: bytes, every weight byte read once (Llama-3-8B's wi at
D = 4096, N = 14336 is 58.7 MB int8 + 1.8 MB of scales). The kernel runs
its products on the tensor cores and folds each 128-row group as
(x·q)·s; the splits of the contraction merge inside one launch, through a
thread-block cluster, so no scratch is allocated here.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from ..quantizer import PackedWeight
from . import _build

# kernel launches since the last reset, by form, weight width and x's dtype
launches = {f"quantized_matvec{form}_int{bits}{dt}": 0 for form in ("", "_expert")
            for bits in (8, 4) for dt in ("", "_f16")}

MAX_KERNEL_ROWS = 16  # rows of x the kernel holds
COLS = 128            # columns of one block's tile
TARGET_BLOCKS = 264   # about two blocks per SM on the H100's 132
MAX_SPLITS = 8        # blocks of a cluster, the portable maximum
WARPS = 4             # warps of a block, each on its own byte planes
STEP = 16             # contraction rows of one tensor-core step

# rows at or below this take the matvec; more rows (a prefill) are
# compute-bound and take the dense product over the dequantized weight
_MATVEC_MAX_ROWS = 8
_rows_override: Optional[int] = None


@contextlib.contextmanager
def matvec_max_rows_scope(rows):
    """Scoped override of the matvec row threshold (None keeps the current
    value): engines with different settings in one process do not fight.
    The inference engine enters it around every forward."""
    global _rows_override
    prev = _rows_override
    if rows is not None:
        _rows_override = int(rows)
    try:
        yield
    finally:
        _rows_override = prev


def matvec_max_rows() -> int:
    """The active row threshold of the matvec."""
    return _rows_override if _rows_override is not None else _MATVEC_MAX_ROWS


def packed_matvec_plain(x2d: torch.Tensor, w: PackedWeight) -> torch.Tensor:
    """y [M, N] = x [M, D] · dequant(w) with the TPU kernel's fp32 fold
    x·(q·s): every weight dequantized in fp32, an fp32 product, the result in
    x's dtype."""
    q = w.unpacked_qdata()
    wf = (q.float() * w.scale).reshape(-1, q.shape[-1])
    return (x2d.float() @ wf).to(x2d.dtype)


def split_plan(planes: int, n_tiles: int):
    """(splits, planes per split) of the contraction for a weight of
    ``planes`` byte planes and ``n_tiles`` column tiles: about
    ``TARGET_BLOCKS`` blocks, at most ``MAX_SPLITS`` of them on one tile
    (the blocks of a cluster, which merge their sums), and above ``WARPS``
    planes a split a multiple of ``WARPS``, so the warps of a block take
    equal shares. It depends on the weight's shape only, never on the rows
    of x, so every row's sums run in the same order whatever M is (a verify
    window's rows equal single-token decode)."""
    want = min(planes, MAX_SPLITS, max(1, -(-TARGET_BLOCKS // n_tiles)))
    per = -(-planes // want)
    if per > WARPS:
        per = -(-per // WARPS) * WARPS
    return -(-planes // per), per


def packed_expert_matvec_plain(x3d: torch.Tensor, w: PackedWeight) -> torch.Tensor:
    """y [E, C, N] = x[e] [C, D] · dequant(w[e]) for every expert of a packed
    bank (qdata [E, G, B, N]): :func:`packed_matvec_plain`'s fp32 fold,
    expert by expert."""
    q = w.unpacked_qdata()
    wf = (q.float() * w.scale).reshape(q.shape[0], -1, q.shape[-1])
    return torch.bmm(x3d.float(), wf).to(x3d.dtype)


def _launch(x: torch.Tensor, w: PackedWeight, experts: bool) -> torch.Tensor:
    """Check ``x`` [E, M, D] (or [M, D]) and the packed weight against what
    the kernel takes, raise on anything else, and launch it: one launch for
    every expert, ``blockIdx.z`` the expert."""
    what = "packed_expert_matvec" if experts else "packed_matvec"
    lib = _build.library()
    q, s = w.qdata, w.scale
    lead = 1 if experts else 0
    if x.ndim != 2 + lead or q.ndim != 3 + lead or s.ndim != 3 + lead:
        raise ValueError(f"{what}: x {tuple(x.shape)} and qdata {tuple(q.shape)} are not "
                         + ("an expert bank's [E, C, D] and [E, G, B, N]" if experts
                            else "one 2-D weight's [M, D] and [G, B, N]"))
    E = x.shape[0] if experts else 1
    M, D = x.shape[-2:]
    Gp, Bq, N = q.shape[-3:]
    G = s.shape[-3]
    if not (x.is_cuda and q.device == x.device and s.device == x.device):
        raise ValueError(f"{what}: x and the weight must be on one CUDA device")
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise ValueError(f"{what}: qdata {q.dtype} / scale {s.dtype}, want int8 / float32")
    if x.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"{what}: x {x.dtype}, the kernel takes bf16 or fp16")
    if not 1 <= M <= MAX_KERNEL_ROWS:
        raise ValueError(f"{what}: {M} rows, the kernel takes 1 to {MAX_KERNEL_ROWS}")
    if N % COLS or tuple(s.shape[-3:]) != (G, 1, N) or G * Bq != D \
            or Gp != (G // 2 if w.nibbles else G) \
            or (experts and not (q.shape[0] == s.shape[0] == E)):
        raise ValueError(
            f"{what}: x {tuple(x.shape)}, qdata {tuple(q.shape)}, scale "
            f"{tuple(s.shape)} do not fit (N must be a multiple of {COLS})")
    if Bq % STEP:
        raise ValueError(
            f"{what}: quantization blocks of {Bq} rows (D={D}); the kernel's "
            f"tensor-core steps take {STEP} rows, so a block must be a multiple of {STEP}")
    # the base pointers and, for a bank, every expert's slice
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               and (not experts or t.stride(0) * t.element_size() % 16 == 0)
               for t in (x, q, s)):
        raise ValueError(f"{what}: x, qdata and scale must be contiguous and "
                         "16-byte aligned (each expert's slice too)")
    splits, per = split_plan(Gp, N // COLS)
    out = torch.empty(x.shape[:-1] + (N,), dtype=x.dtype, device=x.device)
    dt = "_f16" if x.dtype == torch.float16 else ""
    status = getattr(lib, "dst_quantized_expert_matvec" + dt)(
        E, x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), None,
        M, D, N, Gp, Bq, int(w.nibbles), splits, per, _build.dtype_code(x.dtype),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, ("quantized_expert_matvec" if experts else "quantized_matvec") + dt)
    launches[f"quantized_matvec_{'expert_' if experts else ''}int{w.bits}{dt}"] += 1
    return out


def packed_matvec(x2d: torch.Tensor, w: PackedWeight) -> torch.Tensor:
    """x [M, D] @ w [D, N] for a 2-D packed weight (qdata [G, B, N] or
    nibble planes [G/2, B, N]). A CPU tensor takes
    :func:`packed_matvec_plain`; a CUDA tensor launches the kernel, or raises
    on what it does not take."""
    if x2d.device.type == "cpu":
        return packed_matvec_plain(x2d, w)
    return _launch(x2d, w, experts=False)


def packed_expert_matvec(x3d: torch.Tensor, w: PackedWeight) -> torch.Tensor:
    """x [E, C, D] @ w [E, D, N] for a packed expert bank (qdata
    [E, G, B, N]): every expert's matvec in one launch, each expert's rows
    bitwise what :func:`packed_matvec` gives on that expert alone (the same
    split plan, the same fold order). A CPU tensor takes
    :func:`packed_expert_matvec_plain`; a CUDA tensor launches the kernel,
    or raises on what it does not take."""
    if x3d.device.type == "cpu":
        return packed_expert_matvec_plain(x3d, w)
    return _launch(x3d, w, experts=True)


def packed_expert_proj(x: torch.Tensor, w: PackedWeight) -> Optional[torch.Tensor]:
    """x [E, C, D] @ w [E, D, N] for a packed expert bank through the expert
    matvec (JAX ``packed_expert_proj``, ``quantized_matmul.py:391``); None
    when it does not apply, as there: more than :func:`matvec_max_rows` rows
    an expert, a weight that is not a bank, or N off the 128 grid. The
    caller then multiplies the dequantized bank."""
    if w.qdata.ndim != 4 or w.scale.shape[-1] % COLS:
        return None
    if x.shape[1] > matvec_max_rows():
        return None
    return packed_expert_matvec(x.contiguous(), w)


def packed_proj(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., d] @ w [d, n], where w may be a PackedWeight.

    A dense weight costs one ``isinstance`` (the training path). A packed
    one takes the matvec for up to :func:`matvec_max_rows` rows of x; more
    rows, and on the CPU a column count off the 128 grid, are the dense
    product over the dequantized weight (the JAX package's rule)."""
    if not isinstance(w, PackedWeight):
        return x @ w
    lead = x.shape[:-1]
    rows = x.numel() // x.shape[-1] if x.shape[-1] else 0
    N = w.scale.shape[-1]
    if rows <= matvec_max_rows() and w.qdata.ndim == 3 and (
            N % COLS == 0 or x.device.type != "cpu"):
        x2d = x.reshape(rows, x.shape[-1]).contiguous()
        return packed_matvec(x2d, w).reshape(*lead, N)
    return x @ w.dequantize()
