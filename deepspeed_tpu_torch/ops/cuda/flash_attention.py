"""Flash attention forward and backward: the CUDA kernels
``csrc/flash_attention_fwd.cu``, ``csrc/flash_attention_bwd.cu`` and
``csrc/flash_attention_bias_grad.cu`` and their plain versions.

The forward replaces ``deepspeed_tpu/ops/pallas/flash_attention.py:_fwd_kernel``
(line 175), driven by ``_flash_fwd`` (line 334) from ``flash_attention``
(line 1011); the backward replaces ``_bwd_dq_kernel`` (line 455) and
``_bwd_dkv_kernel`` (line 517), driven by ``_flash_bwd`` (line 719), and
``_bias_grad_kernel`` (line 570, via ``_bias_grad_call``, line 614). Every
form of the Pallas kernels is here: causal, GQA, per-head ALiBi slopes
``slopes`` (fp32 [H]; BLOOM), segment ids ``segment_ids`` (int32 [B, S]:
packed sequences attend inside their own segment), a dense additive
``bias`` [B|1, H|1, S, S] (fp32 or bf16; its gradient comes from the dq
kernel for a full bias, ``emit_dbias``, and from the bias-gradient kernel
for a broadcast one) and a block-sparse ``layout`` ([S/blk, S/blk] 0/1 at
``blk`` tokens, a multiple of 128 dividing S: only the active blocks are
read, through compaction tables made once per layout and device,
:func:`block_tables`), and the position ``offsets`` (qoff, koff) of a ring
attention hop (``has_offsets``, ``_flash_fwd``'s ``offsets=``, line 334: the
local query chunk sits at global positions qoff.., the visiting key chunk at
koff.., which places the causal diagonal and the ALiBi distance; its
``segment_ids`` may then be a (query ids, key ids) pair, the key chunk's ids
travelling with it, ``_broadcast_segment_ids``, line 315). A row that sees no
key (a hop whose chunk lies wholly in the future) gives out = 0 and lse =
-1e30, the JAX package's finite ``NEG_INF``, in every masked form and plain
version. The terms enter each score as ``_mask_and_bias``
(line 94) adds them: the bias, then ALiBi, then the causal, segment and
layout masks. ``slopes`` alone runs the kernels' ALiBi instantiation, nothing
their Llama one (the code before ALiBi came in); a mask selects the masked
instantiation, which reads its operands at run time.

The Llama form (no slopes, bias, segment ids, layout or offsets) also has
an fp16 instantiation of each of the three kernels, for fp16 training
(``csrc/flash_attention_fwd_f16.cu``, ``csrc/flash_attention_bwd_f16.cu``:
separate C entries, the same kernels with fp16 operands, P and dS rounded to
fp16 as the Pallas kernels round them to the inputs' dtype, an overflow kept
as inf); counted under ``*_f16``. An fp16 tensor in any other form raises,
naming ROADMAP A6 part 2.

Bound on the H100: operations for long sequences, per visible (query, key)
pair 4 * D flops forward, 6 * D in the dq kernel and 8 * D in the dk/dv
kernel, over 989 TFLOP/s bf16; the bias-gradient kernel's 4 * D per visible
pair and (batch row, head) is below its bytes (the bias read, dbias written
once). All four kernels are written for Hopper: wgmma products on tiles
that TMA streams through a ring of shared-memory stages, read through 4-D
tensor maps (:func:`tma_map`; a dense bias through :func:`bias_tma_map`),
each tile judged empty, full or partial against the masks before it is
loaded; the bias-gradient kernel holds its output tile (:func:`bias_grad_tile`
keys by 128 query rows) in registers while it walks the (batch row, head)
pairs that read it. All keep fp32 accumulators and softmax state in
registers, loop key (or query) tiles only to (or from) the
diagonal and only through the layout's active blocks, read the model layout
[B, S, H, D] through strides (no transposes) and handle ragged S
themselves, so every length runs through them, where the TPU entry fell
back to XLA without a 128-aligned tile. The dq kernel also writes delta =
rowsum(dO * O) for the dk/dv kernel, which sums the GQA group in registers
(no atomics, one write per output); the bias-gradient kernel sums the
broadcast dims in registers, one write per output element.
"""

from __future__ import annotations

import ctypes
import itertools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import _build

KERNEL_NAMES = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
TERMS = ("alibi", "bias", "sparse", "seg", "offsets")
# a kernel's forms: its launch counter's suffix names the terms it took
# (ALiBi, a dense bias, a block-sparse layout, segment ids, ring-hop position
# offsets); a dense bias never combines with a layout, and offsets with
# neither
FORMS = tuple("".join(f"_{p}" for p, on in zip(TERMS, bits) if on)
              for bits in itertools.product((False, True), repeat=len(TERMS))
              if not (bits[1] and bits[2]) and not (bits[4] and (bits[1] or bits[2])))
# kernel launches since the last reset, per kernel and form; "_f16": the
# fp16 Llama form (csrc/flash_attention_fwd_f16.cu, _bwd_f16.cu)
launches = {**{name + form: 0 for name in KERNEL_NAMES for form in FORMS},
            **{name + "_f16": 0 for name in KERNEL_NAMES},
            "flash_attention_bias_grad": 0}
# calls of the plain attention on CUDA tensors since the last reset
plain_on_cuda = {"flash_attention_plain": 0}

NEG_INF = -1e30  # the JAX package's mask value (finite: a fully masked row stays finite)
HEAD_DIMS = (64, 128)
LAYOUT_BLOCK = 128  # a layout block is a multiple of this many tokens


def alibi_bias(slopes: torch.Tensor, S: int, device, offsets=(0, 0)) -> torch.Tensor:
    """[H, S, S] fp32 ALiBi bias slope * -|q - k| for S queries at positions
    qoff..qoff+S-1 and S keys at koff..koff+S-1, ``offsets`` = (qoff, koff)
    (the JAX ``xla_attention``'s dense form; a ring hop's global positions)."""
    pos = torch.arange(S, dtype=torch.float32, device=device)
    rel = -((pos[:, None] + offsets[0]) - (pos[None, :] + offsets[1])).abs()
    return slopes.float().to(device)[:, None, None] * rel[None]


# ---------------------------------------------------------------------------
# block-sparse layouts
# ---------------------------------------------------------------------------
def compact_rows(layout: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[n, m] 0/1 layout → (idx [n, jmax] int32, counts [n] int32): row r's
    active column indices, ascending, in idx[r, :counts[r]], the rest
    repeating the last one (``_compact_rows``, flash_attention.py:69)."""
    layout = np.asarray(layout)
    counts = (layout != 0).sum(axis=1).astype(np.int32)
    jmax = max(int(counts.max(initial=0)), 1)
    idx = np.zeros((layout.shape[0], jmax), np.int32)
    for r in range(layout.shape[0]):
        cols = np.nonzero(layout[r])[0]
        if len(cols):
            idx[r, : len(cols)] = cols
            idx[r, len(cols):] = cols[-1]
    return idx, counts


def check_layout(fn: str, layout: np.ndarray, S: int) -> int:
    """The layout's block in tokens; raises unless ``layout`` is a square
    [S/blk, S/blk] table with blk a multiple of 128."""
    n = layout.shape[0] if layout.ndim == 2 else 0
    if layout.ndim != 2 or layout.shape[1] != n or n == 0 or S % n \
            or (S // n) % LAYOUT_BLOCK:
        raise ValueError(
            f"{fn}: block layout {tuple(layout.shape)} does not tile seq {S} in "
            f"square blocks of a multiple of {LAYOUT_BLOCK} tokens"
        )
    return S // n


_TABLES: Dict[tuple, tuple] = {}


def _layout_key(layout: np.ndarray, device) -> tuple:
    return (layout.shape, np.ascontiguousarray(layout != 0).tobytes(), str(device))


def block_tables(layout: np.ndarray, device) -> Tuple[torch.Tensor, ...]:
    """(kcols, kcounts, qrows, qcounts) int32 on ``device``: the compaction
    tables of ``layout`` per query row (forward, dq) and per key column
    (dk/dv), made once per (layout, device) and kept, so a layer call does
    no host-to-device copy."""
    key = ("tables",) + _layout_key(layout, device)
    if key not in _TABLES:
        tabs = (*compact_rows(layout), *compact_rows(np.asarray(layout).T))
        _TABLES[key] = tuple(torch.from_numpy(t).to(device) for t in tabs)
    return _TABLES[key]


def layout_mask(layout: np.ndarray, S: int, device) -> torch.Tensor:
    """bool [S, S]: the layout expanded to tokens (the plain versions' mask),
    made once per (layout, S, device)."""
    key = ("mask", S) + _layout_key(layout, device)
    if key not in _TABLES:
        blk = S // layout.shape[0]
        tok = np.kron(np.asarray(layout) != 0, np.ones((blk, blk), bool))
        _TABLES[key] = torch.from_numpy(tok).to(device)
    return _TABLES[key]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def check_bias(fn: str, bias: torch.Tensor, q: torch.Tensor) -> None:
    """Raise unless ``bias`` is [B|1, H|1, S, S] for q [B, S, H, D] (the
    Pallas kernel's in-kernel bias, ``bias_ok``, flash_attention.py:1063)."""
    B, S, H, _ = q.shape
    if bias.ndim != 4 or bias.shape[0] not in (1, B) or bias.shape[1] not in (1, H) \
            or tuple(bias.shape[2:]) != (S, S):
        raise ValueError(
            f"{fn}: dense bias shape {tuple(bias.shape)} is not [B|1, H|1, S, S] "
            f"= [{B}|1, {H}|1, {S}, {S}]"
        )


def _offsets(offsets) -> Tuple[int, int]:
    return (0, 0) if offsets is None else (int(offsets[0]), int(offsets[1]))


def _segment_pair(segment_ids):
    """(query ids, key ids) of ``segment_ids``: one [B, S] tensor for both,
    or a pair."""
    if isinstance(segment_ids, (tuple, list)):
        return tuple(segment_ids)
    return segment_ids, segment_ids


def _scores(q: torch.Tensor, kf: torch.Tensor, slopes, bias=None,
            offsets=None) -> torch.Tensor:
    """fp32 scores q . k * scale [B,H,S,S] (plus the dense bias, then the
    ALiBi bias at the ``offsets``' positions) for q [B,S,H,D] and k already
    repeated over the GQA group."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (1.0 / math.sqrt(q.shape[-1]))
    if bias is not None:
        s = s + bias.float()
    if slopes is not None:
        s = s + alibi_bias(slopes, q.shape[1], q.device, _offsets(offsets))
    return s


def _visible(q, causal, segment_ids, layout, offsets=None) -> Optional[torch.Tensor]:
    """bool [B|1, 1, S, S]: the (query, key) pairs the causal (at the
    ``offsets``' global positions), segment and layout masks keep; None when
    there is no mask."""
    S = q.shape[1]
    qoff, koff = _offsets(offsets)
    vis = (torch.ones(S, S, dtype=torch.bool, device=q.device).tril(qoff - koff)
           if causal else None)
    if layout is not None:
        check_layout("flash_attention_plain", layout, S)
        tok = layout_mask(layout, S, q.device)
        vis = tok if vis is None else vis & tok
    if segment_ids is not None:
        seg_q, seg_k = _segment_pair(segment_ids)
        same = seg_q[:, :, None] == seg_k[:, None, :]
        vis = same if vis is None else vis & same
    if vis is None:
        return None
    return vis.reshape(-1, 1, S, S)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, slopes: Optional[torch.Tensor] = None,
                          bias: Optional[torch.Tensor] = None,
                          segment_ids=None, layout: Optional[np.ndarray] = None,
                          offsets: Optional[Tuple[int, int]] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference GQA attention in fp32: (out [B,S,H,D] in q's dtype,
    lse [B,H,S] fp32). q [B,S,H,D]; k, v [B,S,KV,D]; ``slopes`` the ALiBi
    slopes [H], ``bias`` an additive bias broadcastable to [B,H,S,S],
    ``segment_ids`` [B,S] (or a (query, key) pair), ``layout`` a block-sparse
    layout, ``offsets`` a ring hop's (qoff, koff), each or None. A row with
    no visible key gives out 0 and lse -1e30."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    if H % KV:
        raise ValueError(f"heads {H} not a multiple of kv heads {KV}")
    if q.is_cuda:
        plain_on_cuda["flash_attention_plain"] += 1
    kf = k.float().repeat_interleave(H // KV, dim=2)
    vf = v.float().repeat_interleave(H // KV, dim=2)
    s = _scores(q, kf, slopes, bias, offsets)
    vis = _visible(q, causal, segment_ids, layout, offsets)
    if vis is not None:
        s = s.masked_fill(~vis, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    if vis is not None:  # zero already but on a row that sees no key
        p = p.masked_fill(~vis, 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    return out.to(q.dtype), lse


def _plain_p_dst(q, k, v, lse, delta, do, causal, slopes=None, bias=None,
                 segment_ids=None, layout=None, offsets=None):
    """fp32 (p, dst) [B,H,S,S] of the backward, with k/v repeated over the
    GQA group: p = exp(s - lse) on visible pairs, dst = p (dp - delta) (the
    score's gradient; ds = dst * scale)."""
    G = q.shape[2] // k.shape[2]
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    p = torch.exp(_scores(q, kf, slopes, bias, offsets) - lse[..., None])
    vis = _visible(q, causal, segment_ids, layout, offsets)
    if vis is not None:
        p = p.masked_fill(~vis, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vf)
    return p, p * (dp - delta[..., None])


def flash_attention_bwd_dq_plain(q, k, v, o, lse, do, causal: bool = True,
                                 slopes: Optional[torch.Tensor] = None, bias=None,
                                 segment_ids=None, layout=None, emit_dbias: bool = False,
                                 offsets=None):
    """Reference (dq [B,S,H,D] in q's dtype, delta [B,H,S] fp32) in fp32,
    delta = rowsum(do * o); with ``emit_dbias`` also the full bias's
    gradient [B,H,S,S] in the bias's dtype. A ring hop passes the ring's
    final ``o`` and ``lse`` with its ``offsets``."""
    G = q.shape[2] // k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    _, dst = _plain_p_dst(q, k, v, lse, delta, do, causal, slopes, bias, segment_ids,
                          layout, offsets)
    kf = k.float().repeat_interleave(G, dim=2)
    dq = torch.einsum("bhqk,bkhd->bqhd", dst * scale, kf).to(q.dtype)
    if emit_dbias:
        return dq, delta, dst.to(bias.dtype)
    return dq, delta


def flash_attention_bwd_dkv_plain(q, k, v, lse, delta, do, causal: bool = True,
                                  slopes: Optional[torch.Tensor] = None, bias=None,
                                  segment_ids=None, layout=None, offsets=None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference (dk, dv) [B,S,KV,D] in k's dtype, in fp32, each summed over
    the query heads of its GQA group."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    p, dst = _plain_p_dst(q, k, v, lse, delta, do, causal, slopes, bias, segment_ids,
                          layout, offsets)
    dk = torch.einsum("bhqk,bqhd->bkhd", dst * (1.0 / math.sqrt(D)), q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return (dk.reshape(B, S, KV, H // KV, D).sum(3).to(k.dtype),
            dv.reshape(B, S, KV, H // KV, D).sum(3).to(v.dtype))


def flash_attention_bias_grad_plain(q, k, v, bias, lse, delta, do, causal: bool = True,
                                    slopes: Optional[torch.Tensor] = None,
                                    segment_ids=None) -> torch.Tensor:
    """Reference gradient of ``bias`` [B|1, H|1, S, S]: p (dp - delta) summed
    over the dims the bias broadcasts, in the bias's dtype."""
    _, dst = _plain_p_dst(q, k, v, lse, delta, do, causal, slopes, bias, segment_ids)
    dims = [d for d in (0, 1) if bias.shape[d] == 1]
    return (dst.sum(dims, keepdim=True) if dims else dst).to(bias.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool = True,
                              slopes: Optional[torch.Tensor] = None, bias=None,
                              segment_ids=None, layout=None, bias_grad: bool = False):
    """Reference (dq, dk, dv) of :func:`flash_attention_plain` for the
    upstream gradient ``do``, from the saved ``o`` and ``lse``; with
    ``bias_grad`` also the bias's gradient."""
    dq, delta = flash_attention_bwd_dq_plain(q, k, v, o, lse, do, causal, slopes, bias,
                                             segment_ids, layout)
    grads = (dq, *flash_attention_bwd_dkv_plain(q, k, v, lse, delta, do, causal, slopes,
                                                bias, segment_ids, layout))
    if bias_grad:
        grads += (flash_attention_bias_grad_plain(q, k, v, bias, lse, delta, do, causal,
                                                  slopes, segment_ids),)
    return grads


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def strides_ok(t: torch.Tensor) -> bool:
    """Whether the kernels can read ``t`` by its strides: a contiguous last
    dim, strides divisible by 8 and a 16-byte aligned start."""
    return t.stride(-1) == 1 and not any(st % 8 for st in t.stride()[:-1]) \
        and t.data_ptr() % 16 == 0


def _check_strides(fn: str, name: str, t: torch.Tensor) -> None:
    if not strides_ok(t):
        raise ValueError(
            f"{fn}: {name} needs a contiguous last dim, strides divisible "
            "by 8 and a 16-byte aligned start"
        )


TMA_BOX_COLS = 64  # a tile's columns a TMA box: 128 bytes of bf16, the swizzle's span
TMA_ROWS = 128     # a block's own rows (forward: q; dq: q, do; dk/dv: k, v)


def tma_map(fn: str, name: str, t: torch.Tensor, rows: int) -> dict:
    """The 4-D tensor map the flash kernels read ``t`` [B, S, H, D] (bf16)
    through: dims (D, S, H, B), byte strides of S, H and B, a box of 64
    columns x ``rows`` rows, and the start address; the C side
    (``csrc/flash_attention_sm90.cuh:encode_rows_map``) encodes the same
    numbers from the strides it is given. Raises on what TMA refuses: a last
    dim that is not contiguous, a start not 16-byte aligned, a stride that is
    not a multiple of 16 bytes or not below 2**40 bytes, a dim above 2**32,
    a head dim that is not whole boxes, a box of more than 256 rows."""
    B, S, H, D = t.shape
    esize = t.element_size()
    strides = tuple(esize * st for st in (t.stride(1), t.stride(2), t.stride(0)))
    base = t.data_ptr()
    problems = []
    if t.stride(3) != 1:
        problems.append("a last dim that is not contiguous")
    if base % 16:
        problems.append(f"a start address {base:#x} not 16-byte aligned")
    bad = [st for st in strides if st % 16 or not 0 <= st < 2 ** 40]
    if bad:
        problems.append(f"byte strides {bad} not multiples of 16 below 2**40")
    if any(d > 2 ** 32 for d in (D, S, H, B)):
        problems.append(f"a dim of {(D, S, H, B)} above 2**32")
    if D % TMA_BOX_COLS or not 0 < rows <= 256:
        problems.append(f"head dim {D} not whole boxes of {TMA_BOX_COLS} or box rows {rows}")
    if problems:
        raise ValueError(f"{fn}: TMA cannot read {name} {tuple(t.shape)}, strides "
                         f"{t.stride()}: " + "; ".join(problems))
    return {"dims": (D, S, H, B), "strides": strides, "box": (TMA_BOX_COLS, rows, 1, 1),
            "base": base}


def ring_tile(head_dim: int, masked: bool) -> int:
    """Rows a tile of a flash kernel's ring (forward and dq: k and v; dk/dv:
    q and do) and so its map's box: 128 for the unmasked forms (Llama,
    ALiBi, offsets alone) at head dim 64, else 64
    (``csrc/flash_attention_fwd.cu:FwdSmem``,
    ``csrc/flash_attention_bwd.cu:DqSmem``, ``DkvSmem``)."""
    return 128 if head_dim == 64 and not masked else 64


def bias_grad_tile(head_dim: int) -> int:
    """Keys of the bias-gradient kernel's output tile of 128 query rows,
    and so the box of its k and v maps: 64 at head dim 64, 32 at 128, where
    a ring stage's 128 rows of q and do take twice the shared memory
    (``csrc/flash_attention_bias_grad.cu:BgSmem``)."""
    return 64 if head_dim == 64 else 32


def bias_tma_map(fn: str, bias: torch.Tensor, B: int, H: int, rows: int = TMA_ROWS) -> dict:
    """The 4-D tensor map the forward kernel reads a dense ``bias``
    [B|1, H|1, S, S] (fp32 or bf16) through: dims (S keys, S queries, H or 1,
    B or 1; a broadcast dim, size 1 or stride 0, is read at coordinate 0),
    byte strides of the query rows, heads and batch rows (a broadcast dim's
    is the span of the dims inside it), a box of 128 bytes of keys x
    ``rows`` query rows, and the start address; the C side
    (``csrc/flash_attention_sm90.cuh:encode_bias_map``) encodes the same
    numbers from the mask's strides. Raises on what TMA refuses: a key dim
    that is not contiguous, a start not 16-byte aligned, a stride that is
    not a multiple of 16 bytes or not below 2**40 bytes."""
    S = bias.shape[-1]
    esize = bias.element_size()
    sb = bias.stride(0) if bias.shape[0] > 1 else 0
    sh = bias.stride(1) if bias.shape[1] > 1 else 0
    dims = (S, S, H if sh else 1, B if sb else 1)
    st_q = esize * bias.stride(2)
    st_h = esize * sh if sh else st_q * S
    st_b = esize * sb if sb else st_h * dims[2]
    strides = (st_q, st_h, st_b)
    base = bias.data_ptr()
    problems = []
    if bias.stride(3) != 1:
        problems.append("a key dim that is not contiguous")
    if base % 16:
        problems.append(f"a start address {base:#x} not 16-byte aligned")
    bad = [st for st in strides if st % 16 or not 0 < st < 2 ** 40]
    if bad:
        problems.append(f"byte strides {bad} not multiples of 16 below 2**40")
    if problems:
        raise ValueError(f"{fn}: TMA cannot read the bias {tuple(bias.shape)}, strides "
                         f"{bias.stride()}: " + "; ".join(problems))
    return {"dims": dims, "strides": strides, "box": (128 // esize, rows, 1, 1),
            "base": base}


def tma_bias(bias: torch.Tensor, B: int, H: int) -> torch.Tensor:
    """``bias`` as the forward kernel reads it: itself where TMA takes its
    start and strides (:func:`bias_tma_map`), else a copy whose query rows
    are padded to a multiple of 16 bytes (a ragged S, a strided view), whose
    [..., :S] view the kernel reads."""
    try:
        bias_tma_map("tma_bias", bias, B, H)
        return bias
    except ValueError:
        S = bias.shape[-1]
        per = 16 // bias.element_size()
        padded = torch.zeros((*bias.shape[:3], -(-S // per) * per), dtype=bias.dtype,
                             device=bias.device)
        padded[..., :S] = bias
        return padded[..., :S]


def fwd_tma_maps(fn: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, masked: bool = False) -> dict:
    """The forward kernel's tensor maps, as its host side encodes them: q in
    boxes of :data:`TMA_ROWS` rows, k and v in boxes of its ring tile
    (:func:`ring_tile` of the head dim and the form; ``masked``: segment
    ids, a bias or a layout), a dense ``bias`` through :func:`bias_tma_map`.
    Raises on a layout TMA refuses."""
    tile = ring_tile(q.shape[-1], masked or bias is not None)
    maps = {name: tma_map(fn, name, t, rows)
            for name, t, rows in (("q", q, TMA_ROWS), ("k", k, tile), ("v", v, tile))}
    if bias is not None:
        maps["bias"] = bias_tma_map(fn, bias, q.shape[0], q.shape[2])
    return maps


def _check_inputs(fn: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  **more: torch.Tensor) -> None:
    """Raise on what the kernels do not take: q [B,S,H,D], k/v [B,S,KV,D],
    bf16 (or fp16) on one CUDA device, D 64 or 128; ``more`` are q-shaped."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    named = {"q": q, "k": k, "v": v, **more}
    if not all(t.is_cuda and t.device == q.device for t in named.values()):
        raise ValueError(f"{fn}: {', '.join(named)} must be on one CUDA device")
    if q.dtype not in (torch.bfloat16, torch.float16) \
            or any(t.dtype != q.dtype for t in named.values()):
        raise ValueError(
            f"{fn}: the kernel takes bfloat16 (or float16), one dtype, got "
            + "/".join(str(t.dtype) for t in named.values())
        )
    if k.shape != (B, S, KV, D) or v.shape != k.shape \
            or any(t.shape != q.shape for t in more.values()):
        raise ValueError(
            f"{fn}: shapes {[tuple(t.shape) for t in named.values()]} do not "
            f"match q {tuple(q.shape)}"
        )
    if D not in HEAD_DIMS or H % KV:
        raise ValueError(
            f"{fn}: head_dim {D} not in {HEAD_DIMS} or heads {H} not a "
            f"multiple of kv heads {KV}"
        )
    for name, t in named.items():
        _check_strides(fn, name, t)


def _entry(lib, fn: str, q: torch.Tensor, *terms):
    """The C entry of the kernel ``fn`` for q's dtype: the bf16 one, or for
    fp16 the Llama form's, which takes none of ``terms`` (slopes, a bias,
    segment ids, a layout, offsets: their fp16 forms are ROADMAP A6 part 2)."""
    if q.dtype != torch.float16:
        return getattr(lib, f"dst_{fn}")
    taken = [name for name, t in zip(("slopes", "a dense bias", "segment ids", "a layout",
                                      "position offsets"), terms) if t is not None]
    if taken:
        raise NotImplementedError(
            f"{fn}: the fp16 kernel has the Llama form only, not {', '.join(taken)}: "
            f"{_build.FP16_LATER}")
    return getattr(lib, f"dst_{fn}_f16")


def form_suffix(slopes: Optional[torch.Tensor], bias=None, segment_ids=None,
                layout=None, offsets=None, dtype=torch.bfloat16) -> str:
    """The launch counter's suffix of a kernel's form: one ``_alibi``,
    ``_bias``, ``_sparse``, ``_seg``, ``_offsets`` for each term it takes, in
    that order (nothing for the Llama form); ``_f16`` for the fp16 Llama
    form."""
    if dtype == torch.float16:
        return "_f16"
    return "".join(f"_{name}" for name, t in zip(TERMS, (slopes, bias, layout,
                                                         segment_ids, offsets))
                   if t is not None)


def slopes_ptr(fn: str, slopes: Optional[torch.Tensor], q: torch.Tensor):
    """The kernels' slopes argument: None (no ALiBi), or the address of fp32
    [H] contiguous slopes on q's device; raises on anything else."""
    if slopes is None:
        return None
    H = q.shape[2]
    if slopes.shape != (H,) or slopes.dtype != torch.float32 \
            or slopes.device != q.device or not slopes.is_contiguous():
        raise ValueError(
            f"{fn}: ALiBi slopes must be fp32 contiguous [{H}] on {q.device}, got "
            f"{slopes.dtype} {tuple(slopes.shape)} on {slopes.device}"
        )
    return slopes.data_ptr()


def mask_array(fn: str, q: torch.Tensor, bias=None, segment_ids=None, layout=None,
               transposed: bool = False, dbias=None, offsets=None):
    """The kernels' mask argument (``csrc/flash_attention.cuh:parse_mask``):
    None for an unmasked form, else a long long[14] naming the segment ids
    (the queries' and, for a pair, the keys'), the bias with its element
    strides (0 on a broadcast dim) and dtype, the layout's compaction table
    (per query row, or per key column when ``transposed``), a dbias output
    and the position offsets; raises on what the kernels do not take."""
    if bias is None and segment_ids is None and layout is None and offsets is None:
        return None
    B, S, H, _ = q.shape
    vals = [0] * 14
    if offsets is not None and (bias is not None or layout is not None):
        raise ValueError(f"{fn}: position offsets do not combine with a dense bias or a "
                         "block-sparse layout")
    if segment_ids is not None:
        pair = _segment_pair(segment_ids)
        for ids in pair:
            if ids.shape != (B, S) or ids.dtype != torch.int32 \
                    or ids.device != q.device or not ids.is_contiguous():
                raise ValueError(
                    f"{fn}: segment ids must be int32 contiguous [{B}, {S}] on "
                    f"{q.device}, got {ids.dtype} {tuple(ids.shape)} on {ids.device}"
                )
        vals[0] = pair[0].data_ptr()
        if pair[1] is not pair[0]:
            vals[11] = pair[1].data_ptr()
    if bias is not None:
        check_bias(fn, bias, q)
        if bias.dtype not in (torch.float32, torch.bfloat16) \
                or bias.device != q.device or bias.stride(-1) != 1:
            raise ValueError(
                f"{fn}: the bias must be fp32 or bf16 on {q.device} with a contiguous "
                f"last dim, got {bias.dtype} on {bias.device}, strides {bias.stride()}"
            )
        if layout is not None:
            raise ValueError(f"{fn}: a dense bias does not combine with a block-sparse "
                             "layout")
        vals[1] = bias.data_ptr()
        vals[2:6] = [bias.stride(0) if bias.shape[0] > 1 else 0,
                     bias.stride(1) if bias.shape[1] > 1 else 0, bias.stride(2),
                     _build.dtype_code(bias.dtype)]
    if layout is not None:
        blk = check_layout(fn, layout, S)
        kcols, kcounts, qrows, qcounts = block_tables(layout, q.device)
        cols, counts = (qrows, qcounts) if transposed else (kcols, kcounts)
        vals[6:10] = [cols.data_ptr(), counts.data_ptr(), cols.shape[1], blk]
    if dbias is not None:
        vals[10] = dbias.data_ptr()
    vals[12:14] = _offsets(offsets)
    return (ctypes.c_longlong * 14)(*vals)


def _check_rows(fn: str, q: torch.Tensor, **rows: torch.Tensor) -> None:
    """lse / delta: [B, H, S] fp32 contiguous on q's device."""
    B, S, H, _ = q.shape
    for name, t in rows.items():
        if t.shape != (B, H, S) or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(
                f"{fn}: {name} must be fp32 contiguous [{B}, {H}, {S}], got "
                f"{t.dtype} {tuple(t.shape)}"
            )


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, slopes: Optional[torch.Tensor] = None,
                        bias: Optional[torch.Tensor] = None,
                        segment_ids=None, layout: Optional[np.ndarray] = None,
                        offsets: Optional[Tuple[int, int]] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B,S,H,D], lse [B,H,S] fp32) for q [B,S,H,D], k/v [B,S,KV,D],
    with ALiBi when ``slopes`` (fp32 [H]) are given, a dense ``bias``
    [B|1,H|1,S,S], ``segment_ids`` (int32 [B,S], or a (query, key) pair), a
    block-sparse ``layout`` and a ring hop's position ``offsets`` (qoff,
    koff).

    CPU tensors take :func:`flash_attention_plain`; CUDA tensors launch the
    kernel (bf16, or fp16 in the Llama form: no slopes, bias, segment ids,
    layout or offsets; head_dim 64 or 128), or raise on what it does not
    take."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, slopes, bias, segment_ids, layout,
                                     offsets)
    lib = _build.library()
    fn = "flash_attention_fwd"
    _check_inputs(fn, q, k, v)
    entry = _entry(lib, fn, q, slopes, bias, segment_ids, layout, offsets)
    sl = slopes_ptr(fn, slopes, q)
    if bias is not None:
        check_bias(fn, bias, q)
        bias = tma_bias(bias, q.shape[0], q.shape[2])
    mask = mask_array(fn, q, bias, segment_ids, layout, offsets=offsets)
    fwd_tma_maps(fn, q, k, v, bias, any(t is not None for t in (segment_ids, layout)))
    B, S, H, D = q.shape
    KV = k.shape[2]
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    status = entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, S, H, KV, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        sl, 1.0 / math.sqrt(D), int(bool(causal)), mask,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, fn)
    launches[fn + form_suffix(slopes, bias, segment_ids, layout, offsets, q.dtype)] += 1
    return out, lse


def flash_attention_bwd_dq(q, k, v, o, lse, do, causal: bool = True,
                           slopes: Optional[torch.Tensor] = None, bias=None,
                           segment_ids=None, layout=None, emit_dbias: bool = False,
                           offsets: Optional[Tuple[int, int]] = None):
    """(dq [B,S,H,D], delta [B,H,S] fp32): the dq kernel, which also writes
    delta for :func:`flash_attention_bwd_dkv`; with ``emit_dbias`` (a full
    [B,H,S,S] bias) also the bias's gradient in its dtype. A ring hop passes
    the ring's final ``o`` and ``lse`` with its ``offsets``. CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, o, lse, do, causal, slopes, bias,
                                            segment_ids, layout, emit_dbias, offsets)
    lib = _build.library()
    fn = "flash_attention_bwd_dq"
    _check_inputs(fn, q, k, v, o=o, do=do)
    entry = _entry(lib, fn, q, slopes, bias, segment_ids, layout, offsets)
    _check_rows(fn, q, lse=lse)
    tile = ring_tile(q.shape[-1], any(t is not None for t in (bias, segment_ids, layout)))
    for name, t, rows in (("q", q, TMA_ROWS), ("k", k, tile), ("v", v, tile),
                          ("do", do, TMA_ROWS)):
        tma_map(fn, name, t, rows)
    sl = slopes_ptr(fn, slopes, q)
    B, S, H, D = q.shape
    dbias = None
    if emit_dbias:
        if bias is None or tuple(bias.shape) != (B, H, S, S):
            raise ValueError(f"{fn}: emit_dbias needs a full [{B}, {H}, {S}, {S}] bias")
        dbias = torch.empty((B, H, S, S), dtype=bias.dtype, device=q.device)
    mask = mask_array(fn, q, bias, segment_ids, layout, dbias=dbias, offsets=offsets)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    status = entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, S, H, k.shape[2], D,
        _build.strides_array(q, k, v, o, do, dq), sl, 1.0 / math.sqrt(D),
        int(bool(causal)), mask, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, fn)
    launches[fn + form_suffix(slopes, bias, segment_ids, layout, offsets, q.dtype)] += 1
    return (dq, delta, dbias) if emit_dbias else (dq, delta)


def flash_attention_bwd_dkv(q, k, v, lse, delta, do, causal: bool = True,
                            slopes: Optional[torch.Tensor] = None, bias=None,
                            segment_ids=None, layout=None,
                            offsets: Optional[Tuple[int, int]] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B,S,KV,D], summed over each GQA group: the dk/dv kernel.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, lse, delta, do, causal, slopes,
                                             bias, segment_ids, layout, offsets)
    lib = _build.library()
    fn = "flash_attention_bwd_dkv"
    _check_inputs(fn, q, k, v, do=do)
    entry = _entry(lib, fn, q, slopes, bias, segment_ids, layout, offsets)
    _check_rows(fn, q, lse=lse, delta=delta)
    tile = ring_tile(q.shape[-1], any(t is not None for t in (bias, segment_ids, layout)))
    for name, t, rows in (("q", q, tile), ("k", k, TMA_ROWS), ("v", v, TMA_ROWS),
                          ("do", do, tile)):
        tma_map(fn, name, t, rows)
    sl = slopes_ptr(fn, slopes, q)
    mask = mask_array(fn, q, bias, segment_ids, layout, transposed=True, offsets=offsets)
    B, S, H, D = q.shape
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    status = entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S, H, k.shape[2], D,
        _build.strides_array(q, k, v, do, dk, dv), sl, 1.0 / math.sqrt(D),
        int(bool(causal)), mask, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, fn)
    launches[fn + form_suffix(slopes, bias, segment_ids, layout, offsets, q.dtype)] += 1
    return dk, dv


def flash_attention_bias_grad(q, k, v, bias, lse, delta, do, causal: bool = True,
                              slopes: Optional[torch.Tensor] = None,
                              segment_ids=None) -> torch.Tensor:
    """The gradient of ``bias`` [B|1, H|1, S, S] in its dtype, summed over
    the dims it broadcasts: the bias-gradient kernel, from the forward's lse
    and the dq kernel's delta. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return flash_attention_bias_grad_plain(q, k, v, bias, lse, delta, do, causal,
                                               slopes, segment_ids)
    lib = _build.library()
    fn = "flash_attention_bias_grad"
    _check_inputs(fn, q, k, v, do=do)
    if q.dtype == torch.float16:
        raise NotImplementedError(f"{fn}: no fp16 form: {_build.FP16_LATER}")
    _check_rows(fn, q, lse=lse, delta=delta)
    sl = slopes_ptr(fn, slopes, q)
    check_bias(fn, bias, q)
    B, S, H, D = q.shape
    Bb, Hb = bias.shape[:2]
    bias = tma_bias(bias, B, H)
    tile = bias_grad_tile(D)
    for name, t, rows in (("q", q, TMA_ROWS), ("k", k, tile), ("v", v, tile),
                          ("do", do, TMA_ROWS)):
        tma_map(fn, name, t, rows)
    dbias = torch.empty((Bb, Hb, S, S), dtype=bias.dtype, device=q.device)
    mask = mask_array(fn, q, bias, segment_ids, dbias=dbias)
    status = lib.dst_flash_attention_bias_grad(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), B, S, H, k.shape[2], D, Bb, Hb,
        _build.strides_array(q, k, v, do), sl, 1.0 / math.sqrt(D), int(bool(causal)),
        mask, _build.stream_handle(q),
    )
    _build.check(status, fn)
    launches[fn] += 1
    return dbias


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        slopes: Optional[torch.Tensor] = None, bias=None,
                        segment_ids=None, layout=None, bias_grad: bool = False):
    """(dq, dk, dv) from the forward's saved ``o`` and ``lse`` (and the
    terms it took): the dq kernel, then the dk/dv kernel on the same stream.
    With ``bias_grad`` also the bias's gradient, as ``_flash_bwd`` chooses
    (flash_attention.py:748): from the dq kernel for a full [B,H,S,S] bias,
    else from the bias-gradient kernel."""
    B, S, H, _ = q.shape
    emit = bias_grad and tuple(bias.shape[:2]) == (B, H)
    dq, delta, *dbias = flash_attention_bwd_dq(q, k, v, o, lse, do, causal, slopes, bias,
                                               segment_ids, layout, emit)
    grads = (dq, *flash_attention_bwd_dkv(q, k, v, lse, delta, do, causal, slopes, bias,
                                          segment_ids, layout))
    if bias_grad and not emit:
        dbias = [flash_attention_bias_grad(q, k, v, bias, lse, delta, do, causal, slopes,
                                           segment_ids)]
    return grads + tuple(dbias)
