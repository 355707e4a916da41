"""Flash attention forward and backward: the CUDA kernels
``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu`` and their
plain versions.

The forward replaces ``deepspeed_tpu/ops/pallas/flash_attention.py:_fwd_kernel``
(line 175), driven by ``_flash_fwd`` (line 334) from ``flash_attention``
(line 1011); the backward replaces ``_bwd_dq_kernel`` (line 455) and
``_bwd_dkv_kernel`` (line 517), driven by ``_flash_bwd`` (line 719). The forms
are the models': causal, GQA, and with per-head ALiBi slopes ``slopes`` (fp32
[H]; BLOOM) the term -slope * |q - k| added to each score before the mask
(``_mask_and_bias``, line 94, in all three kernels); no segment ids or dense
bias. ``slopes=None`` runs the kernels' Llama instantiation, the code before
ALiBi came in.

Bound on the H100: operations for long sequences, per visible (query, key)
pair 4 * D flops forward, 6 * D in the dq kernel and 8 * D in the dk/dv
kernel, over 989 TFLOP/s bf16. Each kernel runs 4-warp blocks of mma.sync
bf16 tensor-core products with fp32 accumulation and fp32 softmax state in
registers, loops key (or query) tiles only to (or from) the diagonal, reads
the model layout [B, S, H, D] through strides (no transposes) and masks ragged
S itself, so every length runs through it, where the TPU entry fell back to
XLA without a 128-aligned tile. The dq kernel also writes delta =
rowsum(dO * O) for the dk/dv kernel, which sums the GQA group in registers
(no atomics, one write per output).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import _build

# kernel launches since the last reset; the ALiBi form counts apart
launches = {name + form: 0 for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                                        "flash_attention_bwd_dkv")
            for form in ("", "_alibi")}
# calls of the plain attention on CUDA tensors since the last reset
plain_on_cuda = {"flash_attention_plain": 0}

NEG_INF = -1e30  # the JAX package's mask value (finite: a fully masked row stays finite)
HEAD_DIMS = (64, 128)


def alibi_bias(slopes: torch.Tensor, S: int, device) -> torch.Tensor:
    """[H, S, S] fp32 ALiBi bias slope * -|q - k| for S queries and keys at
    positions 0..S-1 (the JAX ``xla_attention``'s dense form)."""
    pos = torch.arange(S, dtype=torch.float32, device=device)
    rel = -(pos[:, None] - pos[None, :]).abs()
    return slopes.float().to(device)[:, None, None] * rel[None]


def _scores(q: torch.Tensor, kf: torch.Tensor, slopes) -> torch.Tensor:
    """fp32 scores q . k * scale [B,H,S,S] (plus the ALiBi bias) for q
    [B,S,H,D] and k already repeated over the GQA group."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (1.0 / math.sqrt(q.shape[-1]))
    if slopes is not None:
        s = s + alibi_bias(slopes, q.shape[1], q.device)
    return s


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, slopes: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference GQA attention in fp32: (out [B,S,H,D] in q's dtype,
    lse [B,H,S] fp32). q [B,S,H,D]; k, v [B,S,KV,D]; ``slopes`` the ALiBi
    slopes [H] or None."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    if H % KV:
        raise ValueError(f"heads {H} not a multiple of kv heads {KV}")
    if q.is_cuda:
        plain_on_cuda["flash_attention_plain"] += 1
    kf = k.float().repeat_interleave(H // KV, dim=2)
    vf = v.float().repeat_interleave(H // KV, dim=2)
    s = _scores(q, kf, slopes)
    if causal:
        above = torch.ones(S, k.shape[1], dtype=torch.bool,
                           device=q.device).triu(1)
        s = s.masked_fill(above, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vf)
    return out.to(q.dtype), lse


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


def _check_inputs(fn: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  **more: torch.Tensor) -> None:
    """Raise on what the kernels do not take: q [B,S,H,D], k/v [B,S,KV,D],
    bf16 on one CUDA device, D 64 or 128; ``more`` are q-shaped."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    named = {"q": q, "k": k, "v": v, **more}
    if not all(t.is_cuda and t.device == q.device for t in named.values()):
        raise ValueError(f"{fn}: {', '.join(named)} must be on one CUDA device")
    if any(t.dtype != torch.bfloat16 for t in named.values()):
        raise ValueError(
            f"{fn}: the kernel takes bfloat16, got "
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


def form_suffix(slopes: Optional[torch.Tensor]) -> str:
    """The launch counter's suffix of a kernel's form: "_alibi" with
    slopes."""
    return "" if slopes is None else "_alibi"


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
                        causal: bool = True, slopes: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B,S,H,D], lse [B,H,S] fp32) for q [B,S,H,D], k/v [B,S,KV,D],
    with ALiBi when ``slopes`` (fp32 [H]) are given.

    CPU tensors take :func:`flash_attention_plain`; CUDA tensors launch the
    kernel (bf16, head_dim 64 or 128), or raise on what it does not take."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, slopes)
    lib = _build.library()
    _check_inputs("flash_attention_fwd", q, k, v)
    sl = slopes_ptr("flash_attention_fwd", slopes, q)
    B, S, H, D = q.shape
    KV = k.shape[2]
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    status = lib.dst_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, S, H, KV, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        sl, 1.0 / math.sqrt(D), int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "flash_attention_fwd")
    launches["flash_attention_fwd" + form_suffix(slopes)] += 1
    return out, lse


def _plain_p_ds(q, k, v, lse, delta, do, causal, slopes=None):
    """fp32 (p, ds) [B,H,S,S] of the backward, with k/v repeated over the
    GQA group: p = exp(s - lse) on visible pairs, ds = p (dp - delta) scale,
    s with the ALiBi bias when ``slopes`` are given."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    scale = 1.0 / math.sqrt(D)
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    p = torch.exp(_scores(q, kf, slopes) - lse[..., None])
    if causal:
        above = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
        p = p.masked_fill(above, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vf)
    return p, p * (dp - delta[..., None]) * scale


def flash_attention_bwd_dq_plain(q, k, v, o, lse, do, causal: bool = True,
                                 slopes: Optional[torch.Tensor] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference (dq [B,S,H,D] in q's dtype, delta [B,H,S] fp32) in fp32,
    delta = rowsum(do * o)."""
    G = q.shape[2] // k.shape[2]
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    _, ds = _plain_p_ds(q, k, v, lse, delta, do, causal, slopes)
    kf = k.float().repeat_interleave(G, dim=2)
    return torch.einsum("bhqk,bkhd->bqhd", ds, kf).to(q.dtype), delta


def flash_attention_bwd_dkv_plain(q, k, v, lse, delta, do, causal: bool = True,
                                  slopes: Optional[torch.Tensor] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference (dk, dv) [B,S,KV,D] in k's dtype, in fp32, each summed over
    the query heads of its GQA group."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    p, ds = _plain_p_ds(q, k, v, lse, delta, do, causal, slopes)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return (dk.reshape(B, S, KV, H // KV, D).sum(3).to(k.dtype),
            dv.reshape(B, S, KV, H // KV, D).sum(3).to(v.dtype))


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool = True,
                              slopes: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference (dq, dk, dv) of :func:`flash_attention_plain` for the
    upstream gradient ``do``, from the saved ``o`` and ``lse``."""
    dq, delta = flash_attention_bwd_dq_plain(q, k, v, o, lse, do, causal, slopes)
    return (dq, *flash_attention_bwd_dkv_plain(q, k, v, lse, delta, do, causal,
                                               slopes))


def flash_attention_bwd_dq(q, k, v, o, lse, do, causal: bool = True,
                           slopes: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dq [B,S,H,D], delta [B,H,S] fp32): the dq kernel, which also writes
    delta for :func:`flash_attention_bwd_dkv`. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, o, lse, do, causal, slopes)
    lib = _build.library()
    _check_inputs("flash_attention_bwd_dq", q, k, v, o=o, do=do)
    _check_rows("flash_attention_bwd_dq", q, lse=lse)
    sl = slopes_ptr("flash_attention_bwd_dq", slopes, q)
    B, S, H, D = q.shape
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    status = lib.dst_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, S, H, k.shape[2], D,
        _build.strides_array(q, k, v, o, do, dq), sl, 1.0 / math.sqrt(D),
        int(bool(causal)), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "flash_attention_bwd_dq")
    launches["flash_attention_bwd_dq" + form_suffix(slopes)] += 1
    return dq, delta


def flash_attention_bwd_dkv(q, k, v, lse, delta, do, causal: bool = True,
                            slopes: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B,S,KV,D], summed over each GQA group: the dk/dv kernel.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, lse, delta, do, causal, slopes)
    lib = _build.library()
    _check_inputs("flash_attention_bwd_dkv", q, k, v, do=do)
    _check_rows("flash_attention_bwd_dkv", q, lse=lse, delta=delta)
    sl = slopes_ptr("flash_attention_bwd_dkv", slopes, q)
    B, S, H, D = q.shape
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    status = lib.dst_flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S, H, k.shape[2], D,
        _build.strides_array(q, k, v, do, dk, dv), sl, 1.0 / math.sqrt(D),
        int(bool(causal)), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "flash_attention_bwd_dkv")
    launches["flash_attention_bwd_dkv" + form_suffix(slopes)] += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        slopes: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's saved ``o`` and ``lse`` (and the
    slopes it took): the dq kernel, then the dk/dv kernel on the same
    stream."""
    dq, delta = flash_attention_bwd_dq(q, k, v, o, lse, do, causal, slopes)
    return (dq, *flash_attention_bwd_dkv(q, k, v, lse, delta, do, causal, slopes))
