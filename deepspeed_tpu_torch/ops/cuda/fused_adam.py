"""Fused AdamW update: the CUDA kernel ``csrc/fused_adam.cu`` and its plain
version.

Replaces ``deepspeed_tpu/ops/pallas/fused_adam.py:_adam_kernel`` (line 29),
reached through ``_fused_adam_flat`` (line 41) from ``scale_by_fused_adam``,
together with the rest of the optax chain that
``deepspeed_tpu/runtime/optimizers.py:build_optimizer`` puts after it
(``add_decayed_weights``, ``scale(-1)``, the lr schedule): one pass over a
leaf updates m, v and the parameter in place,

    m = b1 m + (1 - b1) g',  v = b2 v + (1 - b2) g'^2,  g' = g * clip
    p = p - lr * ((m / bc1) / (sqrt(v / bc2) + eps) + wd * p)

Bound on the H100: bytes, 28 per element (p, g, m, v read; p, m, v written)
over 3.35 TB/s. The clip factor stays on the device (read by pointer), so the
step takes no host sync; lr and the bias corrections come from the host's
step count.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

launches = {"fused_adam": 0}  # kernel launches since the last reset


def adam_update_plain(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                      v: torch.Tensor, *, lr: float, b1: float, b2: float,
                      eps: float, wd: float, bc1: float, bc2: float,
                      clip: Optional[torch.Tensor] = None) -> None:
    """The update in fp32 torch ops, in place on p, m and v; the optax
    chain's order of operations."""
    gf = g.float() if clip is None else g.float() * clip
    m.mul_(b1).add_(gf * (1.0 - b1))
    v.mul_(b2).add_(gf * (1.0 - b2) * gf)
    u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    p.sub_((u + wd * p) * lr)


def adam_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, *, lr: float, b1: float, b2: float, eps: float,
                wd: float, bc1: float, bc2: float,
                clip: Optional[torch.Tensor] = None) -> None:
    """One AdamW step of a leaf, in place on p, m, v (fp32, same shape);
    ``clip`` is an fp32 scalar tensor on the leaf's device multiplying g.

    A CPU tensor takes :func:`adam_update_plain`; a CUDA tensor launches the
    kernel, or raises on what the kernel does not take."""
    if p.device.type == "cpu":
        return adam_update_plain(p, g, m, v, lr=lr, b1=b1, b2=b2, eps=eps,
                                 wd=wd, bc1=bc1, bc2=bc2, clip=clip)
    lib = _build.library()
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        if t.device != p.device or t.dtype != torch.float32 \
                or t.shape != p.shape or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"fused_adam: {name} must be fp32, contiguous, 16-byte aligned "
                f"and shaped like p {tuple(p.shape)} on {p.device}; got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if clip is not None and (clip.device != p.device or clip.dtype != torch.float32
                             or clip.numel() != 1):
        raise ValueError("fused_adam: clip must be an fp32 scalar on p's device")
    props = torch.cuda.get_device_properties(p.device)
    status = lib.dst_fused_adam(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(),
        clip.data_ptr() if clip is not None else None,
        float(lr), float(b1), float(b2), 1.0 - b1, 1.0 - b2, float(eps), float(wd),
        float(bc1), float(bc2), props.multi_processor_count,
        torch.cuda.current_stream(p.device).cuda_stream,
    )
    _build.check(status, "fused_adam")
    launches["fused_adam"] += 1
