"""Optimizer factory.

Counterpart of ``deepspeed_tpu/runtime/optimizers.py:build_optimizer``
(line 31) for ``adam`` / ``adamw`` / ``fusedadam``, whose optax chain is
``scale_by_(fused_)adam`` → ``add_decayed_weights(wd)`` → ``scale(-1)`` →
lr, that is p ← p − lr·(m̂/(√v̂+eps) + wd·p). The state is fp32 m and v
trees beside the fp32 masters; the update is in place. With the fused kernel
on (``tpu_kernels.fused_adam``), each leaf is one launch of the CUDA kernel
(``ops/cuda/fused_adam.py``; its plain version for CPU tensors); otherwise
the same arithmetic runs as torch ops.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..config import OptimizerConfig
from ..ops.cuda.fused_adam import adam_update, adam_update_plain
from ..utils.tree import tree_leaves, tree_map

ADAM_NAMES = ("adam", "adamw", "fusedadam")


class AdamW:
    """AdamW over a parameter tree, driven by the engine's host step count:
    step ``t`` (0-based) uses lr = schedule(t) and the bias corrections of
    count t + 1, as the optax chain's counters give them."""

    def __init__(self, cfg: OptimizerConfig, lr_schedule: Callable[[int], float],
                 fused: bool):
        self.b1, self.b2 = cfg.betas
        self.eps = cfg.eps
        self.weight_decay = cfg.weight_decay
        self.lr_schedule = lr_schedule
        self.fused = fused

    def init(self, params) -> Dict[str, object]:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    def step(self, params, grads, state, step: int,
             clip: Optional[torch.Tensor] = None) -> None:
        """Update ``params`` and ``state`` in place from ``grads`` (a tree of
        fp32 tensors), each grad multiplied by ``clip`` (a device scalar)."""
        t = step + 1
        update = adam_update if self.fused else adam_update_plain
        kw = dict(lr=self.lr_schedule(step), b1=self.b1, b2=self.b2, eps=self.eps,
                  wd=self.weight_decay, bc1=1.0 - self.b1 ** t,
                  bc2=1.0 - self.b2 ** t, clip=clip)
        with torch.no_grad():
            for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                                  tree_leaves(state["mu"]), tree_leaves(state["nu"])):
                update(p, g, m, v, **kw)


def build_optimizer(cfg: OptimizerConfig, lr_schedule: Callable[[int], float], *,
                    use_fused_adam: bool = False) -> AdamW:
    """The optimizer of an "optimizer" config section; the types a later
    slice ports raise ``NotImplementedError``."""
    name = cfg.type.lower().replace("_", "")
    if name not in ADAM_NAMES:
        raise NotImplementedError(
            f"optimizer type {cfg.type!r} is not ported yet (the port has "
            f"{', '.join(ADAM_NAMES)}; the others: ROADMAP queue A item 6, "
            "1-bit optimizers item 11)"
        )
    return AdamW(cfg, lr_schedule, fused=use_fused_adam)
