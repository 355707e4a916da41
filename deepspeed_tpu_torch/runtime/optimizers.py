"""Optimizer factory.

Counterpart of ``deepspeed_tpu/runtime/optimizers.py:build_optimizer``
(line 31). Each type is its optax chain written as torch ops in place on the
fp32 masters, leaf by leaf: the transform, then ``add_decayed_weights(wd)``
→ ``scale(-1)`` → the lr at the update count (``_scale_by_schedule_positive``,
line 101), that is p ← p − lr·(u + wd·p), u being

- ``adam`` / ``adamw`` / ``fusedadam``: ``scale_by_(fused_)adam``,
  m̂/(√v̂+eps). With the fused kernel on (``tpu_kernels.fused_adam``), each
  leaf is one launch of the CUDA kernel (``ops/cuda/fused_adam.py``; its
  plain version for CPU tensors); otherwise the same arithmetic as torch ops;
- ``lion``: ``scale_by_lion(b1, b2)``, sign((1−b1)·g + b1·m), then
  m ← (1−b2)·g + b2·m;
- ``adagrad``: ``scale_by_rss(initial_accumulator_value)`` with optax's eps
  1e-7: s ← g² + s, g / √(s + eps) where s > 0;
- ``lamb`` / ``fusedlamb``: ``scale_by_adam`` then ``add_decayed_weights``,
  then ``scale_by_trust_ratio`` (the update times ‖p‖/‖u‖ over the whole
  leaf, 1 where either norm is 0), then the lr (no second decay);
- ``sgd``: ``trace(decay=momentum)``, t ← g + momentum·t (no state at
  momentum 0).

Gradients arrive fp32 and are multiplied by the engine's clip factor (a device
scalar) first. The 1-bit optimizers (``ops/onebit.py``) are not ported.

A checkpoint stores the state under the chain's own leaf names (the
``jax.tree_util.keystr`` paths of the optax state, e.g. ``[0][0].mu['embed']
['tok']`` for AdamW), so that either package resumes the other's:
:meth:`Optimizer.state_items` names each slot's leaves and the chain's update
counts (int32 scalars, the number of updates done: the engine's step count).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import OptimizerConfig
from ..ops.cuda.fused_adam import adam_update, adam_update_plain
from ..utils.tree import tree_items, tree_leaves, tree_map

ADAM_NAMES = ("adam", "adamw", "fusedadam")
OPTIMIZER_NAMES = ADAM_NAMES + ("lion", "adagrad", "lamb", "fusedlamb", "sgd")
ONEBIT_NAMES = ("onebitadam", "zerooneadam", "onebitlamb")
RSS_EPS = 1e-7  # optax.scale_by_rss's default eps, which the JAX chain keeps


class Optimizer:
    """An optax chain over a parameter tree, driven by the engine's host step
    count: step ``t`` (0-based) uses lr = schedule(t) and the counters of
    update t + 1, as the chain's state gives them. A subclass names its
    per-leaf state (``slots``, each made by ``init_slot``) and computes a
    leaf's update direction u in :meth:`direction`."""

    slots: tuple = ()
    # the optax chain's state in its flatten order: ("count", path) for an
    # update count, (slot, path) for a slot's tree under that path
    chain: tuple = ()

    def __init__(self, cfg: OptimizerConfig, lr_schedule: Callable[[int], float]):
        self.b1, self.b2 = cfg.betas
        self.eps = cfg.eps
        self.weight_decay = cfg.weight_decay
        self.lr_schedule = lr_schedule

    slot_fill = 0.0  # every slot's initial value

    def init_slot(self, p: torch.Tensor) -> torch.Tensor:
        return torch.full_like(p, self.slot_fill, dtype=torch.float32)

    def init(self, params) -> Dict[str, object]:
        return {name: tree_map(self.init_slot, params) for name in self.slots}

    def direction(self, p, g, state, t: int) -> torch.Tensor:
        raise NotImplementedError

    def step(self, params, grads, state, step: int,
             clip: Optional[torch.Tensor] = None) -> None:
        """Update ``params`` and ``state`` in place from ``grads`` (a tree of
        fp32 tensors), each grad multiplied by ``clip`` (a device scalar)."""
        slot_leaves = [tree_leaves(state[name]) for name in self.slots]
        with torch.no_grad():
            for i, (p, g) in enumerate(zip(tree_leaves(params), tree_leaves(grads))):
                self.update_leaf(p, g, [leaves[i] for leaves in slot_leaves], step, clip)

    def update_leaf(self, p: torch.Tensor, g: torch.Tensor, slots: List[torch.Tensor],
                    step: int, clip: Optional[torch.Tensor] = None) -> None:
        """One leaf's update in place on ``p`` and its ``slots`` (in
        ``self.slots`` order): a whole leaf, or one layer's slice of a stacked
        leaf (``runtime/bucketed_opt.py``), where a norm-taking transform
        (lamb's trust ratio) sees the slice, as the JAX package's per-layer
        scan does."""
        gf = g.float() if clip is None else g.float() * clip
        u = self.direction(p, gf, slots, step + 1)
        p.sub_(self.decayed(u, p) * self.lr_schedule(step))

    def decayed(self, u: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """``add_decayed_weights``: u + wd·p."""
        return u + self.weight_decay * p

    def state_items(self, state, count: int, prefix: str = "",
                    counts_shape: tuple = ()) -> List[Tuple[str, object]]:
        """The state as the optax chain's named leaves, in its flatten order
        (each slot's tree with its dict keys sorted): each update count an
        int32 scalar holding ``count`` (``counts_shape`` () or, under a
        bucketed state's ``layers``, [L]), each slot leaf the tensor itself,
        every name behind ``prefix``."""
        out: List[Tuple[str, object]] = []
        for kind, path in self.chain:
            if kind == "count":
                out.append((prefix + path, np.full(counts_shape, count, np.int32)))
            else:
                out.extend((prefix + path + name, t)
                           for name, t in tree_items(state[kind], True))
        return out


class AdamW(Optimizer):
    """AdamW; the update of a leaf is one fused kernel launch when ``fused``."""

    slots = ("mu", "nu")
    # chain(chain(scale_by_adam, add_decayed_weights, scale), schedule)
    chain = (("count", "[0][0].count"), ("mu", "[0][0].mu"), ("nu", "[0][0].nu"),
             ("count", "[1].count"))

    def __init__(self, cfg: OptimizerConfig, lr_schedule: Callable[[int], float],
                 fused: bool):
        super().__init__(cfg, lr_schedule)
        self.fused = fused

    def update_leaf(self, p, g, slots, step: int, clip=None) -> None:
        t = step + 1
        m, v = slots
        (adam_update if self.fused else adam_update_plain)(
            p, g, m, v, lr=self.lr_schedule(step), b1=self.b1, b2=self.b2, eps=self.eps,
            wd=self.weight_decay, bc1=1.0 - self.b1 ** t, bc2=1.0 - self.b2 ** t, clip=clip)


class Lion(Optimizer):
    slots = ("mu",)
    # chain(scale_by_lion, add_decayed_weights, scale, schedule)
    chain = (("count", "[0].count"), ("mu", "[0].mu"), ("count", "[3].count"))

    def direction(self, p, g, state, t):
        (m,) = state
        u = torch.sign(g * (1.0 - self.b1) + m * self.b1)
        m.mul_(self.b2).add_(g * (1.0 - self.b2))
        return u


class Adagrad(Optimizer):
    slots = ("sum_of_squares",)
    # chain(scale_by_rss, add_decayed_weights, scale, schedule)
    chain = (("sum_of_squares", "[0].sum_of_squares"), ("count", "[3].count"))

    def __init__(self, cfg: OptimizerConfig, lr_schedule: Callable[[int], float]):
        super().__init__(cfg, lr_schedule)
        self.slot_fill = float(cfg.params.get("initial_accumulator_value", 0.1))

    def direction(self, p, g, state, t):
        (s,) = state
        s.copy_(g * g + s)
        return torch.where(s > 0, torch.rsqrt(s + RSS_EPS), 0.0) * g


class Lamb(Optimizer):
    slots = ("mu", "nu")
    # chain(scale_by_adam, add_decayed_weights, scale_by_trust_ratio, scale,
    # schedule)
    chain = (("count", "[0].count"), ("mu", "[0].mu"), ("nu", "[0].nu"),
             ("count", "[4].count"))

    def direction(self, p, g, state, t):
        m, v = state
        m.copy_(g * (1.0 - self.b1) + m * self.b1)
        v.copy_(g * g * (1.0 - self.b2) + v * self.b2)
        u = (m / (1.0 - self.b1 ** t)) / (torch.sqrt(v / (1.0 - self.b2 ** t)) + self.eps)
        u = u + self.weight_decay * p
        p_norm, u_norm = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
        trust = torch.where((p_norm == 0) | (u_norm == 0), 1.0, p_norm / u_norm)
        return u * trust

    def decayed(self, u, p):
        return u  # the decay went in before the trust ratio


class SGD(Optimizer):
    def __init__(self, cfg: OptimizerConfig, lr_schedule: Callable[[int], float]):
        super().__init__(cfg, lr_schedule)
        self.momentum = float(cfg.params.get("momentum", 0.0))
        self.slots = ("trace",) if self.momentum else ()
        # chain(trace or identity, add_decayed_weights, scale, schedule)
        self.chain = (("trace", "[0].trace"),) * bool(self.momentum) + (("count", "[3].count"),)

    def direction(self, p, g, state, t):
        if not self.momentum:
            return g
        (tr,) = state
        tr.copy_(g + self.momentum * tr)
        return tr


def build_optimizer(cfg: OptimizerConfig, lr_schedule: Callable[[int], float], *,
                    use_fused_adam: bool = False) -> Optimizer:
    """The optimizer of an "optimizer" config section; the 1-bit types raise
    ``NotImplementedError``, an unknown type ``KeyError`` (as the JAX
    package's)."""
    name = cfg.type.lower().replace("_", "")
    if name in ONEBIT_NAMES:
        raise NotImplementedError(
            f"optimizer type {cfg.type!r} is not ported yet: the 1-bit optimizers "
            f"are ROADMAP queue A item 11 (the port has {', '.join(OPTIMIZER_NAMES)})")
    if name in ADAM_NAMES:
        return AdamW(cfg, lr_schedule, fused=use_fused_adam)
    kinds = {"lion": Lion, "adagrad": Adagrad, "lamb": Lamb, "fusedlamb": Lamb, "sgd": SGD}
    if name not in kinds:
        raise KeyError(f"unknown optimizer type {cfg.type!r}")
    return kinds[name](cfg, lr_schedule)
