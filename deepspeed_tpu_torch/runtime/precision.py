"""Dynamic loss scaling for fp16 training.

Counterpart of ``deepspeed_tpu/runtime/precision.py`` (DeepSpeed's
``DynamicLossScaler``): the loss is multiplied by the scale before backward,
the gradients divided by it after; a step whose gradients hold a non-finite
element is skipped, and the scale moves by the reference rules:

- an overflow is absorbed by the hysteresis first: while ``hysteresis_left``
  is above 1 it counts down and the scale stays; then the scale halves,
  never below ``min_loss_scale``; either way the good steps restart at 0;
- after ``loss_scale_window`` good steps in a row the scale doubles;
- the hysteresis refills on every good step under
  ``consecutive_hysteresis``, otherwise only when the scale grows;
- a static scale (``loss_scale`` > 0) never moves, and an fp16-off run keeps
  scale 1; an overflow still skips the step.

The JAX package carries the state as device scalars inside its jitted step;
the port's engine reads the overflow flag on the host once a step (as the
JAX engine does under fp16), so the state lives on the host, its scale an
fp32 number as the JAX leaf is.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from ..config import FP16Config


class LossScaleState(NamedTuple):
    scale: np.float32
    good_steps: np.int32
    hysteresis_left: np.int32


def init_loss_scale(cfg: FP16Config, enabled: bool) -> LossScaleState:
    """The initial state: the configured scale (2**initial_scale_power, or
    the static ``loss_scale``) under fp16, else 1."""
    return LossScaleState(np.float32(cfg.initial_scale if enabled else 1.0),
                          np.int32(0), np.int32(cfg.hysteresis))


def update_loss_scale(state: LossScaleState, overflow: bool, cfg: FP16Config,
                      enabled: bool) -> LossScaleState:
    """One reference-semantics scaler step (the state itself unless fp16 with
    a dynamic scale)."""
    if not enabled or not cfg.dynamic:
        return state
    scale, good, hyst = state
    full = np.int32(cfg.hysteresis)
    if overflow:
        if hyst <= 1:
            return LossScaleState(max(np.float32(scale / np.float32(2.0)),
                                      np.float32(cfg.min_loss_scale)), np.int32(0), hyst)
        return LossScaleState(scale, np.int32(0), np.int32(hyst - 1))
    grown = good + 1 >= cfg.loss_scale_window
    new_hyst = full if cfg.consecutive_hysteresis or grown else hyst
    if grown:
        return LossScaleState(np.float32(scale * np.float32(2.0)), np.int32(0), new_hyst)
    return LossScaleState(scale, np.int32(good + 1), new_hyst)


def unscale_(grads: List[torch.Tensor], inv: float) -> torch.Tensor:
    """Multiply ``grads`` in place by ``inv`` (an fp32 value: the product is
    fp32's, as JAX's ``g * inv``) and return a device flag (float32 0-d, 1 for
    overflow): whether any element of the products is not finite. Every
    element is tested (a finite norm does not prove the elements finite, and
    a norm of finite elements can overflow), in one multi-tensor pass that
    tests each element before it multiplies it; a factor above 1 (a scale
    below 1) can carry a finite element past fp32's range, so then the
    products are tested again, as JAX tests them after the multiply."""
    if not grads:
        return torch.zeros(())
    found = torch.zeros((), device=grads[0].device)
    torch._amp_foreach_non_finite_check_and_unscale_(
        grads, found, torch.full((), inv, device=found.device))
    if inv > 1.0:
        torch._amp_foreach_non_finite_check_and_unscale_(
            grads, found, torch.ones((), device=found.device))
    return found
