"""Learning-rate schedules as plain functions of the host-side step count.

Counterpart of ``deepspeed_tpu/runtime/lr_schedules.py`` (WarmupLR,
WarmupDecayLR, WarmupCosineLR, OneCycle, LRRangeTest). The JAX package
traces them inside the jitted step; the port's step count lives on the host,
so each schedule maps an int step to a Python float, and the update kernel
takes the lr as a scalar argument.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

Schedule = Callable[[int], float]


def _clip(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi)


def warmup_lr(warmup_min_lr=0.0, warmup_max_lr=1e-3, warmup_num_steps=1000,
              warmup_type="log", **_) -> Schedule:
    """WarmupLR: warm up then hold at warmup_max_lr."""
    warmup_num_steps = max(warmup_num_steps, 1)

    def schedule(step: int) -> float:
        s = float(step) + 1.0
        if warmup_type == "log":
            frac = math.log(s) / math.log(max(warmup_num_steps, 2))
        else:
            frac = s / float(warmup_num_steps)
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * _clip(frac, 0.0, 1.0)

    return schedule


def warmup_decay_lr(total_num_steps, warmup_min_lr=0.0, warmup_max_lr=1e-3,
                    warmup_num_steps=1000, warmup_type="log", **_) -> Schedule:
    """WarmupDecayLR: warmup then linear decay to 0 at total_num_steps."""
    base = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type)

    def schedule(step: int) -> float:
        if step < warmup_num_steps:
            return base(step)
        decay = (total_num_steps - float(step)) / max(
            total_num_steps - warmup_num_steps, 1)
        return warmup_max_lr * _clip(decay, 0.0, 1.0)

    return schedule


def warmup_cosine_lr(total_num_steps, warmup_min_ratio=0.0, warmup_num_steps=1000,
                     cos_min_ratio=0.0001, lr=1e-3, **_) -> Schedule:
    """WarmupCosineLR: linear warmup then cosine decay to cos_min_ratio*lr."""

    def schedule(step: int) -> float:
        s = float(step)
        if s < warmup_num_steps:
            return lr * (warmup_min_ratio + (1 - warmup_min_ratio) * min(
                s / max(warmup_num_steps, 1), 1.0))
        progress = _clip((s - warmup_num_steps)
                         / max(total_num_steps - warmup_num_steps, 1), 0.0, 1.0)
        return lr * (cos_min_ratio + (1 - cos_min_ratio) * 0.5
                     * (1 + math.cos(math.pi * progress)))

    return schedule


def one_cycle(cycle_min_lr, cycle_max_lr, cycle_first_step_size=2000,
              cycle_second_step_size=None, decay_step_size=0, decay_lr_rate=0.0,
              post_cycle_decay="linear", **_) -> Schedule:
    """OneCycle: triangular up/down then optional decay."""
    second = (cycle_second_step_size if cycle_second_step_size is not None
              else cycle_first_step_size)
    total_cycle = cycle_first_step_size + second

    def schedule(step: int) -> float:
        s = float(step)
        if decay_step_size > 0 and s > total_cycle:
            post = max(s - total_cycle, 0.0)
            return cycle_min_lr / (1.0 + decay_lr_rate * post / decay_step_size)
        if s < cycle_first_step_size:
            return cycle_min_lr + (cycle_max_lr - cycle_min_lr) * min(
                s / cycle_first_step_size, 1.0)
        return cycle_max_lr - (cycle_max_lr - cycle_min_lr) * _clip(
            (s - cycle_first_step_size) / max(second, 1), 0.0, 1.0)

    return schedule


def lr_range_test(lr_range_test_min_lr=1e-3, lr_range_test_step_size=2000,
                  lr_range_test_step_rate=1.0, lr_range_test_staircase=False,
                  **_) -> Schedule:
    """LRRangeTest: linearly (or staircase) increasing LR probe."""

    def schedule(step: int) -> float:
        interval = float(step) / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = math.floor(interval)
        return lr_range_test_min_lr * (1.0 + interval * lr_range_test_step_rate)

    return schedule


_SCHEDULES = {
    "warmuplr": warmup_lr,
    "warmupdecaylr": warmup_decay_lr,
    "warmupcosinelr": warmup_cosine_lr,
    "onecycle": one_cycle,
    "lrrangetest": lr_range_test,
}


def build_schedule(name: Optional[str], params: Dict[str, Any],
                   base_lr: float) -> Schedule:
    """Schedule factory; None → constant base_lr."""
    if not name:
        return lambda step: float(base_lr)
    key = name.lower().replace("_", "")
    if key not in _SCHEDULES:
        raise KeyError(f"unknown scheduler {name!r}; have {sorted(_SCHEDULES)}")
    params = dict(params)
    if key == "warmupcosinelr":
        params.setdefault("lr", base_lr)
    return _SCHEDULES[key](**params)
