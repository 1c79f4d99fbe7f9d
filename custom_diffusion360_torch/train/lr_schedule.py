"""Learning-rate multiplier schedules (port of custom_diffusion360_tpu/
train/lr_schedule.py; the reference's sgm/lr_scheduler.py
LambdaWarmUpCosineScheduler(2) and LambdaLinearScheduler). Each returns a
plain function of the step (the count of applied optimizer updates) to a
multiplier of the base learning rate (``TrainConfig.lr_schedule``).
"""
from __future__ import annotations

import bisect
import math
from typing import Sequence


def lambda_warmup_cosine(warm_up_steps: int, lr_min: float, lr_max: float, lr_start: float,
                         max_decay_steps: int):
    """Linear warm-up from lr_start to lr_max, then a cosine down to lr_min
    at max_decay_steps, constant after."""

    def schedule(step):
        step = float(step)
        if step < warm_up_steps:
            return lr_start + step / max(warm_up_steps, 1) * (lr_max - lr_start)
        t = min((step - warm_up_steps) / max(max_decay_steps - warm_up_steps, 1), 1.0)
        return lr_min + 0.5 * (lr_max - lr_min) * (1 + math.cos(t * math.pi))

    return schedule


def _cycles(cycle_lengths):
    cum = [0]
    for c in cycle_lengths:
        cum.append(cum[-1] + c)
    return cum


def _cycle_schedule(step, cum, fn):
    """fn(step within its cycle, cycle); the last cycle runs on forever."""
    step = float(step)
    cycle = min(max(bisect.bisect_right(cum[1:], step), 0), len(cum) - 2)
    return fn(step - cum[cycle], cycle)


def lambda_warmup_cosine2(warm_up_steps: Sequence[int], f_min: Sequence[float],
                          f_max: Sequence[float], f_start: Sequence[float],
                          cycle_lengths: Sequence[int]):
    """Repeated warm-up + cosine cycles."""
    cum = _cycles(cycle_lengths)

    def fn(n, c):
        if n < warm_up_steps[c]:
            return f_start[c] + n / max(warm_up_steps[c], 1) * (f_max[c] - f_start[c])
        t = min((n - warm_up_steps[c]) / max(cycle_lengths[c] - warm_up_steps[c], 1), 1.0)
        return f_min[c] + 0.5 * (f_max[c] - f_min[c]) * (1 + math.cos(t * math.pi))

    return lambda step: _cycle_schedule(step, cum, fn)


def lambda_linear(warm_up_steps: Sequence[int], f_min: Sequence[float],
                  f_max: Sequence[float], f_start: Sequence[float],
                  cycle_lengths: Sequence[int]):
    """Repeated warm-up + linear decay cycles."""
    cum = _cycles(cycle_lengths)

    def fn(n, c):
        if n < warm_up_steps[c]:
            return f_start[c] + n / max(warm_up_steps[c], 1) * (f_max[c] - f_start[c])
        return f_min[c] + (f_max[c] - f_min[c]) * (cycle_lengths[c] - n) / cycle_lengths[c]

    return lambda step: _cycle_schedule(step, cum, fn)
