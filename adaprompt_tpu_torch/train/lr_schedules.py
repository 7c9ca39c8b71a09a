"""Learning-rate schedules.

Port of `adaprompt_tpu/train/lr_schedules.py`. Each schedule maps an
optimizer step count to a multiplier, computed in float32 as the JAX
package computes it:
  * prodigy_lr_schedule: a constant 1 during the warm-up, then
    `scheduler_cycles` linear decays (PolynomialLR with power 1 over 1.1 x
    the cycle), each from 1 to about 0.09 (the Prodigy path);
  * lambda_warmup_cosine_schedule: a linear warm-up from lr_start to
    lr_max, then a cosine decay to lr_min over max_decay_steps (the AdamW
    path); lambda_linear_schedule the same with a linear decay.
"""

from __future__ import annotations

import numpy as np


def prodigy_lr_schedule(max_steps: int, warm_up_steps: int = 500, scheduler_cycles: int = 1):
    total_cycle_steps = max_steps - warm_up_steps
    single = total_cycle_steps / scheduler_cycles
    last = total_cycle_steps - single * (scheduler_cycles - 1)
    boundaries = [warm_up_steps]
    for _ in range(scheduler_cycles - 1):
        boundaries.append(boundaries[-1] + single)
    boundaries = np.asarray(boundaries, np.float32)
    f32 = np.float32

    def schedule(step) -> np.float32:
        step = f32(step)
        lr = f32(1.0)
        for ci in range(scheduler_cycles):
            start = boundaries[ci]
            cycle_steps = last if ci == scheduler_cycles - 1 else single
            mult = np.clip(f32(1.0) - (step - start) / f32(1.1 * cycle_steps), f32(0.0), f32(1.0))
            in_cycle = step >= start and (ci == scheduler_cycles - 1
                                          or step < start + f32(cycle_steps))
            if in_cycle:
                lr = f32(mult)
        return lr

    return schedule


def _warm_and_t(step, warm_up_steps, lr_start, lr_max, max_decay_steps):
    """(float32 step, the warm-up's value, the decay's progress in [0, 1])."""
    f32 = np.float32
    step = f32(step)
    warm = f32(lr_start) + f32((lr_max - lr_start) / max(warm_up_steps, 1)) * step
    t = (step - f32(warm_up_steps)) / f32(max(max_decay_steps - warm_up_steps, 1))
    return step, warm, np.clip(t, f32(0.0), f32(1.0))


def _cos(x: np.float32) -> np.float32:
    """float32 cosine rounded from float64 (numpy's float32 cosine is off by
    an ulp where XLA's is not)."""
    return np.float32(np.cos(np.float64(x)))


def lambda_warmup_cosine_schedule(warm_up_steps: int, lr_start: float, lr_max: float,
                                  lr_min: float, max_decay_steps: int):
    """Linear warm-up lr_start -> lr_max, then cosine decay lr_max -> lr_min."""
    f32 = np.float32

    def schedule(step) -> np.float32:
        step, warm, t = _warm_and_t(step, warm_up_steps, lr_start, lr_max, max_decay_steps)
        cos = f32(lr_min) + f32(0.5 * (lr_max - lr_min)) * (f32(1.0) + _cos(t * f32(np.pi)))
        return f32(warm if step < f32(warm_up_steps) else cos)

    return schedule


def lambda_linear_schedule(warm_up_steps: int, lr_start: float, lr_max: float, lr_min: float,
                           max_decay_steps: int):
    """Linear warm-up lr_start -> lr_max, then linear decay lr_max -> lr_min."""
    f32 = np.float32

    def schedule(step) -> np.float32:
        step, warm, t = _warm_and_t(step, warm_up_steps, lr_start, lr_max, max_decay_steps)
        lin = f32(lr_max) + t * f32(lr_min - lr_max)
        return f32(warm if step < f32(warm_up_steps) else lin)

    return schedule
