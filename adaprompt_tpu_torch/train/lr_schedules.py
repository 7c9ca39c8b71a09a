"""Learning-rate schedules.

Port of `adaprompt_tpu/train/lr_schedules.py::prodigy_lr_schedule`: a
constant multiplier of 1 during the warm-up, then `scheduler_cycles`
linear decays (PolynomialLR with power 1 over 1.1 x the cycle), each from
1 to about 0.09. The schedule maps an optimizer step count to the
multiplier, computed in float32 as the JAX package computes it.
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
