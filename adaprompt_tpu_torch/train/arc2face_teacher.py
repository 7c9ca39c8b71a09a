"""The Arc2Face teacher's denoising chain: the distillation targets.

Port of `adaprompt_tpu/train/arc2face_teacher.py`. From (x_start, noise, t)
it repeats `num_denoising_steps` (ND) times:

    x_noisy  = q_sample(x_start, t, noise)
    eps      = teacher_unet(x_noisy, t, context)        # context [B, 21, 768]
    x_start  = predict_start_from_noise(x_noisy, t, eps)
    next t   ~ U(t * 0.5^a, t * 0.7^a), a = (ND - 1)^-0.3; next noise ~ N(0, 1)

and returns (noise_preds, pred_x0s, noises, ts), lists of length ND. The
teacher is frozen: everything runs under `torch.no_grad()`. The random draws
are inputs (`rels` [ND-1, B] uniform, `next_noises` [ND-1, B, h, w, 4]
normal), so that a test can hand it the draws the JAX package made.
"""

from __future__ import annotations

import numpy as np
import torch

from adaprompt_tpu_torch.sampling.schedule import (SD15_SCHEDULE, DiffusionSchedule,
                                                   predict_start_from_noise, q_sample)


@torch.no_grad()
def teacher_denoise_chain(teacher, x_start: torch.Tensor, noise: torch.Tensor, t: torch.Tensor,
                          context: torch.Tensor, rels: torch.Tensor, next_noises: torch.Tensor,
                          *, num_denoising_steps: int = 1,
                          sched: DiffusionSchedule = SD15_SCHEDULE,
                          compute_dtype=torch.bfloat16):
    """x_start/noise [B, h, w, 4] float32 NHWC; t [B] int; context [B, S, D]."""
    nd = num_denoising_steps
    if nd > 10:
        raise ValueError("at most 10 denoising steps")
    x_starts, noises, ts, noise_preds = [x_start], [noise], [t], []
    for i in range(nd):
        x_i, t_i, n_i = x_starts[i], ts[i], noises[i]
        x_noisy = q_sample(sched, x_i, t_i, n_i)
        eps = teacher(x_noisy.to(compute_dtype), t_i, context.to(compute_dtype)).float()
        noise_preds.append(eps)
        pred_x0 = predict_start_from_noise(sched, x_noisy, t_i, eps)
        x_starts.append(pred_x0)
        if i < nd - 1:
            a = np.power(nd - 1, -0.3)
            t_lb = t_i.float() * float(np.power(0.5, a))
            t_ub = t_i.float() * float(np.power(0.7, a))
            ts.append(((t_ub - t_lb) * rels[i] + t_lb).to(torch.int32))
            noises.append(next_noises[i])
    return noise_preds, x_starts[1:], noises, ts
