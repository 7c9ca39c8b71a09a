"""DPM-Solver++(2M) with classifier-free guidance, as a Python loop.

Port of `adaprompt_tpu/sampling/dpm.py` (Lu et al., arXiv:2211.01095, the
data-prediction multistep variant): the probability-flow ODE that DDIM
integrates, on the same uniform DDIM grid with the final boundary
alpha_bar[0], so ~20 steps match DDIM-50. With alpha = sqrt(alpha_bar),
sigma = sqrt(1 - alpha_bar), lambda = log(alpha / sigma) and
h = lambda_t - lambda_s, a step is
    x_t = (sigma_t / sigma_s) x_s - alpha_t (e^{-h} - 1) X0,
X0 = (1 + 1/(2r)) x0_i - 1/(2r) x0_{i-1} with r = h_prev / h. The first step
(no history; h_prev = 1, x0_prev = 0) runs first order, which equals a
deterministic DDIM step; the last step runs first order only when
num_steps < 15 (lower_order_final). The per-step coefficients are float32
on the host, as the JAX package keeps them in float32 on the device.

`dpmpp_sample_fast` is the same solver under the serving fast paths
(sampling/fastloop.py); with cache_interval=1 and cfg_tail_frac=0 it equals
`dpmpp_sample`. Its 2M history carries whatever the previous step's eps
was: a shallow-pass eps on cached steps, a cond-only eps in the CFG tail.
"""

from __future__ import annotations

import numpy as np
import torch

from adaprompt_tpu_torch.sampling.ddim import EpsModel, guidance_schedule
from adaprompt_tpu_torch.sampling.fastloop import cfg_tail, fast_cached_loop
from adaprompt_tpu_torch.sampling.schedule import (DiffusionSchedule, SD15_SCHEDULE,
                                                   make_ddim_params)

_F32 = np.float32


def _solver_arrays(sched, num_steps, timesteps=None):
    """Per step in denoise order: ddpm timesteps, then float32 alpha_s,
    sigma_s, alpha_t, sigma_t and h."""
    ts, alphas, alphas_prev, _ = make_ddim_params(sched, num_steps, timesteps=timesteps)
    order = np.arange(len(ts))[::-1]
    ts, alphas, alphas_prev = ts[order], alphas[order], alphas_prev[order]
    a_s, s_s = np.sqrt(alphas), np.sqrt(1.0 - alphas)
    a_t, s_t = np.sqrt(alphas_prev), np.sqrt(1.0 - alphas_prev)
    h = (np.log(a_t / s_t) - np.log(a_s / s_s)).astype(_F32)
    f32 = lambda a: a.astype(_F32)
    return ts, f32(a_s), f32(s_s), f32(a_t), f32(s_t), h


def _step(x, x0_prev, h_prev, e_t, as_, ss_, at_, st_, hi, lower):
    """One DPM-Solver++(2M) update; returns (x_next, x0, h). The scalars are
    float32 and combined in the JAX package's order."""
    x0 = (x - float(ss_) * e_t) / float(as_)
    if lower:
        x0_hat = x0
    else:
        r = _F32(h_prev) / hi
        c = _F32(1.0) / (_F32(2.0) * r)
        x0_hat = float(_F32(1.0) + c) * x0 - float(c) * x0_prev
    x_next = float(st_ / ss_) * x - float(at_ * (np.exp(-hi) - _F32(1.0))) * x0_hat
    return x_next, x0, hi


def dpmpp_sample(model_fn: EpsModel, x_T: torch.Tensor, *,
                 num_steps: int = 20,
                 guidance_scale=(4.0, 1.0),
                 sched: DiffusionSchedule = SD15_SCHEDULE,
                 use_cfg: bool = True,
                 solver_order: int = 2,
                 timesteps: np.ndarray | None = None) -> torch.Tensor:
    """Run the DPM-Solver++(2M) loop from x_T [B, H, W, C] (float32).
    `model_fn` sees the doubled (cond, uncond) batch, or the plain batch
    when use_cfg is False. solver_order=1 is pure first order, equal to
    deterministic DDIM step for step. timesteps: an explicit ascending ddpm
    grid (schedule.make_ddim_params)."""
    if solver_order not in (1, 2):
        raise ValueError(f"solver_order must be 1 or 2, got {solver_order}")
    b = x_T.shape[0]
    ts, a_s, s_s, a_t, s_t, h = _solver_arrays(sched, num_steps, timesteps)
    n = len(ts)
    g_t = guidance_schedule(n, guidance_scale)
    x, x0_prev, h_prev = x_T, torch.zeros_like(x_T), _F32(1.0)
    for i in range(n):
        tb = torch.full((b,), int(ts[i]), dtype=torch.int64, device=x.device)
        if use_cfg:
            e_c, e_u = model_fn(torch.cat([x, x]), torch.cat([tb, tb])).chunk(2)
            e_t = e_u + float(g_t[i]) * (e_c - e_u)
        else:
            e_t = model_fn(x, tb)
        lower = solver_order == 1 or i == 0 or (n < 15 and i == n - 1)
        x, x0_prev, h_prev = _step(x, x0_prev, h_prev, e_t, a_s[i], s_s[i], a_t[i], s_t[i],
                                   h[i], lower)
    return x


def dpmpp_sample_fast(model_full, model_shallow, x_T: torch.Tensor, *,
                      num_steps: int = 20,
                      guidance_scale=(4.0, 1.0),
                      sched: DiffusionSchedule = SD15_SCHEDULE,
                      cache_interval: int = 1,
                      cfg_tail_frac: float = 0.0) -> torch.Tensor:
    """DPM-Solver++(2M) under DeepCache and the CFG tail (the composed
    serving stack; approximate, opt-in). Same model contract as
    ddim.ddim_sample_fast."""
    ts, a_s, s_s, a_t, s_t, h = _solver_arrays(sched, num_steps)
    n = len(ts)
    g_all, n_cfg = cfg_tail(guidance_schedule(n, guidance_scale), cfg_tail_frac)
    lower = np.zeros(n, bool)
    lower[0] = True
    if n < 15:
        lower[-1] = True
    arrs = (ts, g_all, a_s, s_s, a_t, s_t, h, lower)

    def update(carry, e_t, ps):
        x, x0_prev, h_prev = carry
        return _step(x, x0_prev, h_prev, e_t, *ps[2:])

    x, _, _ = fast_cached_loop(model_full, model_shallow, (x_T, torch.zeros_like(x_T), _F32(1.0)),
                               arrs, update, cache_interval=cache_interval, n_cfg=n_cfg)
    return x
