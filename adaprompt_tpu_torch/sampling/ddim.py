"""DDIM sampler with classifier-free guidance, as a Python loop.

Port of `adaprompt_tpu/sampling/ddim.py::ddim_sample` at eta = 0, the
setting of every caller: uniform timesteps [981, ..., 1] for 50 steps, the
(cond, uncond) batch order, the guidance scale annealed linearly max -> min
over the steps, and x_prev = sqrt(a_prev) * pred_x0 + sqrt(1 - a_prev) * e_t.
The loop is deterministic and draws no noise. The per-step coefficients are
computed in float32 on the host, as the JAX package computes them in float32
on the device.

`ddim_sample_fast` is the same update under the serving fast paths
(sampling/fastloop.py: DeepCache and the CFG tail).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from adaprompt_tpu_torch.sampling.fastloop import cfg_tail, fast_cached_loop
from adaprompt_tpu_torch.sampling.schedule import (DiffusionSchedule, SD15_SCHEDULE,
                                                   make_ddim_params)

# eps-model: (x [2B,H,W,C], t [2B]) -> eps [2B,H,W,C]; cond first, uncond second
EpsModel = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def guidance_schedule(num_steps: int, guidance_scale) -> np.ndarray:
    """Per-step annealed CFG scales; a scalar g anneals g -> min(2, g)."""
    if isinstance(guidance_scale, (tuple, list)):
        gmax, gmin = float(guidance_scale[0]), float(guidance_scale[1])
    else:
        gmax = float(guidance_scale)
        gmin = min(2.0, gmax)
    delta = (gmax - gmin) / max(num_steps - 1, 1)
    return (gmax - delta * np.arange(num_steps)).astype(np.float32)


def ddim_sample(model_fn: EpsModel, x_T: torch.Tensor, *,
                num_steps: int = 50,
                guidance_scale=(4.0, 1.0),
                sched: DiffusionSchedule = SD15_SCHEDULE) -> torch.Tensor:
    """Run the DDIM loop from x_T [B, H, W, C] (float32) to x_0 latents;
    `model_fn` sees the doubled (cond, uncond) batch at every step."""
    b = x_T.shape[0]
    ts, alphas, alphas_prev, _ = make_ddim_params(sched, num_steps)
    order = np.arange(len(ts))[::-1]
    a_t, a_prev = alphas[order], alphas_prev[order]
    c_eps = np.sqrt(np.float32(1.0) - a_t)
    c_x0 = np.sqrt(a_t)
    c_prev = np.sqrt(a_prev)
    c_dir = np.sqrt(np.float32(1.0) - a_prev)
    g_t = guidance_schedule(len(ts), guidance_scale)

    x = x_T
    for i, t in enumerate(ts[order]):
        tb = torch.full((b,), int(t), dtype=torch.int64, device=x.device)
        e_c, e_u = model_fn(torch.cat([x, x]), torch.cat([tb, tb])).chunk(2)
        e_t = e_u + float(g_t[i]) * (e_c - e_u)
        pred_x0 = (x - float(c_eps[i]) * e_t) / float(c_x0[i])
        x = float(c_prev[i]) * pred_x0 + float(c_dir[i]) * e_t
    return x


def ddim_sample_fast(model_full, model_shallow, x_T: torch.Tensor, *,
                     num_steps: int = 50,
                     guidance_scale=(4.0, 1.0),
                     sched: DiffusionSchedule = SD15_SCHEDULE,
                     cache_interval: int = 1,
                     cfg_tail_frac: float = 0.0) -> torch.Tensor:
    """DDIM (eta = 0) under the serving fast paths: DeepCache (a full UNet
    pass every `cache_interval` steps, shallow passes from the cached deep
    feature between them) and CFG-tail truncation (the last
    `cfg_tail_frac` of the steps run condition-only, their guidance scale
    pinned to exactly 1). Approximations of `ddim_sample`, opt-in only.

    model_full: (x_in, t_in) -> (eps, deep_cache) on the doubled or the
    plain batch (cond first); model_shallow: (x_in, t_in, deep_cache) -> eps."""
    ts, alphas, alphas_prev, _ = make_ddim_params(sched, num_steps)
    order = np.arange(num_steps)[::-1]
    g_all, n_cfg = cfg_tail(guidance_schedule(num_steps, guidance_scale), cfg_tail_frac)
    a_t, a_prev = alphas[order], alphas_prev[order]
    arrs = (ts[order], g_all, np.sqrt(np.float32(1.0) - a_t), np.sqrt(a_t), np.sqrt(a_prev),
            np.sqrt(np.float32(1.0) - a_prev))

    def update(carry, e_t, ps):
        (x,) = carry
        _, _, c_eps, c_x0, c_prev, c_dir = (float(v) for v in ps)
        pred_x0 = (x - c_eps * e_t) / c_x0
        return (c_prev * pred_x0 + c_dir * e_t,)

    (x,) = fast_cached_loop(model_full, model_shallow, (x_T,), arrs, update,
                            cache_interval=cache_interval, n_cfg=n_cfg)
    return x
