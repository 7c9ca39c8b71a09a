"""DDIM sampler with classifier-free guidance, as a Python loop, and the
img2img pair `stochastic_encode` / `ddim_decode`.

Port of `adaprompt_tpu/sampling/ddim.py`: uniform timesteps [981, ..., 1]
for 50 steps (or an explicit grid), the (cond, uncond) batch order, the
guidance scale annealed linearly max -> min over the steps, and
x_prev = sqrt(a_prev) * pred_x0 + sqrt(1 - a_prev - sigma^2) * e_t
+ sigma * noise, with sigma = 0 at eta = 0. `ddim_sample`'s optional
inpainting blend re-noises `x0` to each step's timestep and pastes it where
`mask == 1`. The per-step coefficients are computed in float32 on the host,
as the JAX package computes them in float32 on the device.

Random draws: where the JAX loop takes one key a step (`jax.random.split`
of `noise_key`), the port draws one standard normal a step from a
`torch.Generator` (seeded 0 on x_T's device by default). As in JAX, that one
draw serves both the mask's re-noising and the eta noise of the step.
`noise=` injects the draws ([S, *x_T.shape]); at eta = 0 without a mask
nothing is drawn.

`ddim_sample_fast` is the eta = 0 update under the serving fast paths
(sampling/fastloop.py: DeepCache and the CFG tail).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from adaprompt_tpu_torch.sampling.fastloop import cfg_tail, fast_cached_loop
from adaprompt_tpu_torch.sampling.schedule import (DiffusionSchedule, SD15_SCHEDULE,
                                                   make_ddim_params, make_ddim_timesteps,
                                                   q_sample)

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
                sched: DiffusionSchedule = SD15_SCHEDULE,
                eta: float = 0.0,
                mask: torch.Tensor | None = None,
                x0: torch.Tensor | None = None,
                generator: torch.Generator | None = None,
                use_cfg: bool = True,
                timesteps: np.ndarray | None = None,
                noise: torch.Tensor | None = None) -> torch.Tensor:
    """Run the DDIM loop from x_T [B, H, W, C] (float32) to x_0 latents.

    model_fn sees the doubled (cond, uncond) batch at every step, or the
    plain batch when use_cfg is False. mask / x0: the inpainting blend, the
    region where mask == 1 taken from x0 re-noised to the step's timestep.
    generator: the per-step draws when eta > 0 or a mask is given; noise:
    those draws given instead, [S, *x_T.shape]. timesteps: an explicit
    ascending ddpm grid (its length is the step count)."""
    b = x_T.shape[0]
    ts, alphas, alphas_prev, sigmas = make_ddim_params(sched, num_steps, eta,
                                                       timesteps=timesteps)
    order = np.arange(len(ts))[::-1]
    a_t, a_prev, sig = alphas[order], alphas_prev[order], sigmas[order]
    c_eps = np.sqrt(np.float32(1.0) - a_t)
    c_x0 = np.sqrt(a_t)
    c_prev = np.sqrt(a_prev)
    c_dir = np.sqrt(np.float32(1.0) - a_prev - sig ** 2)
    g_t = guidance_schedule(len(ts), guidance_scale)
    draws = mask is not None or bool(sig.any())
    if draws and noise is None and generator is None:
        generator = torch.Generator(device=x_T.device).manual_seed(0)

    x = x_T
    for i, t in enumerate(ts[order]):
        tb = torch.full((b,), int(t), dtype=torch.int64, device=x.device)
        n = None
        if draws:
            n = noise[i].to(x) if noise is not None else torch.randn(
                x.shape, generator=generator, device=x.device, dtype=x.dtype)
        if mask is not None:
            img_orig = q_sample(sched, x0, tb, n)
            x = img_orig * mask + (1.0 - mask) * x
        if use_cfg:
            e_c, e_u = model_fn(torch.cat([x, x]), torch.cat([tb, tb])).chunk(2)
            e_t = e_u + float(g_t[i]) * (e_c - e_u)
        else:
            e_t = model_fn(x, tb)
        pred_x0 = (x - float(c_eps[i]) * e_t) / float(c_x0[i])
        x = float(c_prev[i]) * pred_x0 + float(c_dir[i]) * e_t
        if sig[i]:
            x = x + float(sig[i]) * n
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


def stochastic_encode(x0: torch.Tensor, ddim_step_index: int,
                      generator: torch.Generator | None = None, *, num_steps: int,
                      sched: DiffusionSchedule = SD15_SCHEDULE,
                      noise: torch.Tensor | None = None) -> torch.Tensor:
    """img2img entry: x0 noised up to DDIM step `ddim_step_index`,
    sqrt(a) * x0 + sqrt(1 - a) * noise with a the step's alpha. The
    standard-normal `noise` is drawn from `generator` (seeded 0 on x0's
    device by default) unless given."""
    _, alphas, _, _ = make_ddim_params(sched, num_steps)
    a = alphas[ddim_step_index]
    if noise is None:
        if generator is None:
            generator = torch.Generator(device=x0.device).manual_seed(0)
        noise = torch.randn(x0.shape, generator=generator, device=x0.device, dtype=x0.dtype)
    return float(np.sqrt(a)) * x0 + float(np.sqrt(np.float32(1.0) - a)) * noise.to(x0)


def ddim_decode(model_fn: EpsModel, x_latent: torch.Tensor, t_start: int, *,
                num_steps: int, guidance_scale=1.0,
                sched: DiffusionSchedule = SD15_SCHEDULE,
                use_cfg: bool = True) -> torch.Tensor:
    """img2img decode: the last `t_start` of `num_steps` DDIM steps from
    x_latent, at eta = 0, the guidance annealed over those `t_start` steps.
    `ddim_sample` over the first `t_start` timesteps of the grid: their
    alphas and previous alphas are the full grid's, so at t_start =
    num_steps this is `ddim_sample` itself."""
    return ddim_sample(model_fn, x_latent, num_steps=t_start, guidance_scale=guidance_scale,
                       sched=sched, use_cfg=use_cfg,
                       timesteps=make_ddim_timesteps(num_steps, sched.num_timesteps)[:t_start])
