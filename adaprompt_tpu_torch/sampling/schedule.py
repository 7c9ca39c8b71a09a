"""Diffusion noise schedule and DDIM parameters (host-side numpy).

Port of `adaprompt_tpu/sampling/schedule.py`: the schedule, the DDIM
parameters, and the forward-process math of training (`q_sample`,
`predict_start_from_noise`). SD-1.5: "scaled linear" betas,
linear_start=0.00085, linear_end=0.012, T=1000. The per-timestep
coefficients are computed in float64 on the host and kept in float32, as the
JAX package keeps them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def make_betas(num_timesteps: int = 1000, linear_start: float = 0.00085,
               linear_end: float = 0.012) -> np.ndarray:
    """'linear' schedule in LDM terms: linspace in sqrt-beta space, squared."""
    return np.linspace(linear_start ** 0.5, linear_end ** 0.5, num_timesteps,
                       dtype=np.float64) ** 2


@dataclasses.dataclass(frozen=True, eq=False)
class DiffusionSchedule:
    betas: np.ndarray
    alphas_cumprod: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return len(self.betas)

    @classmethod
    def create(cls, num_timesteps: int = 1000, linear_start: float = 0.00085,
               linear_end: float = 0.012) -> "DiffusionSchedule":
        betas = make_betas(num_timesteps, linear_start, linear_end)
        acp = np.cumprod(1.0 - betas)
        f32 = lambda a: a.astype(np.float32)
        return cls(betas=f32(betas), alphas_cumprod=f32(acp),
                   sqrt_alphas_cumprod=f32(np.sqrt(acp)),
                   sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - acp)),
                   sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
                   sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1.0)))


SD15_SCHEDULE = DiffusionSchedule.create()


def _gather(arr: np.ndarray, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """arr[t] broadcast to an image batch: t [B] -> [B, 1, 1, 1] float32."""
    g = torch.as_tensor(arr, device=t.device)[t.long()]
    return g.reshape(g.shape + (1,) * (ndim - 1))


def q_sample(sched: DiffusionSchedule, x_start: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward diffusion x_t = sqrt(acp_t) x0 + sqrt(1 - acp_t) eps."""
    return (_gather(sched.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
            + _gather(sched.sqrt_one_minus_alphas_cumprod, t, x_start.ndim) * noise)


def predict_start_from_noise(sched: DiffusionSchedule, x_t: torch.Tensor,
                             t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """x0_hat = sqrt(1/acp_t) x_t - sqrt(1/acp_t - 1) eps."""
    return (_gather(sched.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
            - _gather(sched.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * noise)


def make_ddim_timesteps(num_ddim_steps: int, num_ddpm_timesteps: int = 1000) -> np.ndarray:
    """Uniform DDIM discretization, +1 offset: [1, 21, ..., 981] for 50 steps."""
    c = num_ddpm_timesteps // num_ddim_steps
    return (np.arange(0, num_ddim_steps) * c + 1).astype(np.int64)


def make_ddim_params(sched: DiffusionSchedule, num_ddim_steps: int):
    """(timesteps, alphas, alphas_prev) of the eta = 0 DDIM sampler,
    ascending in time; alphas in float32."""
    ts = make_ddim_timesteps(num_ddim_steps, sched.num_timesteps)
    acp = sched.alphas_cumprod
    alphas_prev = np.concatenate([[acp[0]], acp[ts[:-1]]])
    return ts, acp[ts].astype(np.float32), alphas_prev.astype(np.float32)
