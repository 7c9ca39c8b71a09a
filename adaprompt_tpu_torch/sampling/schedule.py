"""Diffusion noise schedule and DDIM parameters (host-side numpy).

Port of `adaprompt_tpu/sampling/schedule.py` (the parts the DDIM sampler
uses). SD-1.5: "scaled linear" betas, linear_start=0.00085,
linear_end=0.012, T=1000.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def make_betas(num_timesteps: int = 1000, linear_start: float = 0.00085,
               linear_end: float = 0.012) -> np.ndarray:
    """'linear' schedule in LDM terms: linspace in sqrt-beta space, squared."""
    return np.linspace(linear_start ** 0.5, linear_end ** 0.5, num_timesteps,
                       dtype=np.float64) ** 2


@dataclasses.dataclass(frozen=True, eq=False)
class DiffusionSchedule:
    betas: np.ndarray
    alphas_cumprod: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return len(self.betas)

    @classmethod
    def create(cls, num_timesteps: int = 1000, linear_start: float = 0.00085,
               linear_end: float = 0.012) -> "DiffusionSchedule":
        betas = make_betas(num_timesteps, linear_start, linear_end)
        acp = np.cumprod(1.0 - betas)
        return cls(betas=betas.astype(np.float32), alphas_cumprod=acp.astype(np.float32))


SD15_SCHEDULE = DiffusionSchedule.create()


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
