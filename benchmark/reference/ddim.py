"""DDIM (eta 0) with classifier-free guidance over SD-1.5's schedule, plain.

The schedule of `v1-inference.yaml`: 1,000 steps, betas linear in sqrt space
from 0.00085 to 0.012. DDIM's uniform grid with LDM's +1 offset (1, 21, ...,
981 for 50 steps), alphas_prev = [acp_0] + acp of the previous grid point.
The guidance scale is annealed linearly from g to min(2, g) over the steps
(AdaFace's pipeline); eps = eps_u + g (eps_c - eps_u) over a (cond, uncond)
batch.
"""

from __future__ import annotations

import numpy as np
import torch


def coefficients(num_steps: int, guidance: float):
    """Per step of the sampling order (high t first): (t, c_eps, c_x0, c_prev,
    c_dir, g), each a float64 array."""
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000, dtype=np.float64) ** 2
    acp = np.cumprod(1.0 - betas)
    ts = np.arange(num_steps) * (1000 // num_steps) + 1
    a_t = acp[ts]
    a_prev = np.concatenate([[acp[0]], acp[ts[:-1]]])
    gmin = min(2.0, guidance)
    g = guidance - (guidance - gmin) / max(num_steps - 1, 1) * np.arange(num_steps)
    rev = slice(None, None, -1)
    return (ts[rev], np.sqrt(1.0 - a_t)[rev], np.sqrt(a_t)[rev], np.sqrt(a_prev)[rev],
            np.sqrt(1.0 - a_prev)[rev], g)


def step(x: torch.Tensor, eps2: torch.Tensor, i: int, coef) -> torch.Tensor:
    """One DDIM update of x [B, ...] from the (cond, uncond) eps [2B, ...] of step i."""
    _, c_eps, c_x0, c_prev, c_dir, g = coef
    e_c, e_u = eps2.chunk(2)
    e = e_u + float(g[i]) * (e_c - e_u)
    x0 = (x - float(c_eps[i]) * e) / float(c_x0[i])
    return float(c_prev[i]) * x0 + float(c_dir[i]) * e
