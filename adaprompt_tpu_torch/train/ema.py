"""Exponential moving average of the trainable parameters.

Port of `adaprompt_tpu/train/ema.py` (LitEma's rule): `num_updates` is
incremented before the decay is taken, decay_t = min(decay, (1 + n) /
(10 + n)), and shadow <- shadow - (1 - decay_t) * (shadow - param). With
`use_num_updates=False` the count stays -1 and the decay is fixed. The
shadow is a float32 copy of every trainable tensor, keyed by its qualified
name (`steps.named_trainable`); the decay is computed in float32 on the
host, as the JAX package computes it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from adaprompt_tpu_torch.train.steps import named_trainable


@dataclasses.dataclass
class EmaState:
    shadow: dict          # {qualified name: float32 tensor}
    num_updates: int      # -1: the fixed-decay form


def ema_init(params: dict, use_num_updates: bool = True) -> EmaState:
    return EmaState({n: p.detach().float().clone() for n, p in named_trainable(params)},
                    0 if use_num_updates else -1)


def ema_decay_at(num_updates: int, decay: float) -> np.float32:
    """The decay LitEma applies at an (already incremented) update count."""
    f32 = np.float32
    if num_updates < 0:
        return f32(decay)
    return min(f32(decay), (f32(1.0) + f32(num_updates)) / (f32(10.0) + f32(num_updates)))


@torch.no_grad()
def ema_update(state: EmaState, params: dict, decay: float = 0.9999) -> EmaState:
    n = state.num_updates + 1 if state.num_updates >= 0 else state.num_updates
    one_minus = float(np.float32(1.0) - ema_decay_at(n, decay))
    for name, p in named_trainable(params):
        s = state.shadow[name]
        s.sub_((s - p.detach().to(s.dtype)) * one_minus)
    state.num_updates = n
    return state


def ema_copy_to(state: EmaState) -> dict:
    """The shadow parameters (copy_to's values)."""
    return state.shadow
