"""Gradient scaling: identity forward, scaled backward.

Port of `adaprompt_tpu/adaface/gradient.py`: alpha = 1 is the identity,
alpha = 0 detaches, any other alpha multiplies the incoming gradient.
"""

from __future__ import annotations

import torch


class _GradScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        ctx.alpha = alpha
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.alpha, None


def grad_scale(x: torch.Tensor, alpha: float) -> torch.Tensor:
    if alpha == 1.0:
        return x
    if alpha == 0.0:
        return x.detach()
    return _GradScale.apply(x, alpha)
