"""Prodigy (D-adapted Adam), AdamW, and the gradient pipeline of training.

Port of `adaprompt_tpu/train/prodigy.py::prodigy` with optax's semantics,
as a `torch.optim.Optimizer`:
  * one global D estimate, d_hat = d_coef * d_numerator / d_denom, with
    d_numerator = EMA_beta3 of (d/d0)*dlr*<g, p0 - p> and
    d_denom = sum |s|, s = EMA_beta3 of (d/d0)*dlr*g ((d/d0)*d*g under
    safeguard_warmup); d jumps to d_hat while it still equals d0, then
    grows at most by `growth_rate` and never past the running max of d_hat;
  * Adam moments scaled by d: m <- b1 m + d(1-b1) g, v <- b2 v + d^2(1-b2) g^2;
  * p <- p - dlr * m / (sqrt(v) + d_new*eps), dlr = d * lr * bias correction
    from the pre-update d, plus decoupled weight decay;
  * no progress (d_denom = 0, e.g. all gradients zero): D, its max and the
    numerator stay, and no parameter moves.
`lr` is a float or a schedule (step count -> multiplier). Every scalar is a
float32 tensor on the parameters' device, so a step never waits on the host.
A parameter without a gradient counts as a zero gradient, as in a JAX tree.

`AdamW` is `optax.adamw(lr, b1, b2, eps, eps_root=0, weight_decay)` written
out: m <- (1-b1) g + b1 m, v <- (1-b2) g^2 + b2 v, the count incremented,
u = m_hat / (sqrt(v_hat) + eps) with m_hat = m / (1 - b1^count) (v alike),
u + weight_decay * p, then p <- p - lr(k) u with k the updates before this
one; the decay applies to every parameter.

`GradientPipeline` is the trainer's optax chain: `clip_by_global_norm` ->
Prodigy or AdamW, behind `MultiSteps(every_k)`, which averages k
micro-batch gradients (optax's running mean, acc + (g - acc)/(n + 1)) and
steps the inner optimizer on every k-th call.

The sums over all parameters (Prodigy's <g, p0 - p> and sum |s|, the clip's
norm) go through the inner optimizer's `param_sum(params, values)`: a plain
sum, or over a device mesh `parallel/mesh.py`'s, which adds up the shards of
the sharded parameters.
"""

from __future__ import annotations

import math
from typing import Callable, Union

import numpy as np
import torch


def plain_sum(params, values):
    """The sum of one value a parameter."""
    return sum(values)


class Prodigy(torch.optim.Optimizer):
    # the state outside the per-parameter slots, besides the update count
    SCALARS = ("d", "d_max", "d_numerator")

    def __init__(self, params, lr: Union[float, Callable] = 1.0, betas=(0.9, 0.999),
                 beta3: float | None = None, eps: float = 1e-8, weight_decay: float = 0.0,
                 use_bias_correction: bool = False, safeguard_warmup: bool = False,
                 d0: float = 1e-6, d_coef: float = 1.0, growth_rate: float = float("inf")):
        super().__init__(params, dict(betas=betas, eps=eps, weight_decay=weight_decay))
        self.lr = lr
        self.beta3 = math.sqrt(betas[1]) if beta3 is None else beta3
        self.use_bias_correction = use_bias_correction
        self.safeguard_warmup = safeguard_warmup
        self.d0, self.d_coef, self.growth_rate = d0, d_coef, growth_rate
        self.param_sum = plain_sum
        params = self.params()
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=params[0].device)
        self.d, self.d_max, self.d_numerator = f32(d0), f32(d0), f32(0.0)
        self.count = 0
        for p in params:
            self.state[p] = {"exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p),
                             "s": torch.zeros_like(p), "p0": p.detach().clone()}

    def params(self) -> list:
        return [p for group in self.param_groups for p in group["params"]]

    def _lr_at(self, count) -> np.float32:
        return np.float32(self.lr(count) if callable(self.lr) else self.lr)

    @torch.no_grad()
    def step(self, closure=None):
        group = self.param_groups[0]
        beta1, beta2 = group["betas"]
        eps, weight_decay = group["eps"], group["weight_decay"]
        beta3, d0, f32 = self.beta3, self.d0, np.float32
        k = self.count
        if self.use_bias_correction:
            n = f32(k + 1)
            bc = np.sqrt(f32(1.0) - f32(beta2) ** n) / (f32(1.0) - f32(beta1) ** n)
        else:
            bc = f32(1.0)
        d = self.d
        dlr = d * float(self._lr_at(k)) * float(bc)
        params = self.params()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]

        dot_sum = self.param_sum(params, [
            torch.vdot(g.float().flatten(), (self.state[p]["p0"] - p).float().flatten())
            for p, g in zip(params, grads)])
        d_numerator = self.d_numerator * beta3 + (d / d0) * dlr * dot_sum
        s_coef = (d / d0) * (d if self.safeguard_warmup else dlr)
        s_sums = []
        for p, g in zip(params, grads):
            st = self.state[p]
            st["exp_avg"].mul_(beta1).add_(g * (d * (1 - beta1)))
            st["exp_avg_sq"].mul_(beta2).add_(g * g * (d * d * (1 - beta2)))
            st["s"].mul_(beta3).add_(g * s_coef)
            s_sums.append(st["s"].float().abs().sum())
        d_denom = self.param_sum(params, s_sums)

        d_hat = self.d_coef * d_numerator / torch.where(d_denom > 0, d_denom, 1.0)
        d_new = torch.where(d == d0, torch.maximum(d, d_hat), d)
        d_max = torch.maximum(self.d_max, d_hat)
        d_new = torch.minimum(d_max, d_new * min(self.growth_rate, 1e30))
        progressed = d_denom > 0
        d_new = torch.where(progressed, d_new, d)
        self.d_max = torch.where(progressed, d_max, self.d_max)
        self.d_numerator = torch.where(progressed, d_numerator, self.d_numerator)

        for p in params:
            st = self.state[p]
            denom = st["exp_avg_sq"].float().sqrt() + d_new * eps
            upd = -dlr * st["exp_avg"].float() / denom
            if weight_decay > 0:
                upd = upd - weight_decay * dlr * p.float()
            p.add_(torch.where(progressed, upd, 0.0).to(p.dtype))
        self.d = d_new
        self.count = k + 1


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root, as XLA and numpy take it: through
    float64 (torch's vectorized float32 sqrt on the CPU is up to an ulp off
    it, which Adam's first step, ~lr * sign(g), turns into a visible move
    where a weight is near lr)."""
    return x.double().sqrt().to(x.dtype)


class AdamW(torch.optim.Optimizer):
    """optax.adamw's update; `lr` is a float or a schedule (update count ->
    learning rate). Moments in the parameters' dtype, scalars in float32."""
    SCALARS = ()

    def __init__(self, params, lr: Union[float, Callable] = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 1e-4):
        super().__init__(params, dict(betas=betas, eps=eps, weight_decay=weight_decay))
        self.lr = lr
        self.count = 0
        self.param_sum = plain_sum
        for p in self.params():
            self.state[p] = {"exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}

    def params(self) -> list:
        return [p for group in self.param_groups for p in group["params"]]

    @torch.no_grad()
    def step(self, closure=None):
        group = self.param_groups[0]
        (b1, b2), eps, wd = group["betas"], group["eps"], group["weight_decay"]
        f32 = np.float32
        k = self.count
        n = f32(k + 1)
        bc1, bc2 = f32(1.0) - f32(b1) ** n, f32(1.0) - f32(b2) ** n
        lr = f32(self.lr(k) if callable(self.lr) else self.lr)
        for p in self.params():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            st = self.state[p]
            m = st["exp_avg"].mul_(b1).add_(g * (1 - b1))
            v = st["exp_avg_sq"].mul_(b2).add_(g * g * (1 - b2))
            upd = (m / float(bc1)) / (_sqrt(v / float(bc2)) + eps) + wd * p
            p.add_(upd * float(-lr))
        self.count = k + 1


class GradientPipeline:
    """clip_by_global_norm(max_norm) -> `inner`, behind MultiSteps(every_k)."""

    def __init__(self, inner: Prodigy | AdamW, max_norm: float, every_k: int = 1):
        self.inner, self.max_norm, self.every_k = inner, max_norm, every_k
        self.params = inner.params()
        self.acc = [torch.zeros_like(p) for p in self.params]
        self.mini_step = 0

    @torch.no_grad()
    def step(self) -> bool:
        """Fold the parameters' .grad into the running mean; on the k-th call
        clip it, step the inner optimizer and reset. Returns whether the
        parameters moved."""
        n = self.mini_step
        for acc, p in zip(self.acc, self.params):
            if p.grad is not None:
                acc.add_((p.grad - acc) / (n + 1))
            else:
                acc.sub_(acc / (n + 1))
        if n < self.every_k - 1:
            self.mini_step = n + 1
            return False
        g_norm = torch.sqrt(self.param_sum(self.params, [(a.float() ** 2).sum() for a in self.acc]))
        keep = g_norm < self.max_norm
        for acc, p in zip(self.acc, self.params):
            p.grad = torch.where(keep, acc, (acc / g_norm.to(acc.dtype)) * self.max_norm)
        self.inner.step()
        for acc, p in zip(self.acc, self.params):
            acc.zero_()
            p.grad = None
        self.mini_step = 0
        return True

    @property
    def param_sum(self):
        return self.inner.param_sum

    def zero_grad(self):
        for p in self.params:
            p.grad = None
