"""Elementary layers shared by every model of the port, on NHWC tensors.

Port of `adaprompt_tpu/ops/layers.py`. Public layouts follow the JAX package
(activations NHWC, tokens [B, N, C]); weights use PyTorch's layouts: linear
[out, in], conv OIHW (kept in channels_last memory format, so a conv on an
NHWC activation needs no copy on either side).

Numerics mirror the JAX functions:
  * `group_norm` takes float32 statistics but normalizes in the activation
    dtype (`layers.py:58-84`);
  * `linear`, `conv2d` and `conv1x1` round the product to the activation
    dtype and add the bias after that cast (`layers.py:91-97`).
In float32 both match the JAX package to rounding; in bfloat16 the two
frameworks round at slightly different places.

Parameter holders (`Linear`, `Conv2d`, `Norm`) keep the weights of one layer
under the names that `convert.from_jax_params` produces (`weight`, `bias`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)  # exact erf form


def layer_norm(x: torch.Tensor, weight: torch.Tensor | None,
               bias: torch.Tensor | None, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis; float32 statistics and affine."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-6,
               activation: str | None = None) -> torch.Tensor:
    """GroupNorm over an NHWC tensor, optional fused SiLU."""
    dtype = x.dtype
    b, h, w, c = x.shape
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    xg = x.reshape(b, h * w, num_groups, c // num_groups)
    x32 = xg.float()
    mean = x32.mean(dim=(1, 3), keepdim=True)
    var = (x32 - mean).square().mean(dim=(1, 3), keepdim=True)
    inv = torch.rsqrt(var + eps).to(dtype)
    y = ((xg - mean.to(dtype)) * inv).reshape(b, h, w, c)
    y = y * weight.to(dtype) + bias.to(dtype)
    if activation == "silu":
        y = F.silu(y)
    elif activation is not None:
        raise ValueError(f"unknown activation {activation!r}")
    return y


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """y = x @ weight.T (+ bias); weight [out, in]."""
    y = F.linear(x, weight.to(x.dtype))
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None, stride: int = 1,
           padding: int | tuple = 1) -> torch.Tensor:
    """NHWC conv with an OIHW weight. `padding` is an int or the JAX form
    ((top, bottom), (left, right))."""
    xc = x.permute(0, 3, 1, 2)                      # NCHW view, channels_last
    if isinstance(padding, int):
        pad = padding
    else:
        (pt, pb), (pl, pr) = padding
        xc = F.pad(xc, (pl, pr, pt, pb))
        pad = 0
    y = F.conv2d(xc, weight.to(x.dtype), None, stride, pad)
    y = y.permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def conv1x1(x: torch.Tensor, weight: torch.Tensor,
            bias: torch.Tensor | None = None) -> torch.Tensor:
    """1x1 conv as a matmul over the channel axis; weight [out, in, 1, 1]."""
    return linear(x, weight[:, :, 0, 0], bias)


# ---------------------------------------------------------------------------
# Parameter holders
# ---------------------------------------------------------------------------

class Linear(nn.Module):
    """Weights of one linear layer: weight [out, in], optional bias.

    Random init as the JAX package: uniform(+-1/sqrt(in)) for weight and
    bias, zeros when `zero_init` (LDM's zero_module), or normal(0, init_std)
    with a zero bias when `init_std` is given (CLIP)."""

    def __init__(self, cin: int, cout: int, bias: bool = True, *,
                 zero_init: bool = False, init_std: float | None = None,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty(cout, cin, **kw), requires_grad=False)
        self.bias = (nn.Parameter(torch.empty(cout, **kw), requires_grad=False)
                     if bias else None)
        self.zero_init = zero_init
        self.init_std = init_std

    def reset(self, gen: torch.Generator):
        if self.zero_init:
            self.weight.zero_()
            if self.bias is not None:
                self.bias.zero_()
        elif self.init_std is not None:
            self.weight.normal_(0.0, self.init_std, generator=gen)
            if self.bias is not None:
                self.bias.zero_()
        else:
            bound = 1.0 / math.sqrt(self.weight.shape[1])
            self.weight.uniform_(-bound, bound, generator=gen)
            if self.bias is not None:
                self.bias.uniform_(-bound, bound, generator=gen)

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class Conv2d(nn.Module):
    """Weights of one conv: weight OIHW (channels_last), bias [out]. Random
    init as Linear's: uniform(+-1/sqrt(fan_in)), zeros when `zero_init`, or
    normal(0, init_std) with a zero bias (a ViT's patch embedding)."""

    def __init__(self, cin: int, cout: int, k: int, *, zero_init: bool = False,
                 init_std: float | None = None, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(
            torch.empty(cout, cin, k, k, **kw).to(memory_format=torch.channels_last),
            requires_grad=False)
        self.bias = nn.Parameter(torch.empty(cout, **kw), requires_grad=False)
        self.zero_init = zero_init
        self.init_std = init_std

    def reset(self, gen: torch.Generator):
        if self.zero_init:
            self.weight.zero_()
            self.bias.zero_()
            return
        if self.init_std is not None:
            self.weight.normal_(0.0, self.init_std, generator=gen)
            self.bias.zero_()
            return
        o, i, kh, kw = self.weight.shape
        bound = 1.0 / math.sqrt(kh * kw * i)
        self.weight.uniform_(-bound, bound, generator=gen)
        self.bias.uniform_(-bound, bound, generator=gen)

    def forward(self, x, stride: int = 1, padding=1):
        if self.weight.shape[-1] == 1 and stride == 1:
            return conv1x1(x, self.weight, self.bias)
        return conv2d(x, self.weight, self.bias, stride, padding)


class Norm(nn.Module):
    """Affine of one GroupNorm or LayerNorm: weight (ones) and bias (zeros)."""

    def __init__(self, c: int, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty(c, **kw), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(c, **kw), requires_grad=False)

    def reset(self, gen: torch.Generator):
        self.weight.fill_(1.0)
        self.bias.zero_()


def reset_parameters(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Random-init, from `gen`, every submodule that has a `reset(gen)`."""
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, "reset"):
                m.reset(gen)
    return module


def randomize_zero_init(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Give the zero-initialized layers (LDM's zero_module: the UNet's
    ResBlock second convs, proj_out and out.conv) random weights too, so
    that with random weights every layer's output reaches the model's output."""
    with torch.no_grad():
        for m in module.modules():
            if getattr(m, "zero_init", False):
                m.zero_init = False
                m.reset(gen)
    return module
