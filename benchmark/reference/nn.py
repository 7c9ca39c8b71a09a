"""Plain PyTorch operations of the reference models, in float32 by default.

Every model of `benchmark/reference/` is a function of a flat dict of
weights (the names of the port's state dicts, so that one set of seeded
weights loads into both) and computes with these operations only: no
kernel, no cache, no batching trick. Convolutions take NCHW activations
and OIHW weights.

`lower_precision(kind)` turns the same code into the correctness control,
the reference computed one step below the precision that a configuration
states:
  * "bf16": every weight and activation in bfloat16 (the control of the
    float32 towers; the caller casts the weights and inputs, the operations
    keep the dtype they are given);
  * "fp8": every linear and convolution quantizes both operands to
    float8 e4m3 with one scale a tensor and multiplies the dequantized
    values in float32 (the control of the bfloat16 UNet and VAE).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

_MODE = {"fp8": False}
FP8_MAX = 448.0


@contextlib.contextmanager
def lower_precision(kind: str):
    if kind not in ("bf16", "fp8"):
        raise ValueError(f"unknown lower precision {kind!r}")
    old = dict(_MODE)
    _MODE["fp8"] = kind == "fp8"
    try:
        yield
    finally:
        _MODE.update(old)


def fake_fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one per-tensor scale, back in t's
    dtype; the gradient passes through the rounding unchanged (a float8
    gradient without a scale of its own would flush to zero)."""
    amax = t.detach().abs().amax().float().clamp_min(1e-12)
    scale = FP8_MAX / amax
    q = (t.detach().float() * scale).clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)
    return t + ((q.float() / scale).to(t.dtype) - t.detach())


def _operands(x, w):
    if _MODE["fp8"]:
        return fake_fp8(x), fake_fp8(w)
    return x, w


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    x, w = _operands(x, w)
    y = x @ w.t()
    return y if b is None else y + b


def conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, stride: int = 1,
         padding=None) -> torch.Tensor:
    """NCHW convolution; padding k // 2 unless given (an int, or F.pad's 4-tuple)."""
    x, w = _operands(x, w)
    if padding is None:
        padding = w.shape[-1] // 2
    if isinstance(padding, tuple):
        x = F.pad(x, padding)
        padding = 0
    return F.conv2d(x, w, b, stride, padding)


def group_norm(x: torch.Tensor, w, b, eps: float, groups: int = 32) -> torch.Tensor:
    """GroupNorm of NCHW x: statistics over each group's channels and pixels."""
    n, c = x.shape[:2]
    g = x.reshape(n, groups, -1)
    mean = g.mean(dim=-1, keepdim=True)
    var = (g - mean).square().mean(dim=-1, keepdim=True)
    y = ((g - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.ndim - 2)
    return y * w.reshape(shape) + b.reshape(shape)


def layer_norm(x: torch.Tensor, w, b, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def silu(x):
    return x * torch.sigmoid(x)


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def attention(q, k, v, heads: int, mask=None) -> torch.Tensor:
    """Multi-head attention of [B, Sq, C] queries over [B, Sk, C] keys and
    values (C = heads x head width), softmax at scale head_width**-0.5; an
    additive `mask` broadcasts over [B, heads, Sq, Sk]."""
    b, sq, c = q.shape
    hd = c // heads
    qh = q.reshape(b, sq, heads, hd).transpose(1, 2)
    kh = k.reshape(b, -1, heads, hd).transpose(1, 2)
    vh = v.reshape(b, -1, heads, hd).transpose(1, 2)
    logits = (qh @ kh.transpose(-1, -2)) * hd ** -0.5
    if mask is not None:
        logits = logits + mask
    p = torch.softmax(logits, dim=-1)
    return (p @ vh).transpose(1, 2).reshape(b, sq, -1)


def rel_l2(a: torch.Tensor, ref: torch.Tensor) -> float:
    """||a - ref|| / ||ref|| in float64."""
    a, ref = a.double(), ref.double()
    return float(torch.linalg.norm(a - ref) / torch.linalg.norm(ref).clamp_min(1e-30))
