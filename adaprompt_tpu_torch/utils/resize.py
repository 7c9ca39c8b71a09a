"""The image resizes of the port, each in the arithmetic of the function it
stands for:

  * `bicubic_weights` and `triangle_weights`: one axis's weights of
    `jax.image.resize(..., "bicubic")` and `(..., "bilinear")`, in its
    float32 arithmetic: Keys' cubic (a = -0.5) or the triangle kernel,
    widened by in/out when the axis shrinks (antialiased), each column
    normalized to sum 1. `resize` applies them to an NHWC tensor, one
    product per axis whose size changes. `F.interpolate(mode="bilinear")`
    does not antialias, so it is no substitute when an image shrinks;
  * `pil_bicubic`: PIL's `Image.resize(..., Image.BICUBIC)` of an RGB uint8
    image on numpy (the card's machine has no PIL), equal to it bit for bit:
    the horizontal pass first, then the vertical one, each with a = -0.5,
    the support widened by the reduction factor, coefficients in fixed point
    with 22 fractional bits, and each pass rounded and clipped to uint8.
    `F.interpolate(..., antialias=True)` reads up to 2 levels off.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel with a = -0.5 at distances x >= 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def _weights(in_size: int, out_size: int, kernel) -> np.ndarray:
    """[in_size, out_size] float32 weights of jax's antialiased resize with
    `kernel` along one axis."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(out_size / in_size)
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / max(inv_scale, f32(1))
    w = kernel(x).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def bicubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] weights of `jax.image.resize(..., "bicubic")`."""
    return _weights(in_size, out_size, _keys_cubic)


def triangle_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] weights of `jax.image.resize(..., "bilinear")`."""
    return _weights(in_size, out_size, _triangle)


_METHODS = {"bicubic": bicubic_weights, "bilinear": triangle_weights}


def resize(x: torch.Tensor, height: int, width: int, method: str = "bicubic") -> torch.Tensor:
    """float [B, H, W, C] -> [B, height, width, C] as `jax.image.resize`
    with `method` ('bicubic' or 'bilinear'), on x's device; an axis whose
    size does not change is left as it is, as jax leaves it."""
    weights = _METHODS[method]
    h, w = x.shape[1], x.shape[2]
    if h != height:
        wh = torch.as_tensor(weights(h, height), dtype=x.dtype, device=x.device)
        x = torch.einsum("bhwc,ho->bowc", x, wh)
    if w != width:
        ww = torch.as_tensor(weights(w, width), dtype=x.dtype, device=x.device)
        x = torch.einsum("bhwc,wo->bhoc", x, ww)
    return x


# -- PIL's BICUBIC ------------------------------------------------------------------

_PIL_BITS = 22          # PRECISION_BITS of PIL's Resample.c: 32 - 8 - 2


def _pil_cubic(x: float) -> float:
    """PIL's bicubic_filter (a = -0.5), in its order of operations."""
    x = abs(x)
    if x < 1.0:
        return ((-0.5 + 2.0) * x - (-0.5 + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * -0.5
    return 0.0


def _pil_coeffs(in_size: int, out_size: int):
    """PIL's precompute_coeffs and normalize_coeffs_8bpc for one axis:
    (source indices [out_size, k], fixed-point coefficients [out_size, k]),
    the taps past a pixel's support at index 0 with coefficient 0."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_pil_cubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:             # summed in order, as PIL sums them
            ww += v
        for x, v in enumerate(w):
            k = v / ww if ww != 0.0 else v
            kk[xx, x] = int(-0.5 + k * (1 << _PIL_BITS)) if k < 0 else int(0.5 + k * (1 << _PIL_BITS))
            idx[xx, x] = xmin + x
    return idx, kk


def _pil_pass(x: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One PIL resampling pass of int64 pixels along `axis`, clipped to 0..255."""
    idx, kk = _pil_coeffs(x.shape[axis], out_size)
    shape = [1] * x.ndim
    shape[axis] = out_size
    acc = np.full(x.shape[:axis] + (out_size,) + x.shape[axis + 1:], 1 << (_PIL_BITS - 1),
                  np.int64)
    for j in range(idx.shape[1]):
        acc += np.take(x, idx[:, j], axis=axis) * kk[:, j].reshape(shape)
    return np.clip(acc >> _PIL_BITS, 0, 255)


def pil_bicubic(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """uint8 [H, W, C] -> uint8 [height, width, C], equal to
    `np.asarray(Image.fromarray(img).resize((width, height), Image.BICUBIC))`
    for an RGB image."""
    x = np.asarray(img).astype(np.int64)
    if x.shape[1] != width:
        x = _pil_pass(x, 1, width)
    if x.shape[0] != height:
        x = _pil_pass(x, 0, height)
    return x.astype(np.uint8)
