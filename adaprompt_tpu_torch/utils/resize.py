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
    `F.interpolate(..., antialias=True)` reads up to 2 levels off;
  * `pil_bilinear`: PIL's `Image.resize(..., Image.BILINEAR)` the same way,
    with the triangle filter (support 1, widened by the reduction factor),
    of an RGB [H, W, 3] or grey [H, W] uint8 image.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from adaprompt_tpu_torch.utils.png import to_rgb


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


def _pil_triangle(x: float) -> float:
    """PIL's bilinear_filter."""
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


_PIL_FILTERS = {"bicubic": (_pil_cubic, 2.0), "bilinear": (_pil_triangle, 1.0)}


def _pil_coeffs(in_size: int, out_size: int, method: str = "bicubic"):
    """PIL's precompute_coeffs and normalize_coeffs_8bpc for one axis:
    (source indices [out_size, k], fixed-point coefficients [out_size, k]),
    the taps past a pixel's support at index 0 with coefficient 0."""
    kernel, filter_support = _PIL_FILTERS[method]
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = filter_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [kernel((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:             # summed in order, as PIL sums them
            ww += v
        for x, v in enumerate(w):
            k = v / ww if ww != 0.0 else v
            kk[xx, x] = int(-0.5 + k * (1 << _PIL_BITS)) if k < 0 else int(0.5 + k * (1 << _PIL_BITS))
            idx[xx, x] = xmin + x
    return idx, kk


def _pil_pass(x: np.ndarray, axis: int, out_size: int, method: str) -> np.ndarray:
    """One PIL resampling pass of int64 pixels along `axis`, clipped to 0..255."""
    idx, kk = _pil_coeffs(x.shape[axis], out_size, method)
    shape = [1] * x.ndim
    shape[axis] = out_size
    acc = np.full(x.shape[:axis] + (out_size,) + x.shape[axis + 1:], 1 << (_PIL_BITS - 1),
                  np.int64)
    for j in range(idx.shape[1]):
        acc += np.take(x, idx[:, j], axis=axis) * kk[:, j].reshape(shape)
    return np.clip(acc >> _PIL_BITS, 0, 255)


def _pil_resize(img: np.ndarray, height: int, width: int, method: str) -> np.ndarray:
    x = np.asarray(img).astype(np.int64)
    if x.shape[1] != width:
        x = _pil_pass(x, 1, width, method)
    if x.shape[0] != height:
        x = _pil_pass(x, 0, height, method)
    return x.astype(np.uint8)


def pil_bicubic(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """uint8 [H, W, C] -> uint8 [height, width, C], equal to
    `np.asarray(Image.fromarray(img).resize((width, height), Image.BICUBIC))`
    for an RGB image."""
    return _pil_resize(img, height, width, "bicubic")


def pil_bilinear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """uint8 [H, W, C] or [H, W] -> uint8 [height, width(, C)], equal to
    `np.asarray(Image.fromarray(img).resize((width, height), Image.BILINEAR))`
    for an RGB or grey ('L') image."""
    return _pil_resize(img, height, width, "bilinear")


def _pil_nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """PIL's nearest resize along one axis: source index of each output
    pixel, from (x + 0.5) * in / out accumulated in double as PIL steps it."""
    step = float(in_size) / out_size
    pos = np.cumsum(np.concatenate([[step * 0.5], np.full(out_size - 1, step)]))
    return np.minimum(pos.astype(np.int64), in_size - 1)


def _premultiply(px: np.ndarray) -> np.ndarray:
    """PIL's RGBA -> RGBa (LA -> La): colour * alpha / 255, rounded as its MULDIV255."""
    out = px.astype(np.int64)
    tmp = out[..., :-1] * out[..., -1:] + 128
    out[..., :-1] = ((tmp >> 8) + tmp) >> 8
    return out.astype(np.uint8)


def _unpremultiply(px: np.ndarray) -> np.ndarray:
    """PIL's RGBa -> RGBA (La -> LA): colour * 255 / alpha, truncated and
    clipped, where alpha is neither 0 nor 255."""
    out = px.astype(np.int64)
    alpha = out[..., -1:]
    div = np.where((alpha == 0) | (alpha == 255), out[..., :-1],
                   (255 * out[..., :-1]) // np.maximum(alpha, 1))
    out[..., :-1] = np.clip(div, 0, 255)
    return out.astype(np.uint8)


def pil_bilinear_rgb(mode: str, px: np.ndarray, height: int, width: int,
                     palette: np.ndarray | None = None) -> np.ndarray:
    """PIL's `im.resize((width, height), Image.BILINEAR).convert("RGB")` of
    an image of `mode` ('1', 'L', 'LA', 'RGB', 'RGBA' or 'P'; the pixels as
    `utils/png.decode_png_mode` gives them) -> uint8 [height, width, 3]:
    '1' and 'P' resized by PIL's nearest rule (PIL resamples them no other
    way), 'LA' and 'RGBA' bilinearly with their colour premultiplied by
    alpha, then converted."""
    if mode in ("1", "P"):
        if px.shape[:2] != (height, width):
            px = px[_pil_nearest_index(px.shape[0], height)][:, _pil_nearest_index(px.shape[1],
                                                                                      width)]
        return to_rgb(mode, px, palette)
    if mode in ("LA", "RGBA"):
        if px.shape[:2] != (height, width):
            px = _unpremultiply(pil_bilinear(_premultiply(px), height, width))
        return to_rgb(mode, px)
    if mode in ("L", "RGB"):
        return to_rgb(mode, pil_bilinear(px, height, width))
    raise ValueError(f"images of mode {mode!r} are not resized here")
