"""Image-space quality metrics: PSNR and SSIM between two image sets, and
a random-feature perceptual cosine through the ArcFace IResNet.

Port of `adaprompt_tpu/eval/image_metrics.py`. `psnr` and `ssim` are the
JAX package's float64 numpy arithmetic, population statistics over a
reflect-padded box window included. `random_arcface_cosine` embeds both
batches with an IResNet of SHARED weights (random from a seed unless
given: a fixed random deep net is a perceptual-distance proxy that needs
no asset) after jax's antialiased triangle ("bilinear") resize to 112x112.
The IResNet's convolutions are plain cuDNN ones: no kernel of the port
runs here.
"""

from __future__ import annotations

import numpy as np
import torch


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    """Peak signal-to-noise ratio in dB over uint8-range images [..., H, W, C]."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


def _box(x: np.ndarray, w: int) -> np.ndarray:
    """Mean filter with a w x w box over the last two axes of [..., H, W]
    (reflect padding, summed through cumulative sums)."""
    pad = w // 2
    x = np.pad(x, [(0, 0)] * (x.ndim - 2) + [(pad, pad), (pad, pad)], mode="reflect")
    c = np.cumsum(np.cumsum(x, axis=-2), axis=-1)
    c = np.pad(c, [(0, 0)] * (x.ndim - 2) + [(1, 0), (1, 0)])
    return (c[..., w:, w:] - c[..., :-w, w:] - c[..., w:, :-w] + c[..., :-w, :-w]) / (w * w)


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 255.0, win: int = 7) -> float:
    """Mean SSIM over [..., H, W, C] images: a uniform win x win window,
    the standard C1/C2 stabilizers, population variances."""
    a = np.moveaxis(np.asarray(a, np.float64), -1, 0)   # [C, ..., H, W]
    b = np.moveaxis(np.asarray(b, np.float64), -1, 0)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a, mu_b = _box(a, win), _box(b, win)
    var_a = _box(a * a, win) - mu_a ** 2
    var_b = _box(b * b, win) - mu_b ** 2
    cov = _box(a * b, win) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return float(np.mean(s))


def random_arcface_cosine(imgs_a: np.ndarray, imgs_b: np.ndarray, arcface=None,
                          seed: int = 0, small: bool = False, device=None) -> float:
    """Mean cosine similarity of the ArcFace embeddings of two aligned
    uint8 batches [N, H, W, 3], each resized to the 112x112 input (no
    detection: both batches share their layout by construction). `arcface`:
    an `ArcFace` module, whose device the batches go to; when None, random
    weights from `seed` on `device` (CUDA by default), IResNet-18 when
    `small` (CPU-test-sized), else the production IResNet-100."""
    from adaprompt_tpu_torch.models import arcface as af
    from adaprompt_tpu_torch.utils.resize import resize
    if arcface is None:
        arcface = af.ArcFace.random_init(seed, af.IRESNET18 if small else af.IRESNET100,
                                         device=device)
    dev = arcface.fc.weight.device

    @torch.no_grad()
    def embed(imgs):
        x = resize(torch.as_tensor(np.asarray(imgs), device=dev).float(), 112, 112, "bilinear")
        e = arcface((x - 127.5) / 127.5).double().cpu().numpy()
        return e / (np.linalg.norm(e, axis=-1, keepdims=True) + 1e-12)

    return float(np.mean(np.sum(embed(imgs_a) * embed(imgs_b), axis=-1)))
