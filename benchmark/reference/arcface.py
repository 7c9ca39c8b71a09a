"""ArcFace IResNet-100 (insightface `arcface_torch` iresnet100, glintr100), plain.

A 3x3 stem (BN, PReLU), four stages of IBasicBlocks (BN - conv3x3 - BN -
PReLU - conv3x3 (stride on the first block of a stage) - BN, plus a 1x1
conv + BN shortcut where the shape changes), BN, the fc over the flattened
7x7x512 map and a BatchNorm1d on the 512 features; every BatchNorm in
inference form. Input: 112x112 RGB, (pixel - 127.5) / 127.5. The port keeps
its fc weight for an NHWC flattening, so this reference flattens NHWC too.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import nn

STEM = 64       # iresnet's inplanes: the stem's width, whatever the stages'


def param_shapes(c: dict) -> list:
    out = []

    def conv(name, cin, cout, k):
        out.append((name + ".weight", (cout, cin, k, k), ("normal", 1.0 / math.sqrt(cin * k * k))))

    def bn(name, n):
        out.extend([(name + ".weight", (n,), ("one", 0.05)), (name + ".bias", (n,), ("normal", 0.05)),
                    (name + ".running_mean", (n,), ("normal", 0.05)),
                    (name + ".running_var", (n,), ("one", 0.05))])

    def prelu(name, n):
        out.append((name + ".alpha", (n,), ("const_plus", 0.25, 0.02)))

    conv("conv1", 3, STEM, 3)
    bn("bn1", STEM)
    prelu("prelu", STEM)
    cin = STEM
    for si, (n, cout) in enumerate(zip(c["layers"], c["planes"])):
        for bi in range(n):
            p = f"stages.{si}.{bi}."
            a = cin if bi == 0 else cout
            bn(p + "bn1", a)
            conv(p + "conv1", a, cout, 3)
            bn(p + "bn2", cout)
            prelu(p + "prelu", cout)
            conv(p + "conv2", cout, cout, 3)
            bn(p + "bn3", cout)
            if bi == 0:
                conv(p + "down_conv", a, cout, 1)
                bn(p + "down_bn", cout)
        cin = cout
    bn("bn2", cin)
    spatial = c["input_size"] // 16
    feats = cin * spatial * spatial
    out += [("fc.weight", (c["num_features"], feats), ("normal", 0.01)),
            ("fc.bias", (c["num_features"],), ("normal", 0.01))]
    bn("features_bn", c["num_features"])
    return out


def center_crop(image: np.ndarray, size: int) -> np.ndarray:
    """The centre square of an HWC photo, resized to `size` by nearest index
    sampling (the stand-in for face detection that the cell names)."""
    h, w = image.shape[:2]
    s = min(h, w)
    y0, x0 = (h - s) // 2, (w - s) // 2
    idx = (np.arange(size) * (s / size)).astype(np.int64)
    return image[y0:y0 + s, x0:x0 + s][idx][:, idx]


def forward(w: dict, c: dict, x: torch.Tensor) -> torch.Tensor:
    """NHWC images in [-1, 1] -> [B, num_features] (not normalized)."""
    eps = c.get("bn_eps", 1e-5)
    shp = lambda t, h: t.reshape((1, -1) + (1,) * (h.ndim - 2))

    def bn(p, h):
        inv = 1.0 / torch.sqrt(w[p + ".running_var"] + eps)
        return ((h - shp(w[p + ".running_mean"], h)) * shp(inv * w[p + ".weight"], h)
                + shp(w[p + ".bias"], h))

    def prelu(p, h):
        return torch.where(h >= 0, h, shp(w[p + ".alpha"], h) * h)

    def cv(p, h, stride=1):
        return nn.conv(h, w[p + ".weight"], None, stride=stride)

    h = prelu("prelu", bn("bn1", cv("conv1", x.permute(0, 3, 1, 2))))
    for si, n in enumerate(c["layers"]):
        for bi in range(n):
            p = f"stages.{si}.{bi}."
            stride = 2 if bi == 0 else 1
            y = cv(p + "conv1", bn(p + "bn1", h))
            y = prelu(p + "prelu", bn(p + "bn2", y))
            y = bn(p + "bn3", cv(p + "conv2", y, stride))
            if bi == 0:
                h = bn(p + "down_bn", cv(p + "down_conv", h, stride))
            h = h + y
    h = bn("bn2", h).permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    return bn("features_bn", nn.linear(h, w["fc.weight"], w["fc.bias"]))
