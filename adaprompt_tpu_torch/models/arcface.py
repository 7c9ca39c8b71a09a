"""ArcFace face-recognition trunk (IResNet): ID embeddings on the device.

Port of `adaprompt_tpu/models/arcface.py`: the standard IResNet{18,50,100}
(glintr100 == IResNet-100, 512-d output, 112x112 input, (x - 127.5) / 127.5
preprocessing), NHWC activations. Weights port from the public torch
`iresnet` layout (insightface/recognition/arcface_torch) or from an
insightface .onnx file whose initializers kept those names; face detection
stays on the host.

Every BatchNorm runs in inference form on its running statistics, in
float32 and in the JAX package's order of operations. All convolutions are
plain cuDNN convolutions: the JAX package computes them outside any kernel
of its own, too.

Parameter names are the JAX tree's after `convert.from_jax_params`
(`stages.i.j.conv1.weight`, `bn1.running_mean`, `prelu.alpha`, ...).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from adaprompt_tpu_torch.ops.layers import Linear, conv2d, reset_parameters


@dataclasses.dataclass(frozen=True)
class IResNetConfig:
    layers: tuple = (3, 13, 30, 3)   # IResNet-100
    planes: tuple = (64, 128, 256, 512)
    num_features: int = 512
    input_size: int = 112
    bn_eps: float = 1e-5


IRESNET100 = IResNetConfig()
IRESNET50 = IResNetConfig(layers=(3, 4, 14, 3))
IRESNET18 = IResNetConfig(layers=(2, 2, 2, 2))


# ---------------------------------------------------------------------------
# Parameter holders
# ---------------------------------------------------------------------------

class BatchNorm(nn.Module):
    """Inference-form BatchNorm over the last axis: affine and running
    statistics. Init: identity."""

    def __init__(self, c: int, eps: float, **kw):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(c, **kw), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(c, **kw), requires_grad=False)
        self.register_buffer("running_mean", torch.empty(c, **kw))
        self.register_buffer("running_var", torch.empty(c, **kw))

    def reset(self, gen: torch.Generator):
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x):
        inv = torch.rsqrt(self.running_var.float() + self.eps)
        y = (x.float() - self.running_mean) * inv * self.weight + self.bias
        return y.to(x.dtype)


class PReLU(nn.Module):
    """Per-channel PReLU slopes `alpha` (init 0.25)."""

    def __init__(self, c: int, **kw):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(c, **kw), requires_grad=False)

    def reset(self, gen: torch.Generator):
        self.alpha.fill_(0.25)

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)


class Conv(nn.Module):
    """A conv without bias: weight OIHW (channels_last). Init normal(0, 1/sqrt(fan_in))."""

    def __init__(self, cin: int, cout: int, k: int, **kw):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(cout, cin, k, k, **kw).to(memory_format=torch.channels_last),
            requires_grad=False)

    def reset(self, gen: torch.Generator):
        o, i, kh, kw = self.weight.shape
        self.weight.normal_(0.0, 1.0 / math.sqrt(kh * kw * i), generator=gen)

    def forward(self, x, stride: int = 1):
        return conv2d(x, self.weight, None, stride, self.weight.shape[-1] // 2)


class _Block(nn.Module):
    def __init__(self, cin, cout, stride, eps, kw):
        super().__init__()
        self.stride = stride
        self.bn1 = BatchNorm(cin, eps, **kw)
        self.conv1 = Conv(cin, cout, 3, **kw)
        self.bn2 = BatchNorm(cout, eps, **kw)
        self.prelu = PReLU(cout, **kw)
        self.conv2 = Conv(cout, cout, 3, **kw)
        self.bn3 = BatchNorm(cout, eps, **kw)
        if stride != 1 or cin != cout:
            self.down_conv = Conv(cin, cout, 1, **kw)
            self.down_bn = BatchNorm(cout, eps, **kw)

    def forward(self, x):
        h = self.conv1(self.bn1(x))
        h = self.prelu(self.bn2(h))
        h = self.bn3(self.conv2(h, stride=self.stride))
        if hasattr(self, "down_conv"):
            x = self.down_bn(self.down_conv(x, stride=self.stride))
        return x + h


class ArcFace(nn.Module):
    """IResNet trunk: conv1, bn1, prelu, stages[i][j], bn2, fc, features_bn."""

    def __init__(self, cfg: IResNetConfig = IRESNET100, *, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        eps = cfg.bn_eps
        self.conv1 = Conv(3, 64, 3, **kw)
        self.bn1 = BatchNorm(64, eps, **kw)
        self.prelu = PReLU(64, **kw)
        stages, cin = [], 64
        for n, cout in zip(cfg.layers, cfg.planes):
            blocks = [_Block(cin, cout, 2, eps, kw)]
            blocks += [_Block(cout, cout, 1, eps, kw) for _ in range(n - 1)]
            stages.append(nn.ModuleList(blocks))
            cin = cout
        self.stages = nn.ModuleList(stages)
        self.bn2 = BatchNorm(cin, eps, **kw)
        spatial = cfg.input_size // 16
        self.fc = Linear(cin * spatial * spatial, cfg.num_features, init_std=0.01, **kw)
        self.features_bn = BatchNorm(cfg.num_features, eps, **kw)

    @classmethod
    def random_init(cls, seed: int = 0, cfg: IResNetConfig = IRESNET100, *, device=None,
                    dtype=torch.float32) -> "ArcFace":
        """Random weights from `seed`, made on the device (CUDA unless
        `device` says otherwise; raises when CUDA is asked for and absent)."""
        from adaprompt_tpu_torch.pipeline import resolve_device
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        return reset_parameters(cls(cfg, device=device, dtype=dtype), gen).eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """images [B, S, S, 3] with values in [-1, 1] ((pix - 127.5) / 127.5,
        RGB) -> embeddings [B, num_features] (not normalized)."""
        h = self.prelu(self.bn1(self.conv1(x)))
        for blocks in self.stages:
            for block in blocks:
                h = block(h)
        h = self.bn2(h)
        return self.features_bn(self.fc(h.reshape(h.shape[0], -1)))


# ---------------------------------------------------------------------------
# Weights from the public checkpoints
# ---------------------------------------------------------------------------

def from_torch(state_dict, cfg: IResNetConfig = IRESNET100) -> dict[str, torch.Tensor]:
    """The public arcface_torch iresnet state_dict -> a state dict for
    `ArcFace(cfg)` (load with strict=True): `layerN.M` becomes
    `stages.N-1.M`, `downsample.0/1` `down_conv`/`down_bn`, PReLU `weight`
    `alpha`, `features` `features_bn`; the fc weight, which there multiplies
    NCHW-flattened features, is permuted to this model's NHWC flattening."""
    sd = {}
    for k, v in state_dict.items():
        if hasattr(v, "detach"):
            v = v.detach().float().cpu().numpy()
        sd[k] = np.asarray(v)
    out = {}

    def conv(dst, src):
        out[dst + ".weight"] = sd[src + ".weight"]

    def bn(dst, src):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{dst}.{leaf}"] = sd[f"{src}.{leaf}"]

    def prelu(dst, src):
        out[dst + ".alpha"] = sd[src + ".weight"].reshape(-1)

    conv("conv1", "conv1")
    bn("bn1", "bn1")
    prelu("prelu", "prelu")
    for si, n in enumerate(cfg.layers, start=1):
        for bi in range(n):
            src, dst = f"layer{si}.{bi}", f"stages.{si - 1}.{bi}"
            bn(dst + ".bn1", src + ".bn1")
            conv(dst + ".conv1", src + ".conv1")
            bn(dst + ".bn2", src + ".bn2")
            prelu(dst + ".prelu", src + ".prelu")
            conv(dst + ".conv2", src + ".conv2")
            bn(dst + ".bn3", src + ".bn3")
            if src + ".downsample.0.weight" in sd:
                conv(dst + ".down_conv", src + ".downsample.0")
                bn(dst + ".down_bn", src + ".downsample.1")
    bn("bn2", "bn2")
    spatial, c = cfg.input_size // 16, cfg.planes[-1]
    w = sd["fc.weight"].reshape(cfg.num_features, c, spatial, spatial)     # [F, C, H, W]
    out["fc.weight"] = w.transpose(0, 2, 3, 1).reshape(cfg.num_features, spatial * spatial * c)
    out["fc.bias"] = sd["fc.bias"]
    bn("features_bn", "features")
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}


def from_onnx(path: str, cfg: IResNetConfig = IRESNET100) -> dict[str, torch.Tensor]:
    """ArcFace weights straight from an insightface .onnx file (antelopev2
    glintr100). Works when the export kept the arcface_torch module names in
    the initializers (the standard torch.onnx export of iresnet); raises
    with the names found otherwise, so that a rename map can be supplied."""
    from adaprompt_tpu_torch.utils.onnx_port import read_onnx_initializers
    init = read_onnx_initializers(path)
    if "conv1.weight" not in init:
        raise ValueError(
            "ONNX initializers don't carry arcface_torch module names; "
            f"found e.g. {sorted(init)[:20]}. Convert with a rename map to the "
            "layerN.M.* layout and call from_torch().")
    return from_torch(init, cfg)


def preprocess(images_uint8: np.ndarray) -> np.ndarray:
    """uint8 RGB [B, S, S, 3] -> model input."""
    return (np.asarray(images_uint8, np.float32) - 127.5) / 127.5


def cosine_similarity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a = a / torch.linalg.norm(a, dim=-1, keepdim=True)
    b = b / torch.linalg.norm(b, dim=-1, keepdim=True)
    return (a * b).sum(dim=-1)
