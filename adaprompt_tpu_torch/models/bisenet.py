"""BiSeNet face parser (19 classes): the training masks of gen_face_masks and
the parsing face detector.

Port of `adaprompt_tpu/models/bisenet.py` (zllrunning face-parsing.PyTorch,
the published `79999_iter.pth`): a ResNet-18 context path, attention
refinement of its 1/16 and 1/32 features, a global-average branch, nearest
x2 upsampling, feature fusion with the 1/8 features and the output head;
the logits are brought back to the input size with
`F.interpolate(mode="bilinear", align_corners=True)`, as the published
model does (the JAX package writes that resize out by hand). NHWC, float32;
every BatchNorm in inference form on its running statistics; all
convolutions plain cuDNN ones, as XLA's were in the JAX package: no kernel
of the port runs here.

Parameters mirror the JAX pytree (see `convert.from_jax_params`):
`resnet.layers.i.j.conv1.weight`, `arm16.conv.bn.running_mean`,
`ffm.conv1.bias`, ... `from_torch` maps the `79999_iter.pth` layout onto
them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from adaprompt_tpu_torch.models.arcface import BatchNorm, Conv
from adaprompt_tpu_torch.ops.layers import Conv2d, reset_parameters


@dataclasses.dataclass(frozen=True)
class BiSeNetConfig:
    n_classes: int = 19
    input_size: int = 512
    bn_eps: float = 1e-5


BISENET_FACE = BiSeNetConfig()

_RESNET18_LAYERS = ((64, 64, 2), (64, 128, 2), (128, 256, 2), (256, 512, 2))
IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


class ConvBNReLU(nn.Module):
    """conv (no bias, 'same' padding) -> BatchNorm -> ReLU."""

    def __init__(self, cin, cout, k, eps, kw):
        super().__init__()
        self.conv = Conv(cin, cout, k, **kw)
        self.bn = BatchNorm(cout, eps, **kw)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class _Block(nn.Module):
    """ResNet-18 basic block; stride 2 and a 1x1 projection where the
    width changes."""

    def __init__(self, cin, cout, eps, kw):
        super().__init__()
        self.stride = 1 if cin == cout else 2
        self.conv1 = Conv(cin, cout, 3, **kw)
        self.bn1 = BatchNorm(cout, eps, **kw)
        self.conv2 = Conv(cout, cout, 3, **kw)
        self.bn2 = BatchNorm(cout, eps, **kw)
        if cin != cout:
            self.down_conv = Conv(cin, cout, 1, **kw)
            self.down_bn = BatchNorm(cout, eps, **kw)

    def forward(self, x):
        h = torch.relu(self.bn1(self.conv1(x, stride=self.stride)))
        h = self.bn2(self.conv2(h))
        if hasattr(self, "down_conv"):
            x = self.down_bn(self.down_conv(x, stride=self.stride))
        return torch.relu(x + h)


class _ResNet18(nn.Module):
    def __init__(self, eps, kw):
        super().__init__()
        self.conv1 = Conv(3, 64, 7, **kw)
        self.bn1 = BatchNorm(64, eps, **kw)
        self.layers = nn.ModuleList(
            nn.ModuleList([_Block(cin, cout, eps, kw)] + [_Block(cout, cout, eps, kw)
                                                          for _ in range(n - 1)])
            for cin, cout, n in _RESNET18_LAYERS)

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x, stride=2)))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        feats = []
        for blocks in self.layers:
            for block in blocks:
                x = block(x)
            feats.append(x)
        return feats[1], feats[2], feats[3]           # H/8, H/16, H/32


class _ARM(nn.Module):
    """Attention refinement: features scaled by a sigmoid of their global
    average through a 1x1 conv and a BatchNorm."""

    def __init__(self, cin, cout, eps, kw):
        super().__init__()
        self.conv = ConvBNReLU(cin, cout, 3, eps, kw)
        self.conv_atten = Conv(cout, cout, 1, **kw)
        self.bn_atten = BatchNorm(cout, eps, **kw)

    def forward(self, x):
        feat = self.conv(x)
        atten = feat.mean(dim=(1, 2), keepdim=True)
        return feat * torch.sigmoid(self.bn_atten(self.conv_atten(atten)))


class _FFM(nn.Module):
    def __init__(self, eps, kw):
        super().__init__()
        self.convblk = ConvBNReLU(256, 256, 1, eps, kw)
        self.conv1 = Conv2d(256, 64, 1, **kw)
        self.conv2 = Conv2d(64, 256, 1, **kw)

    def forward(self, spatial, context):
        feat = self.convblk(torch.cat([spatial, context], dim=-1))
        atten = feat.mean(dim=(1, 2), keepdim=True)
        atten = torch.sigmoid(self.conv2(torch.relu(self.conv1(atten))))
        return feat * atten + feat


class _Head(nn.Module):
    def __init__(self, cin, mid, n_classes, eps, kw):
        super().__init__()
        self.conv = ConvBNReLU(cin, mid, 3, eps, kw)
        self.conv_out = Conv2d(mid, n_classes, 1, **kw)

    def forward(self, x):
        return self.conv_out(self.conv(x))


def _upsample_nearest2(x):
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class BiSeNet(nn.Module):
    """resnet, arm16, arm32, conv_avg, conv_head32, conv_head16, ffm, conv_out."""

    def __init__(self, cfg: BiSeNetConfig = BISENET_FACE, *, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        kw, eps = dict(device=device, dtype=dtype), cfg.bn_eps
        self.resnet = _ResNet18(eps, kw)
        self.arm16 = _ARM(256, 128, eps, kw)
        self.arm32 = _ARM(512, 128, eps, kw)
        self.conv_avg = ConvBNReLU(512, 128, 1, eps, kw)
        self.conv_head32 = ConvBNReLU(128, 128, 3, eps, kw)
        self.conv_head16 = ConvBNReLU(128, 128, 3, eps, kw)
        self.ffm = _FFM(eps, kw)
        self.conv_out = _Head(256, 256, cfg.n_classes, eps, kw)

    @classmethod
    def random_init(cls, seed: int = 0, cfg: BiSeNetConfig = BISENET_FACE, *, device=None,
                    dtype=torch.float32) -> "BiSeNet":
        """Random weights from `seed` (BatchNorms at identity, the 1x1
        convs' biases zero, as in the JAX package's init and the published
        file, which has none), made on the device (CUDA unless `device` says
        otherwise; raises when CUDA is asked for and absent)."""
        from adaprompt_tpu_torch.pipeline import resolve_device
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        model = reset_parameters(cls(cfg, device=device, dtype=dtype), gen).eval()
        for conv in (model.ffm.conv1, model.ffm.conv2, model.conv_out.conv_out):
            conv.bias.data.zero_()
        return model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, H, W, 3] ImageNet-normalized -> logits [B, H, W, n_classes]."""
        h_in, w_in = x.shape[1:3]
        feat8, feat16, feat32 = self.resnet(x)
        avg = self.conv_avg(feat32.mean(dim=(1, 2), keepdim=True))
        f32 = self.conv_head32(_upsample_nearest2(self.arm32(feat32) + avg))       # H/16
        f16 = self.conv_head16(_upsample_nearest2(self.arm16(feat16) + f32))       # H/8
        out = self.conv_out(self.ffm(feat8, f16))
        out = F.interpolate(out.permute(0, 3, 1, 2), size=(h_in, w_in), mode="bilinear",
                            align_corners=True)
        return out.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Weights from the public checkpoint
# ---------------------------------------------------------------------------

def from_torch(state_dict, cfg: BiSeNetConfig = BISENET_FACE) -> dict[str, torch.Tensor]:
    """The face-parsing.PyTorch `79999_iter.pth` state dict -> a state dict
    for `BiSeNet(cfg)` (load with strict=True): `cp.resnet.layerN.M` becomes
    `resnet.layers.N-1.M`, `downsample.0/1` `down_conv`/`down_bn`, the
    context path's `cp.` prefix is dropped; the 1x1 convs' biases, which
    the published file lacks, are zero where absent; `num_batches_tracked`
    and the auxiliary heads `conv_out16` / `conv_out32` are left out."""
    sd = {}
    for k, v in state_dict.items():
        if hasattr(v, "detach"):
            v = v.detach().float().cpu().numpy()
        sd[k] = np.asarray(v)
    out = {}

    def conv(dst, src, bias=False):
        out[dst + ".weight"] = sd[src + ".weight"]
        if bias:
            out[dst + ".bias"] = sd.get(src + ".bias", np.zeros(len(out[dst + ".weight"])))

    def bn(dst, src):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{dst}.{leaf}"] = sd[f"{src}.{leaf}"]

    def cbr(dst, src):
        conv(dst + ".conv", src + ".conv")
        bn(dst + ".bn", src + ".bn")

    conv("resnet.conv1", "cp.resnet.conv1")
    bn("resnet.bn1", "cp.resnet.bn1")
    for si, (_, _, n) in enumerate(_RESNET18_LAYERS):
        for bi in range(n):
            src, dst = f"cp.resnet.layer{si + 1}.{bi}", f"resnet.layers.{si}.{bi}"
            for j in (1, 2):
                conv(f"{dst}.conv{j}", f"{src}.conv{j}")
                bn(f"{dst}.bn{j}", f"{src}.bn{j}")
            if src + ".downsample.0.weight" in sd:
                conv(dst + ".down_conv", src + ".downsample.0")
                bn(dst + ".down_bn", src + ".downsample.1")
    for arm in ("arm16", "arm32"):
        cbr(f"{arm}.conv", f"cp.{arm}.conv")
        conv(f"{arm}.conv_atten", f"cp.{arm}.conv_atten")
        bn(f"{arm}.bn_atten", f"cp.{arm}.bn_atten")
    for name in ("conv_avg", "conv_head32", "conv_head16"):
        cbr(name, "cp." + name)
    cbr("ffm.convblk", "ffm.convblk")
    conv("ffm.conv1", "ffm.conv1", bias=True)
    conv("ffm.conv2", "ffm.conv2", bias=True)
    cbr("conv_out.conv", "conv_out.conv")
    conv("conv_out.conv_out", "conv_out.conv_out", bias=True)
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}


def load(path: str, cfg: BiSeNetConfig = BISENET_FACE, *, device=None) -> BiSeNet:
    """A BiSeNet from a `79999_iter.pth` (or other `utils/torch_port`
    format) file, on `device` (CUDA unless told otherwise)."""
    from adaprompt_tpu_torch.pipeline import resolve_device
    from adaprompt_tpu_torch.utils.torch_port import load_state_dict
    device = resolve_device(device)
    state = from_torch(load_state_dict(path), cfg)
    model = BiSeNet(cfg, device=device)
    model.load_state_dict(state, strict=True)
    return model.eval()


# ---------------------------------------------------------------------------
# Parsing
# ---------------------------------------------------------------------------

def preprocess(images_uint8: np.ndarray) -> np.ndarray:
    """uint8 [B, H, W, 3] -> ImageNet-normalized float32 (the transforms of
    the reference's gen_face_masks)."""
    x = np.asarray(images_uint8, np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


@torch.no_grad()
def parse_faces(model: BiSeNet, images_uint8) -> np.ndarray:
    """Images (a list or batch of uint8 [H, W, 3] of one size) -> per-pixel
    part labels [B, H, W] int64 on the host; the forward and the argmax
    over the classes run on the model's device."""
    x = preprocess(np.stack([np.asarray(i) for i in images_uint8]))
    p = model.conv_out.conv_out.weight
    logits = model(torch.from_numpy(x).to(device=p.device, dtype=p.dtype))
    return logits.argmax(dim=-1).cpu().numpy()
