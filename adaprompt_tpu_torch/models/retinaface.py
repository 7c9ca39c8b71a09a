"""RetinaFace face detector (ResNet-50 trunk): the reference's detection
semantics, five regressed landmarks a face.

Port of `adaprompt_tpu/models/retinaface.py` (the public Pytorch_Retinaface
`Resnet50_Final.pth`, InsightFace's RetinaFace, arXiv:1905.00641): an FPN
over C3/C4/C5 with nearest upsampling, three SSH context modules and the
class/box/landmark 1x1 heads of each level, 2 anchors a position (a 640
canvas gives 16,800). Every BatchNorm is folded into its conv's scale and
shift at load (detection runs in eval mode only), in float32 as the JAX
package folds it. NHWC, float32; all convolutions plain cuDNN ones, as XLA's
were: no kernel of the port runs here.

`detect_faces` preprocesses on the host (nearest resize into a zero canvas,
BGR, the published means subtracted), runs the forward and the softmax on
the model's device, then decodes the anchors and runs NMS on the host in
numpy, as the JAX package does (the same `argsort`, so ties order alike).

Parameters mirror the JAX pytree (see `convert.from_jax_params`):
`stem.weight/scale/shift`, `stages.i.j.conv1.*`, `fpn.output1.*`,
`ssh.0.conv3X3.*`, `heads.ClassHead.0.weight/bias`, ...
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from adaprompt_tpu_torch.ops.layers import Conv2d, conv2d, reset_parameters


@dataclasses.dataclass(frozen=True)
class RetinaFaceConfig:
    # torchvision ResNet-50 trunk: bottleneck counts per stage
    stage_blocks: tuple = (3, 4, 6, 3)
    stage_planes: tuple = (256, 512, 1024, 2048)
    fpn_out: int = 256
    strides: tuple = (8, 16, 32)
    min_sizes: tuple = ((16, 32), (64, 128), (256, 512))
    variances: tuple = (0.1, 0.2)
    num_anchors: int = 2


RETINAFACE_R50 = RetinaFaceConfig()
BGR_MEANS = np.array([104.0, 117.0, 123.0], np.float32)
_HEADS = (("ClassHead", 2), ("BboxHead", 4), ("LandmarkHead", 10))


class ConvAffine(nn.Module):
    """conv (no bias) -> per-channel scale and shift (a folded BatchNorm) ->
    optional ReLU. Init: normal(0, 1/sqrt(fan_in)), scale 1, shift 0."""

    def __init__(self, cin: int, cout: int, k: int, **kw):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(cout, cin, k, k, **kw).to(memory_format=torch.channels_last),
            requires_grad=False)
        self.scale = nn.Parameter(torch.empty(cout, **kw), requires_grad=False)
        self.shift = nn.Parameter(torch.empty(cout, **kw), requires_grad=False)

    def reset(self, gen: torch.Generator):
        o, i, kh, kw = self.weight.shape
        self.weight.normal_(0.0, 1.0 / math.sqrt(kh * kw * i), generator=gen)
        self.scale.fill_(1.0)
        self.shift.zero_()

    def forward(self, x, stride: int = 1, relu: bool = True):
        y = conv2d(x, self.weight, None, stride, (self.weight.shape[-1] - 1) // 2)
        y = y * self.scale + self.shift
        return torch.relu(y) if relu else y


class _Bottleneck(nn.Module):
    def __init__(self, cin, planes, stride, kw):
        super().__init__()
        mid = planes // 4
        self.stride = stride
        self.conv1 = ConvAffine(cin, mid, 1, **kw)
        self.conv2 = ConvAffine(mid, mid, 3, **kw)
        self.conv3 = ConvAffine(mid, planes, 1, **kw)
        if cin != planes or stride != 1:
            self.down = ConvAffine(cin, planes, 1, **kw)

    def forward(self, x):
        h = self.conv2(self.conv1(x), stride=self.stride)
        h = self.conv3(h, relu=False)
        sc = self.down(x, stride=self.stride, relu=False) if hasattr(self, "down") else x
        return torch.relu(h + sc)


class _SSH(nn.Module):
    def __init__(self, c, kw):
        super().__init__()
        self.conv3X3 = ConvAffine(c, c // 2, 3, **kw)
        self.conv5X5_1 = ConvAffine(c, c // 4, 3, **kw)
        self.conv5X5_2 = ConvAffine(c // 4, c // 4, 3, **kw)
        self.conv7X7_2 = ConvAffine(c // 4, c // 4, 3, **kw)
        self.conv7x7_3 = ConvAffine(c // 4, c // 4, 3, **kw)

    def forward(self, x):
        c3 = self.conv3X3(x, relu=False)
        c5_1 = self.conv5X5_1(x)
        c5 = self.conv5X5_2(c5_1, relu=False)
        c7 = self.conv7x7_3(self.conv7X7_2(c5_1), relu=False)
        return torch.relu(torch.cat([c3, c5, c7], dim=-1))


def _upsample_to(x, h, w):
    """Nearest resize of NHWC x to (h, w) as `jax.image.resize(...,
    "nearest")`: source index floor((i + 0.5) * in / out) in float32."""
    def index(n_in, n_out):
        src = (torch.arange(n_out, dtype=torch.float32) + 0.5) * n_in / n_out
        return torch.floor(src).long().to(x.device)
    if x.shape[1] != h:
        x = x.index_select(1, index(x.shape[1], h))
    if x.shape[2] != w:
        x = x.index_select(2, index(x.shape[2], w))
    return x


class RetinaFace(nn.Module):
    """stem, stages[i][j], fpn, ssh[i], heads[name][level]."""

    def __init__(self, cfg: RetinaFaceConfig = RETINAFACE_R50, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.stem = ConvAffine(3, 64, 7, **kw)
        stages, cin = [], 64
        for s, (n, planes) in enumerate(zip(cfg.stage_blocks, cfg.stage_planes)):
            stages.append(nn.ModuleList(
                [_Bottleneck(cin if i == 0 else planes, planes, 2 if (i == 0 and s > 0) else 1,
                             kw) for i in range(n)]))
            cin = planes
        self.stages = nn.ModuleList(stages)
        out = cfg.fpn_out
        self.fpn = nn.ModuleDict({f"output{i}": ConvAffine(c, out, 1, **kw)
                                  for i, c in enumerate(cfg.stage_planes[1:], start=1)})
        self.fpn["merge1"] = ConvAffine(out, out, 3, **kw)
        self.fpn["merge2"] = ConvAffine(out, out, 3, **kw)
        self.ssh = nn.ModuleList(_SSH(out, kw) for _ in range(3))
        self.heads = nn.ModuleDict({
            name: nn.ModuleList(Conv2d(out, cfg.num_anchors * ch, 1, **kw) for _ in range(3))
            for name, ch in _HEADS})

    @classmethod
    def random_init(cls, seed: int = 0, cfg: RetinaFaceConfig = RETINAFACE_R50, *,
                    device=None, dtype=torch.float32) -> "RetinaFace":
        """Random weights from `seed` (scales 1, shifts 0; the heads'
        weights and biases uniform in +-1/sqrt(256)), made on the device (CUDA unless `device` says otherwise; raises when CUDA is
        asked for and absent)."""
        from adaprompt_tpu_torch.pipeline import resolve_device
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        return reset_parameters(cls(cfg, device=device, dtype=dtype), gen).eval()

    def forward(self, images: torch.Tensor):
        """images: [B, H, W, 3] float32, BGR, minus the means (104, 117,
        123). Returns (class logits [B, N, 2], boxes [B, N, 4], landmarks
        [B, N, 10]), the levels concatenated in anchor order."""
        x = self.stem(images, stride=2)
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        feats = []
        for blocks in self.stages:
            for block in blocks:
                x = block(x)
            feats.append(x)
        f = self.fpn
        o1, o2, o3 = f["output1"](feats[1]), f["output2"](feats[2]), f["output3"](feats[3])
        o2 = f["merge2"](o2 + _upsample_to(o3, o2.shape[1], o2.shape[2]))
        o1 = f["merge1"](o1 + _upsample_to(o2, o1.shape[1], o1.shape[2]))
        levels = [ssh(o) for ssh, o in zip(self.ssh, (o1, o2, o3))]
        outs = []
        for name, ch in _HEADS:
            ys = [head(feat) for head, feat in zip(self.heads[name], levels)]
            outs.append(torch.cat([y.reshape(y.shape[0], -1, ch) for y in ys], dim=1))
        return tuple(outs)


# ---------------------------------------------------------------------------
# Weights from the public checkpoint. BN is folded into a scale/shift pair.
# ---------------------------------------------------------------------------

def _fold_bn(sd, prefix, eps=1e-5):
    g = np.asarray(sd[f"{prefix}.weight"], np.float32)
    b = np.asarray(sd[f"{prefix}.bias"], np.float32)
    m = np.asarray(sd[f"{prefix}.running_mean"], np.float32)
    v = np.asarray(sd[f"{prefix}.running_var"], np.float32)
    inv = g / np.sqrt(v + eps)
    return inv, b - m * inv


def from_torch(state_dict, cfg: RetinaFaceConfig = RETINAFACE_R50) -> dict[str, torch.Tensor]:
    """The Pytorch_Retinaface `Resnet50_Final.pth` state dict (body.* of a
    torchvision ResNet-50, fpn.outputN / fpn.mergeN, sshN.conv3X3 /
    conv5X5_1 / conv5X5_2 / conv7X7_2 / conv7x7_3 (also spelled conv7X7_3),
    ClassHead.N / BboxHead.N / LandmarkHead.N .conv1x1; a 'module.' prefix
    dropped) -> a state dict for `RetinaFace(cfg)` (load with strict=True),
    each BatchNorm folded into its conv's scale and shift."""
    sd = {}
    for k, v in state_dict.items():
        if hasattr(v, "detach"):
            v = v.detach().float().cpu().numpy()
        sd[k[7:] if k.startswith("module.") else k] = np.asarray(v)
    out = {}

    def conv_bn(dst, conv_p, bn_p):
        out[dst + ".weight"] = np.asarray(sd[conv_p + ".weight"], np.float32)
        out[dst + ".scale"], out[dst + ".shift"] = _fold_bn(sd, bn_p)

    conv_bn("stem", "body.conv1", "body.bn1")
    for s, n in enumerate(cfg.stage_blocks):
        for i in range(n):
            src, dst = f"body.layer{s + 1}.{i}", f"stages.{s}.{i}"
            for j in (1, 2, 3):
                conv_bn(f"{dst}.conv{j}", f"{src}.conv{j}", f"{src}.bn{j}")
            if src + ".downsample.0.weight" in sd:
                conv_bn(dst + ".down", src + ".downsample.0", src + ".downsample.1")
    for name in ("output1", "output2", "output3", "merge1", "merge2"):
        conv_bn(f"fpn.{name}", f"fpn.{name}.0", f"fpn.{name}.1")
    for n in range(3):
        p = f"ssh{n + 1}"
        for name in ("conv3X3", "conv5X5_1", "conv5X5_2", "conv7X7_2", "conv7x7_3"):
            src = f"{p}.{name}"
            if name == "conv7x7_3" and src + ".0.weight" not in sd:
                src = f"{p}.conv7X7_3"
            conv_bn(f"ssh.{n}.{name}", src + ".0", src + ".1")
    for name, _ in _HEADS:
        for i in range(3):
            out[f"heads.{name}.{i}.weight"] = sd[f"{name}.{i}.conv1x1.weight"]
            out[f"heads.{name}.{i}.bias"] = sd[f"{name}.{i}.conv1x1.bias"]
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}


def from_onnx(path: str, cfg: RetinaFaceConfig = RETINAFACE_R50) -> dict[str, torch.Tensor]:
    """From an ONNX export whose initializers kept the torch module names
    (the standard torch.onnx export); raises with the names found
    otherwise, so that a rename map can be supplied."""
    from adaprompt_tpu_torch.utils.onnx_port import read_onnx_initializers
    init = read_onnx_initializers(path)
    if not any(k.startswith(("body.conv1", "module.body.conv1")) for k in init):
        raise ValueError(
            "ONNX initializers don't carry Pytorch_Retinaface module names; "
            f"found e.g. {sorted(init)[:15]}. Supply a rename map and call from_torch().")
    return from_torch(init, cfg)


def load(path: str, cfg: RetinaFaceConfig = RETINAFACE_R50, *, device=None) -> RetinaFace:
    """A RetinaFace from a `.pth` (or other `utils/torch_port` format) or
    `.onnx` file, on `device` (CUDA unless told otherwise)."""
    from adaprompt_tpu_torch.pipeline import resolve_device
    device = resolve_device(device)
    if path.endswith(".onnx"):
        state = from_onnx(path, cfg)
    else:
        from adaprompt_tpu_torch.utils.torch_port import load_state_dict
        state = from_torch(load_state_dict(path), cfg)
    model = RetinaFace(cfg, device=device)
    model.load_state_dict(state, strict=True)
    return model.eval()


# ---------------------------------------------------------------------------
# Anchors, decode, NMS (on the host)
# ---------------------------------------------------------------------------

def priors(h, w, cfg: RetinaFaceConfig = RETINAFACE_R50) -> np.ndarray:
    """Anchor centers/sizes [N, 4] (cx, cy, sx, sy) normalized to [0, 1],
    in Pytorch_Retinaface's PriorBox order: levels outer, rows, cols, then
    min_sizes inner."""
    out = []
    for stride, sizes in zip(cfg.strides, cfg.min_sizes):
        fh, fw = -(-h // stride), -(-w // stride)
        ii, jj = np.mgrid[0:fh, 0:fw]
        cx = (jj + 0.5) * stride / w
        cy = (ii + 0.5) * stride / h
        per_size = [np.stack([cx, cy, np.full_like(cx, s / w), np.full_like(cy, s / h)], axis=-1)
                    for s in sizes]
        out.append(np.stack(per_size, axis=2).reshape(-1, 4))   # [fh, fw, A, 4]
    return np.concatenate(out, axis=0).astype(np.float32)


def decode_boxes(loc, pri, variances=(0.1, 0.2)) -> np.ndarray:
    """SSD-style decode to (x0, y0, x1, y1) normalized."""
    loc = np.asarray(loc, np.float32)
    cxy = pri[:, :2] + loc[:, :2] * variances[0] * pri[:, 2:]
    wh = pri[:, 2:] * np.exp(loc[:, 2:] * variances[1])
    return np.concatenate([cxy - wh / 2, cxy + wh / 2], axis=1)


def decode_landms(ldm, pri, variances=(0.1, 0.2)) -> np.ndarray:
    """-> [N, 5, 2] normalized landmark coordinates."""
    ldm = np.asarray(ldm, np.float32).reshape(-1, 5, 2)
    return pri[:, None, :2] + ldm * variances[0] * pri[:, None, 2:]


def nms(boxes, scores, iou_thresh=0.4) -> list[int]:
    """Plain hard NMS (the reference's py_cpu_nms)."""
    x0, y0, x1, y1 = boxes.T
    areas = np.maximum(x1 - x0, 0) * np.maximum(y1 - y0, 0)
    order = np.argsort(scores)[::-1]
    keep = []
    while order.size:
        i = order[0]
        keep.append(int(i))
        xx0 = np.maximum(x0[i], x0[order[1:]])
        yy0 = np.maximum(y0[i], y0[order[1:]])
        xx1 = np.minimum(x1[i], x1[order[1:]])
        yy1 = np.minimum(y1[i], y1[order[1:]])
        inter = np.maximum(xx1 - xx0, 0) * np.maximum(yy1 - yy0, 0)
        iou = inter / (areas[i] + areas[order[1:]] - inter + 1e-12)
        order = order[1:][iou <= iou_thresh]
    return keep


def canvas(image_np: np.ndarray, det_size: int = 640):
    """RGB uint8 [H, W, 3] -> (the float32 [det_size, det_size, 3] input:
    nearest-resized so that its longer side is det_size, BGR, minus the
    means, zero-padded at the bottom and right; the scale)."""
    img = np.asarray(image_np)
    h, w = img.shape[:2]
    scale = det_size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    idy = np.clip((np.arange(nh) / scale).astype(np.int64), 0, h - 1)
    idx = np.clip((np.arange(nw) / scale).astype(np.int64), 0, w - 1)
    out = np.zeros((det_size, det_size, 3), np.float32)
    out[:nh, :nw] = img[idy][:, idx][..., ::-1]        # RGB -> BGR
    out -= BGR_MEANS
    return out, scale


@torch.no_grad()
def head_outputs(model: RetinaFace, canvases: np.ndarray):
    """float32 canvases [B, S, S, 3] -> (face probabilities [B, N], boxes
    [B, N, 4], landmarks [B, N, 10]) as host float32 arrays; the forward and
    the softmax run on the model's device."""
    p = model.stem.weight
    logits, loc, ldm = model(torch.from_numpy(np.ascontiguousarray(canvases)).to(
        device=p.device, dtype=p.dtype))
    probs = torch.softmax(logits.float(), dim=-1)[..., 1]
    return probs.cpu().numpy(), loc.float().cpu().numpy(), ldm.float().cpu().numpy()


def decode_detections(probs, loc, ldm, image_hw, scale, cfg: RetinaFaceConfig = RETINAFACE_R50,
                      score_thresh: float = 0.5, iou_thresh: float = 0.4, det_size: int = 640):
    """One canvas's head outputs (probs [N], loc [N, 4], ldm [N, 10]) ->
    (boxes [K, 4] pixel xyxy clipped to the photo, scores [K], landms
    [K, 5, 2] pixel), score-descending, after the threshold and NMS."""
    h, w = image_hw
    pri = priors(det_size, det_size, cfg)
    keep0 = probs > score_thresh
    if not keep0.any():
        return (np.zeros((0, 4), np.float32), np.zeros((0,), np.float32),
                np.zeros((0, 5, 2), np.float32))
    boxes = decode_boxes(loc[keep0], pri[keep0], cfg.variances)
    landms = decode_landms(ldm[keep0], pri[keep0], cfg.variances)
    scores = probs[keep0]
    keep = nms(boxes, scores, iou_thresh)
    boxes, scores, landms = boxes[keep], scores[keep], landms[keep]
    boxes = boxes * det_size / scale                   # back to the photo's pixels
    landms = landms * det_size / scale
    boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w)
    boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h)
    return boxes, scores, landms


def detect_faces(model: RetinaFace, image_np: np.ndarray, score_thresh: float = 0.5,
                 iou_thresh: float = 0.4, det_size: int = 640):
    """The detection chain on one RGB uint8 photo: `canvas`, `head_outputs`,
    `decode_detections`. Returns (boxes [K, 4] pixel xyxy, scores [K],
    landms [K, 5, 2] pixel), score-descending."""
    img = np.asarray(image_np)
    x, scale = canvas(img, det_size)
    probs, loc, ldm = head_outputs(model, x[None])
    return decode_detections(probs[0], loc[0], ldm[0], img.shape[:2], scale, model.cfg,
                             score_thresh, iou_thresh, det_size)
