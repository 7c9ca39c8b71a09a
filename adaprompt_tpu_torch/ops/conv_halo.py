"""3x3 stride-1 SAME convolutions on NHWC activations, with an optional fused
GroupNorm-SiLU producer.

Port of `adaprompt_tpu/ops/conv_halo.py`. Three kernel wrappers (CUDA:
csrc/conv_halo.cu), each with a launch count and a plain PyTorch version
beside it; a wrapper takes the plain version for CPU tensors only and for
CUDA tensors launches its kernel or raises:
  * `gn_silu_conv3x3_halo` (replaces the TPU kernel of the same name):
    conv3x3(SiLU(GroupNorm(x))) + bias. The statistics are taken in float32
    outside the kernel (`gn_affine`) and folded into a per-(batch, channel)
    affine; inside, seg = float(x)*a + b, seg*sigmoid(seg) in float32 rounded
    to the activation dtype, zero outside the image, nine tap products with
    float32 accumulation. Plain version `gn_silu_conv3x3_halo_reference`,
    which repeats that arithmetic; it is not `layers.group_norm` + `conv2d`,
    which normalizes in the activation dtype and so rounds elsewhere.
  * `conv3x3_halo` (replaces `conv3x3_halo`): the conv alone, nine tap
    products. Plain version `conv3x3_halo_reference`.
  * `conv3x3_im2col` (replaces `conv3x3_im2col`): the same conv as one
    product of depth 9*chunk over patches built on chip. Plain version
    `conv3x3_im2col_reference`, written as that [B*H*W, 9C] x [9C, O] product.
All three are forward only, as the JAX functions are (no custom_vjp).

Weights are the port's OIHW. The kernels read them taps-outermost,
[9, C, O] (`pack_conv_weight`; read as [9C, O] it is the im2col weight): a
caller in a loop packs once and passes `packed=`, as `UNet.forward` does
with `UNet.pack_fused_conv_weights`.

`fused_conv_eligible` keeps the JAX package's three (H, C, O) keys, so both
packages route the same ResBlock convs through the fused kernel; which
shapes pay on an H100 is to be measured (PERF.md).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from adaprompt_tpu_torch.ops import cuda_build

# (H, C, O) of the ResBlock convs that take the fused kernel under
# UNetConfig.fused_conv: the JAX package's table, keys only
_FUSED_TABLE: set = {(64, 320, 320), (32, 320, 640), (32, 960, 640)}


def fused_conv_eligible(x: torch.Tensor, cout: int, num_groups: int = 32) -> bool:
    """bf16 NHWC, square, channels divisible into the groups, and (H, C, O)
    in the table. The device is not asked: the wrapper picks kernel or plain
    version."""
    return (x.dtype == torch.bfloat16 and x.ndim == 4 and x.shape[1] == x.shape[2]
            and (x.shape[1], x.shape[3], cout) in _FUSED_TABLE
            and x.shape[3] % num_groups == 0)


def pack_conv_weight(weight: torch.Tensor) -> torch.Tensor:
    """OIHW [O, C, 3, 3] -> taps outermost [9, C, O] (tap = 3*dy + dx), contiguous."""
    o, c, kh, kw = weight.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"3x3 conv weight expected, got {tuple(weight.shape)}")
    return weight.permute(2, 3, 1, 0).reshape(9, c, o).contiguous()


def gn_affine(x, gn_scale, gn_bias, num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm of NHWC x as a per-(batch, channel) affine [B, 2, C] float32:
    a = scale * rsqrt(var + eps), b = bias - mean * a, statistics in float32
    (variance about the mean, not E[x^2] - mean^2)."""
    b, h, w, c = x.shape
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    rep = c // num_groups
    var, mean = torch.var_mean(x.reshape(b, h * w, num_groups, rep).float(), dim=(1, 3),
                               correction=0)
    inv = torch.rsqrt(var + eps)
    a = inv.repeat_interleave(rep, dim=1) * gn_scale.float()
    shift = gn_bias.float() - mean.repeat_interleave(rep, dim=1) * a
    return torch.stack([a, shift], dim=1)


def _conv_f32(x, weight, bias):
    """Float32 conv of NHWC x with an OIHW weight, zero SAME padding, bias
    added in float32; full float32 on a card too (no TF32)."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv2d(x.float().permute(0, 3, 1, 2), weight.float(), None, 1, 1)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return y.permute(0, 2, 3, 1) + bias.float()


def conv3x3_halo_reference(x, weight, bias):
    """Plain version: the conv with float32 accumulation, bias added in
    float32, cast to x's dtype."""
    return _conv_f32(x, weight, bias).to(x.dtype)


def conv3x3_im2col_reference(x, weight, bias):
    """Plain version in the kernel's form: the nine shifted views of the
    zero-padded x side by side, [B, H, W, 9C], times the [9C, O] weight."""
    b, h, w, c = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    patches = torch.cat([xp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)],
                        dim=-1)
    w2 = pack_conv_weight(weight).reshape(9 * c, -1).float()
    return (patches @ w2 + bias.float()).to(x.dtype)


def gn_silu_conv3x3_halo_reference(x, gn_scale, gn_bias, weight, bias, *,
                                   num_groups: int = 32, eps: float = 1e-5):
    """Plain version: float32 statistics as an affine, seg*sigmoid(seg) in
    float32 rounded to x's dtype, then the conv (whose zero padding pads
    the ACTIVATED tensor: the border sees 0, not silu(b))."""
    ab = gn_affine(x, gn_scale, gn_bias, num_groups, eps)
    seg = x.float() * ab[:, 0, None, None, :] + ab[:, 1, None, None, :]
    act = (seg * torch.sigmoid(seg)).to(x.dtype)
    return _conv_f32(act, weight, bias).to(x.dtype)


def _refuse_gradients(what, *tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: forward only (as the JAX package's)")


def _launch(what, fn_name, x, affine, weight, bias, packed):
    """Checks shared by the three wrappers, then the launch; returns out."""
    _refuse_gradients(what, x, weight, bias)
    if x.ndim != 4 or weight.ndim != 4 or weight.shape[1:] != (x.shape[3], 3, 3):
        raise ValueError(f"{what}: shapes x{tuple(x.shape)} weight{tuple(weight.shape)}")
    b, h, w, c = x.shape
    o = weight.shape[0]
    if packed is None:
        packed = pack_conv_weight(weight)
    if packed.shape != (9, c, o) or bias.shape != (o,):
        raise ValueError(f"{what}: packed weight {tuple(packed.shape)}, bias {tuple(bias.shape)}")
    x, packed = cuda_build.kernel_operands(what, x, packed)
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty((b, h, w, o), device=x.device, dtype=x.dtype)
    pointers = [x.data_ptr()]
    if affine is not None:
        (affine,) = cuda_build.kernel_operands(what, affine, dtype=torch.float32)
        pointers.append(affine.data_ptr())
    pointers += [packed.data_ptr(), bias.data_ptr(), out.data_ptr()]
    fn = cuda_build.function("conv_halo", fn_name, [ctypes.c_void_p] * len(pointers)
                             + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    cuda_build.check(fn(*pointers, b, h, w, c, o,
                        torch.cuda.current_stream(x.device).cuda_stream), fn_name)
    return out


def gn_silu_conv3x3_halo(x, gn_scale, gn_bias, weight, bias, *, num_groups: int = 32,
                         eps: float = 1e-5, packed: torch.Tensor | None = None):
    """conv3x3(SiLU(GroupNorm(x))) + bias, fused: x [B, H, W, C]; gn_scale,
    gn_bias [C]; weight OIHW [O, C, 3, 3]; bias [O]; `packed` =
    `pack_conv_weight(weight)` when the caller holds it. -> [B, H, W, O]."""
    if x.device.type == "cpu":
        return gn_silu_conv3x3_halo_reference(x, gn_scale, gn_bias, weight, bias,
                                              num_groups=num_groups, eps=eps)
    what = "gn_silu_conv3x3_halo kernel"
    _refuse_gradients(what, x, gn_scale, gn_bias, weight, bias)
    cuda_build.kernel_operands(what, x)            # a bf16 CUDA tensor, before any arithmetic
    affine = gn_affine(x, gn_scale, gn_bias, num_groups, eps)
    out = _launch(what, "gn_silu_conv3x3_halo_fwd", x, affine, weight, bias, packed)
    gn_silu_conv3x3_halo.launches += 1
    return out


gn_silu_conv3x3_halo.launches = 0


def conv3x3_halo(x, weight, bias, *, packed: torch.Tensor | None = None):
    """3x3 stride-1 SAME conv + bias as nine tap products: x [B, H, W, C];
    weight OIHW; bias [O]. -> [B, H, W, O]."""
    if x.device.type == "cpu":
        return conv3x3_halo_reference(x, weight, bias)
    out = _launch("conv3x3_halo kernel", "conv3x3_halo_fwd", x, None, weight, bias, packed)
    conv3x3_halo.launches += 1
    return out


conv3x3_halo.launches = 0


def conv3x3_im2col(x, weight, bias, *, packed: torch.Tensor | None = None):
    """The same conv as one product of depth 9*chunk over patches built in
    shared memory. Arguments as `conv3x3_halo`."""
    if x.device.type == "cpu":
        return conv3x3_im2col_reference(x, weight, bias)
    out = _launch("conv3x3_im2col kernel", "conv3x3_im2col_fwd", x, None, weight, bias, packed)
    conv3x3_im2col.launches += 1
    return out


conv3x3_im2col.launches = 0
