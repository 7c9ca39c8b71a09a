"""3x3 stride-1 SAME convolutions on NHWC activations, with an optional fused
GroupNorm-SiLU producer.

Port of `adaprompt_tpu/ops/conv_halo.py`. Three kernel wrappers (CUDA:
csrc/conv_halo.cu), each with a launch count and a plain PyTorch version
beside it; a wrapper takes the plain version for CPU tensors only and for
CUDA tensors launches its kernel or raises:
  * `gn_silu_conv3x3_halo` (replaces the TPU kernel of the same name):
    conv3x3(SiLU(GroupNorm(x))) + bias. One C call: a statistics kernel
    folds the GroupNorm into a per-(batch, channel) float32 affine (the JAX
    function's order, `gn_affine`), then B8's implicit GEMM (below) applies
    seg = float(x)*a + b, seg*sigmoid(seg) in float32 rounded to bf16 once
    to each staged halo, zero outside the image, before its nine taps. Plain
    version `gn_silu_conv3x3_halo_reference`, which repeats that arithmetic;
    it is not `layers.group_norm` + `conv2d`, which normalizes in the
    activation dtype and so rounds elsewhere.
  * `conv3x3_halo` (replaces `conv3x3_halo`): the conv alone as an implicit
    GEMM on mma.sync; per channel chunk a tile's halo is staged once and its
    nine taps are nine shifted windows of it. Plain version
    `conv3x3_halo_reference`.
  * `conv3x3_im2col` (replaces `conv3x3_im2col`): the same implicit GEMM with
    each k tile's patch rows (one tap, a chunk of channels) gathered straight
    from x into a cp.async ring. Plain version `conv3x3_im2col_reference`,
    written as the [B*H*W, 9C] x [9C, O] product.
All three are forward only, as the JAX functions are (no custom_vjp).
`conv_plan` splits the channel chunks where the tiles alone would leave SMs
idle, and the wrappers pad O (B8 and B9 also C) that is not a multiple of 8
with zeros (the kernels copy 16 bytes at a time).

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
import functools
from dataclasses import dataclass

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
    a = rsqrt(var + eps) * scale, b = bias - (mean * rsqrt(var + eps)) *
    scale (the JAX function's order), statistics in float32 (variance about
    the mean, not E[x^2] - mean^2)."""
    b, h, w, c = x.shape
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    rep = c // num_groups
    var, mean = torch.var_mean(x.reshape(b, h * w, num_groups, rep).float(), dim=(1, 3),
                               correction=0)
    inv = torch.rsqrt(var + eps)
    a = inv.repeat_interleave(rep, dim=1) * gn_scale.float()
    shift = gn_bias.float() - (mean * inv).repeat_interleave(rep, dim=1) * gn_scale.float()
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


def _operands(what, x, weight, bias, packed):
    """Checks shared by the three wrappers: x, the packed weight as kernel
    operands, the float32 bias, and (B, H, W, C, O)."""
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
    return x, packed, bias, (b, h, w, c, o)


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


# B8's and B9's tile (csrc/conv_halo.cu MmaTile): output pixels, output
# channels, the halo form's rows and columns; input channels a k chunk
TILE_PIXELS, TILE_CHANNELS, HALO_ROWS, HALO_COLS, CHUNK = 128, 160, 8, 16, 32
MAX_SPLITS = 4
H100_SMS = 132


@dataclass(frozen=True)
class ConvPlan:
    """How B8 or B9 covers a shape: the channel chunks in `splits` parts, and
    the kernel's grid (channel tiles, pixel tiles, splits)."""
    splits: int
    grid: tuple

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def conv_plan(form: str, b: int, h: int, w: int, c: int, o: int,
              sms: int = H100_SMS) -> ConvPlan:
    """B8's (`form` "halo") or B9's ("im2col") tiles, and as many k splits
    (at most 4, at most one a channel chunk) as make up to two blocks an SM:
    1 at SD-1.5's (64, 320, 320) at B=4 (256 tiles), 2 at (32, 640, 640)
    (128), 4 at (16, 1280, 1280) (64)."""
    if form == "im2col":
        tiles = -(-b * h * w // TILE_PIXELS)
    elif form == "halo":
        tiles = b * -(-h // HALO_ROWS) * -(-w // HALO_COLS)
    else:
        raise ValueError(f"conv_plan: form {form!r}")
    cols = -(-o // TILE_CHANNELS)
    splits = max(1, min(MAX_SPLITS, 2 * sms // (cols * tiles), -(-c // CHUNK)))
    return ConvPlan(splits, (cols, tiles, splits))


def _round8(n):
    return -(-n // 8) * 8


@functools.lru_cache(maxsize=None)
def _sm_count(device_index):
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _launch_mma(what, form, x, weight, bias, packed):
    """B8 or B9: C and O not multiples of 8 are padded with zeros (x's
    channels, the packed weight's rows and columns, the bias), the plan
    launched (with several splits on an fp32 workspace for their sums), the
    padded output columns dropped."""
    x, packed, bias, (b, h, w, c, o) = _operands(what, x, weight, bias, packed)
    cp, op = _round8(c), _round8(o)
    if cp != c:
        x = F.pad(x, (0, cp - c))
    if (cp, op) != (c, o):
        packed = F.pad(packed, (0, op - o, 0, cp - c))
        bias = F.pad(bias, (0, op - o))
    out = torch.empty((b, h, w, op), device=x.device, dtype=x.dtype)
    plan = conv_plan(form, b, h, w, cp, op, _sm_count(x.device.index))
    part = None
    if plan.splits > 1:
        part = torch.empty((plan.splits, b * h * w, op), device=x.device, dtype=torch.float32)
    fn_name = f"conv3x3_{form}_fwd"
    fn = cuda_build.function("conv_halo", fn_name, [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                             + [ctypes.c_void_p])
    cuda_build.check(fn(x.data_ptr(), packed.data_ptr(), bias.data_ptr(), out.data_ptr(),
                        None if part is None else part.data_ptr(), b, h, w, cp, op, plan.splits,
                        _stream(x)), fn_name)
    return out if op == o else out[..., :o].contiguous()


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _gn_conv_workspace_bytes(b, h, w, c, o, groups, splits) -> int:
    """The bytes of scratch `gn_silu_conv3x3_halo_fwd` takes at this shape
    (the [B, 2, C] affine, then the k splits' float32 sums), as the C side
    lays it out; asked of it once a shape."""
    fn = cuda_build.function("conv_halo", "gn_silu_conv_workspace", [_I] * 7 + [_P])
    nbytes = ctypes.c_longlong()
    cuda_build.check(fn(b, h, w, c, o, groups, splits, ctypes.addressof(nbytes)),
                     "gn_silu_conv_workspace")
    return nbytes.value


def gn_silu_conv_kernel_call(x, gn_scale, gn_bias, packed, bias, work, out, num_groups, eps,
                             splits):
    """B7's C call alone on operands the caller validated (x bf16, gn_scale,
    gn_bias and bias float32, `packed` [9, C, O] with O a multiple of 8, `work`
    a uint8 workspace of `_gn_conv_workspace_bytes`, out [B, H, W, O]): the
    statistics kernel, the fused conv and, with several splits, their sum.
    Not counted."""
    b, h, w, c = x.shape
    fn = cuda_build.function("conv_halo", "gn_silu_conv3x3_halo_fwd",
                             [_P] * 7 + [_I] * 6 + [ctypes.c_float, _I, _P])
    cuda_build.check(fn(x.data_ptr(), gn_scale.data_ptr(), gn_bias.data_ptr(), packed.data_ptr(),
                        bias.data_ptr(), out.data_ptr(), work.data_ptr(), b, h, w, c,
                        out.shape[-1], num_groups, eps, splits, _stream(x)),
                     "gn_silu_conv3x3_halo_fwd")


def _gn_params(what, gn_scale, gn_bias, c, device):
    """The GroupNorm's scale and shift as contiguous float32 [C] operands."""
    if gn_scale.shape != (c,) or gn_bias.shape != (c,):
        raise ValueError(f"{what}: gn_scale {tuple(gn_scale.shape)}, gn_bias "
                         f"{tuple(gn_bias.shape)} for C={c}")
    return [t.to(device=device, dtype=torch.float32).contiguous() for t in (gn_scale, gn_bias)]


def gn_affine_kernel(x, gn_scale, gn_bias, num_groups: int = 32, eps: float = 1e-5):
    """B7's statistics kernel alone on a bf16 CUDA x: `gn_affine`'s [B, 2, C]
    float32 affine. Not counted."""
    (x,) = cuda_build.kernel_operands("gn_affine kernel", x)
    b, h, w, c = x.shape
    gs, gb = _gn_params("gn_affine kernel", gn_scale, gn_bias, c, x.device)
    ab = torch.empty((b, 2, c), device=x.device, dtype=torch.float32)
    fn = cuda_build.function("conv_halo", "gn_silu_conv_stats",
                             [_P] * 4 + [_I] * 5 + [ctypes.c_float, _P])
    cuda_build.check(fn(x.data_ptr(), gs.data_ptr(), gb.data_ptr(), ab.data_ptr(), b, h, w, c,
                        num_groups, eps, _stream(x)), "gn_silu_conv_stats")
    return ab


def gn_silu_conv3x3_halo(x, gn_scale, gn_bias, weight, bias, *, num_groups: int = 32,
                         eps: float = 1e-5, packed: torch.Tensor | None = None):
    """conv3x3(SiLU(GroupNorm(x))) + bias, fused: x [B, H, W, C]; gn_scale,
    gn_bias [C]; weight OIHW [O, C, 3, 3]; bias [O]; `packed` =
    `pack_conv_weight(weight)` when the caller holds it. -> [B, H, W, O].
    On the card one C call takes the statistics and the conv (C must be a
    multiple of 8 and of num_groups; O is padded to a multiple of 8)."""
    if x.device.type == "cpu":
        return gn_silu_conv3x3_halo_reference(x, gn_scale, gn_bias, weight, bias,
                                              num_groups=num_groups, eps=eps)
    what = "gn_silu_conv3x3_halo kernel"
    _refuse_gradients(what, x, gn_scale, gn_bias, weight, bias)
    x, packed, bias, (b, h, w, c, o) = _operands(what, x, weight, bias, packed)
    if c % 8 or c % num_groups:
        raise ValueError(f"{what}: C={c} must be a multiple of 8 and of {num_groups} groups")
    gs, gb = _gn_params(what, gn_scale, gn_bias, c, x.device)
    op = _round8(o)
    if op != o:
        packed = F.pad(packed, (0, op - o))
        bias = F.pad(bias, (0, op - o))
    splits = conv_plan("halo", b, h, w, c, op, _sm_count(x.device.index)).splits
    work = torch.empty(_gn_conv_workspace_bytes(b, h, w, c, op, num_groups, splits),
                       dtype=torch.uint8, device=x.device)
    out = torch.empty((b, h, w, op), device=x.device, dtype=x.dtype)
    gn_silu_conv_kernel_call(x, gs, gb, packed, bias, work, out, num_groups, eps, splits)
    gn_silu_conv3x3_halo.launches += 1
    return out if op == o else out[..., :o].contiguous()


gn_silu_conv3x3_halo.launches = 0


def conv3x3_halo(x, weight, bias, *, packed: torch.Tensor | None = None):
    """3x3 stride-1 SAME conv + bias as nine tap products: x [B, H, W, C];
    weight OIHW; bias [O]. -> [B, H, W, O]."""
    if x.device.type == "cpu":
        return conv3x3_halo_reference(x, weight, bias)
    out = _launch_mma("conv3x3_halo kernel", "halo", x, weight, bias, packed)
    conv3x3_halo.launches += 1
    return out


conv3x3_halo.launches = 0


def conv3x3_im2col(x, weight, bias, *, packed: torch.Tensor | None = None):
    """The same conv with each k tile's patch rows (one tap, a chunk of
    channels) gathered from x into shared memory. Arguments as
    `conv3x3_halo`."""
    if x.device.type == "cpu":
        return conv3x3_im2col_reference(x, weight, bias)
    out = _launch_mma("conv3x3_im2col kernel", "im2col", x, weight, bias, packed)
    conv3x3_im2col.launches += 1
    return out


conv3x3_im2col.launches = 0
