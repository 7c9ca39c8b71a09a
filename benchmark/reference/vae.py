"""SD-1.5 VAE (LDM's AutoencoderKL, `v1-inference.yaml`'s first stage), plain.

ch 128, ch_mult (1, 2, 4, 4), 2 ResBlocks a level in the encoder and 3 in the
decoder, GroupNorm32 (eps 1e-6) - SiLU - conv3x3 twice a ResBlock, a single-
head attention block over all positions in the middle, nearest upsampling.
Weight names are the port's (`VAE.state_dict()`); the decoder is what the
sampling path runs, the encoder what a training step runs (each stride-2
downsample pads one row and column at the bottom and right, as LDM's).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import nn

SD_SCALE_FACTOR = 0.18215


def param_shapes(c: dict) -> list:
    out = []

    def conv(name, cin, cout, k):
        std = 1.0 / math.sqrt(3 * cin * k * k)
        out.extend([(name + ".weight", (cout, cin, k, k), ("normal", std)),
                    (name + ".bias", (cout,), ("normal", std))])

    def norm(name, n):
        out.extend([(name + ".weight", (n,), ("one", 0.05)), (name + ".bias", (n,), ("normal", 0.05))])

    def res(p, cin, cout):
        norm(p + ".norm1", cin)
        conv(p + ".conv1", cin, cout, 3)
        norm(p + ".norm2", cout)
        conv(p + ".conv2", cout, cout, 3)
        if cin != cout:
            conv(p + ".nin_shortcut", cin, cout, 1)

    def mid(p, n):
        res(p + ".block_1", n, n)
        norm(p + ".attn_1.norm", n)
        for k in ("q", "k", "v", "proj_out"):
            conv(f"{p}.attn_1.{k}", n, n, 1)
        res(p + ".block_2", n, n)

    ch, mult, nres, z = c["ch"], c["ch_mult"], c["num_res_blocks"], c["z_channels"]
    levels = len(mult)
    in_mult = (1,) + tuple(mult)
    conv("encoder.conv_in", c["in_channels"], ch, 3)
    for i in range(levels):
        cin, cout = ch * in_mult[i], ch * mult[i]
        for j in range(nres):
            res(f"encoder.down.{i}.block.{j}", cin, cout)
            cin = cout
        if i != levels - 1:
            conv(f"encoder.down.{i}.downsample", cout, cout, 3)
    top = ch * mult[-1]
    mid("encoder.mid", top)
    norm("encoder.norm_out", top)
    conv("encoder.conv_out", top, 2 * z, 3)
    conv("decoder.conv_in", z, top, 3)
    mid("decoder.mid", top)
    cin = top
    ups = {}
    for i in reversed(range(levels)):
        cout = ch * mult[i]
        for j in range(nres + 1):
            ups.setdefault(i, []).append((f"decoder.up.{i}.block.{j}", cin, cout))
            cin = cout
        if i != 0:
            ups[i].append((f"decoder.up.{i}.upsample", cout, cout))
    for i in range(levels):          # the port registers up[0] first
        for name, a, b in ups[i]:
            if name.endswith("upsample"):
                conv(name, a, b, 3)
            else:
                res(name, a, b)
    norm("decoder.norm_out", ch * mult[0])
    conv("decoder.conv_out", ch * mult[0], c["out_channels"], 3)
    conv("quant_conv", 2 * z, 2 * c["embed_dim"], 1)
    conv("post_quant_conv", c["embed_dim"], z, 1)
    return out


def _blocks(w: dict):
    """(conv, gn_silu, res, attn) over the weights `w`, on NCHW activations."""
    def cv(p, h, **kw):
        return nn.conv(h, w[p + ".weight"], w[p + ".bias"], **kw)

    def gn_silu(p, h):
        return nn.silu(nn.group_norm(h, w[p + ".weight"], w[p + ".bias"], 1e-6))

    def res(p, h):
        y = cv(p + ".conv1", gn_silu(p + ".norm1", h))
        y = cv(p + ".conv2", gn_silu(p + ".norm2", y))
        if p + ".nin_shortcut.weight" in w:
            h = cv(p + ".nin_shortcut", h)
        return h + y

    def attn(p, h):
        b, n, hh, ww = h.shape
        y = nn.group_norm(h, w[p + ".norm.weight"], w[p + ".norm.bias"], 1e-6)
        q, k, v = (cv(f"{p}.{t}", y).reshape(b, n, hh * ww).transpose(1, 2) for t in "qkv")
        o = nn.attention(q, k, v, heads=1).transpose(1, 2).reshape(b, n, hh, ww)
        return h + cv(p + ".proj_out", o)
    return cv, gn_silu, res, attn


def encode(w: dict, c: dict, x: torch.Tensor) -> torch.Tensor:
    """NHWC images [B, H, W, 3] in [-1, 1] -> the posterior's mean [B, H/8, W/8, 4]
    (unscaled)."""
    cv, gn_silu, res, attn = _blocks(w)
    h = cv("encoder.conv_in", x.permute(0, 3, 1, 2))
    for i in range(len(c["ch_mult"])):
        for j in range(c["num_res_blocks"]):
            h = res(f"encoder.down.{i}.block.{j}", h)
        if i != len(c["ch_mult"]) - 1:
            h = cv(f"encoder.down.{i}.downsample", h, stride=2, padding=(0, 1, 0, 1))
    h = res("encoder.mid.block_1", h)
    h = attn("encoder.mid.attn_1", h)
    h = res("encoder.mid.block_2", h)
    h = cv("encoder.conv_out", gn_silu("encoder.norm_out", h))
    return cv("quant_conv", h)[:, :c["embed_dim"]].permute(0, 2, 3, 1)


def decode(w: dict, c: dict, z: torch.Tensor) -> torch.Tensor:
    """Unscaled NHWC latents [B, h, w, 4] -> NHWC images [B, 8h, 8w, 3] in about [-1, 1]."""
    cv, gn_silu, res, attn = _blocks(w)
    h = cv("decoder.conv_in", cv("post_quant_conv", z.permute(0, 3, 1, 2)))
    h = res("decoder.mid.block_1", h)
    h = attn("decoder.mid.attn_1", h)
    h = res("decoder.mid.block_2", h)
    for i in reversed(range(len(c["ch_mult"]))):
        for j in range(c["num_res_blocks"] + 1):
            h = res(f"decoder.up.{i}.block.{j}", h)
        if i != 0:
            h = cv(f"decoder.up.{i}.upsample", h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3))
    h = cv("decoder.conv_out", gn_silu("decoder.norm_out", h))
    return h.permute(0, 2, 3, 1)


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    return ((img.double() + 1.0) * 127.5).round().clamp(0, 255).to(torch.uint8)
