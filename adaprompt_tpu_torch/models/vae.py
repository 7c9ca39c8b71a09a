"""SD-1.5 VAE (AutoencoderKL), NHWC at its public functions.

Port of `adaprompt_tpu/models/vae.py`: `decode`, `encode` and
`sample_latent`, with the encoder's optional fg/bg attention mask. The
mid-block attention is single-head over all positions (4096 at 512x512,
C=512); the JAX package computes it as a plain einsum and so does the port.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from adaprompt_tpu_torch.ops.layers import Conv2d, Norm, group_norm

SD_SCALE_FACTOR = 0.18215


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    ch: int = 128
    ch_mult: tuple = (1, 2, 4, 4)
    num_res_blocks: int = 2
    in_channels: int = 3
    out_channels: int = 3
    z_channels: int = 4
    embed_dim: int = 4
    double_z: bool = True

    @property
    def num_resolutions(self):
        return len(self.ch_mult)


SD15_VAE_CONFIG = VAEConfig()


def _res(cin, cout, kw):
    p = {"norm1": Norm(cin, **kw), "conv1": Conv2d(cin, cout, 3, **kw),
         "norm2": Norm(cout, **kw), "conv2": Conv2d(cout, cout, 3, **kw)}
    if cin != cout:
        p["nin_shortcut"] = Conv2d(cin, cout, 1, **kw)
    return nn.ModuleDict(p)


def _attn(c, kw):
    return nn.ModuleDict({"norm": Norm(c, **kw), "q": Conv2d(c, c, 1, **kw),
                          "k": Conv2d(c, c, 1, **kw), "v": Conv2d(c, c, 1, **kw),
                          "proj_out": Conv2d(c, c, 1, **kw)})


def _mid(c, kw):
    return nn.ModuleDict({"block_1": _res(c, c, kw), "attn_1": _attn(c, kw),
                          "block_2": _res(c, c, kw)})


class VAE(nn.Module):
    """Weights mirror the JAX pytree: encoder{conv_in, down[i]{block, downsample},
    mid, norm_out, conv_out}, decoder{conv_in, mid, up[i]{block, upsample},
    norm_out, conv_out}, quant_conv, post_quant_conv."""

    def __init__(self, cfg: VAEConfig = SD15_VAE_CONFIG, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        ch = cfg.ch

        in_mult = (1,) + tuple(cfg.ch_mult)
        down = []
        for i in range(cfg.num_resolutions):
            cin, cout = ch * in_mult[i], ch * cfg.ch_mult[i]
            blocks = []
            for _ in range(cfg.num_res_blocks):
                blocks.append(_res(cin, cout, kw))
                cin = cout
            lvl = {"block": nn.ModuleList(blocks)}
            if i != cfg.num_resolutions - 1:
                lvl["downsample"] = Conv2d(cout, cout, 3, **kw)
            down.append(nn.ModuleDict(lvl))
        block_in = ch * cfg.ch_mult[-1]
        enc_out = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.encoder = nn.ModuleDict({
            "conv_in": Conv2d(cfg.in_channels, ch, 3, **kw),
            "down": nn.ModuleList(down),
            "mid": _mid(block_in, kw),
            "norm_out": Norm(block_in, **kw),
            "conv_out": Conv2d(block_in, enc_out, 3, **kw),
        })

        up = []
        cin = block_in
        for i in reversed(range(cfg.num_resolutions)):
            cout = ch * cfg.ch_mult[i]
            blocks = []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(_res(cin, cout, kw))
                cin = cout
            lvl = {"block": nn.ModuleList(blocks)}
            if i != 0:
                lvl["upsample"] = Conv2d(cout, cout, 3, **kw)
            up.insert(0, nn.ModuleDict(lvl))
        self.decoder = nn.ModuleDict({
            "conv_in": Conv2d(cfg.z_channels, block_in, 3, **kw),
            "mid": _mid(block_in, kw),
            "up": nn.ModuleList(up),
            "norm_out": Norm(ch * cfg.ch_mult[0], **kw),
            "conv_out": Conv2d(ch * cfg.ch_mult[0], cfg.out_channels, 3, **kw),
        })
        self.quant_conv = Conv2d(2 * cfg.z_channels, 2 * cfg.embed_dim, 1, **kw)
        self.post_quant_conv = Conv2d(cfg.embed_dim, cfg.z_channels, 1, **kw)

    def encode(self, x: torch.Tensor, mask: dict | None = None):
        """Image [B, H, W, 3] in [-1, 1] -> (mean, logvar) each [B, H/8, W/8, 4]."""
        enc = self.encoder
        h = enc["conv_in"](x)
        for lvl in enc["down"]:
            for bp in lvl["block"]:
                h = _resblock(bp, h)
            if "downsample" in lvl:
                h = _downsample(lvl["downsample"], h)
        h = _resblock(enc["mid"]["block_1"], h)
        h = _attnblock(enc["mid"]["attn_1"], h, mask)
        h = _resblock(enc["mid"]["block_2"], h)
        h = group_norm(h, enc["norm_out"].weight, enc["norm_out"].bias, eps=1e-6,
                       activation="silu")
        h = enc["conv_out"](h)
        mean, logvar = self.quant_conv(h).chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latent [B, h, w, 4] (unscaled: already divided by SD_SCALE_FACTOR)
        -> image [B, 8h, 8w, 3]."""
        dec = self.decoder
        h = dec["conv_in"](self.post_quant_conv(z))
        h = _resblock(dec["mid"]["block_1"], h)
        h = _attnblock(dec["mid"]["attn_1"], h)
        h = _resblock(dec["mid"]["block_2"], h)
        for i in reversed(range(self.cfg.num_resolutions)):
            lvl = dec["up"][i]
            for bp in lvl["block"]:
                h = _resblock(bp, h)
            if "upsample" in lvl:
                h = lvl["upsample"](h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))
        h = group_norm(h, dec["norm_out"].weight, dec["norm_out"].bias, eps=1e-6,
                       activation="silu")
        return dec["conv_out"](h)


def sample_latent(mean: torch.Tensor, logvar: torch.Tensor,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """DiagonalGaussianDistribution.sample: mean + exp(logvar/2) * noise."""
    noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                        dtype=mean.dtype)
    return mean + torch.exp(0.5 * logvar) * noise


def _resblock(p, x):
    h = group_norm(x, p["norm1"].weight, p["norm1"].bias, eps=1e-6, activation="silu")
    h = p["conv1"](h)
    h = group_norm(h, p["norm2"].weight, p["norm2"].bias, eps=1e-6, activation="silu")
    h = p["conv2"](h)
    if "nin_shortcut" in p:
        x = p["nin_shortcut"](x)
    return x + h


def _attnblock(p, x, mask: dict | None = None):
    """Single-head self-attention over all positions. `mask`
    {'fg_mask': [B,H0,W0,1] or None, 'aug_mask': ...} zeroes the
    post-softmax attention between fg and bg pixels."""
    b, h, w, c = x.shape
    hn = group_norm(x, p["norm"].weight, p["norm"].bias, eps=1e-6)
    q = p["q"](hn).reshape(b, h * w, c)
    k = p["k"](hn).reshape(b, h * w, c)
    v = p["v"](hn).reshape(b, h * w, c)
    probs = torch.softmax((q.float() @ k.float().transpose(1, 2)) * c ** -0.5, dim=-1)
    if mask is not None and mask.get("fg_mask") is not None:
        fg = _resize_mask_nearest(mask["fg_mask"], (h, w))
        bg = 1.0 - fg
        aug = mask.get("aug_mask")
        if aug is not None:
            aug = _resize_mask_nearest(aug, (h, w))
            fg, bg = fg * aug, bg * aug
        fg2, bg2 = fg.reshape(b, h * w, 1), bg.reshape(b, h * w, 1)
        homo = ((fg2 @ fg2.transpose(1, 2)) > 0) | ((bg2 @ bg2.transpose(1, 2)) > 0)
        probs = torch.where(homo, probs, 0.0)
    out = (probs.to(v.dtype) @ v).reshape(b, h, w, c)
    return x + p["proj_out"](out)


def _resize_mask_nearest(m: torch.Tensor, size: tuple) -> torch.Tensor:
    """Nearest resize of [B, H0, W0, 1] masks, torch F.interpolate('nearest')
    index rule: src = floor(dst * H0 / H1)."""
    h0, w0 = m.shape[1], m.shape[2]
    h1, w1 = size
    rows = torch.floor(torch.arange(h1, device=m.device) * (h0 / h1)).long()
    cols = torch.floor(torch.arange(w1, device=m.device) * (w0 / w1)).long()
    return m[:, rows][:, :, cols]


def _downsample(p, x):
    # torch pads (left 0, right 1, top 0, bottom 1), then a VALID stride-2 conv
    return p(x, stride=2, padding=((0, 1), (0, 1)))
