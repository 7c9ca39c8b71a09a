"""SD-1.5 UNet for inference, NHWC, with per-layer cross-attention contexts.

Port of `adaprompt_tpu/models/unet.py` (forward for sampling). Structure:
model_channels 320, channel_mult (1,2,4,4), 2 ResBlocks a level, spatial
transformers at downsample factors {1,2,4} and in the middle block, 8 heads,
context_dim 768. 25 addressable layers (input 0-11, middle 12, output
13-24), 16 of them with cross-attention.

    context: [L, B, S, D] with L in {1, 16}: cross-attention layer `ca`
    reads context[min(ca, L-1)]; `context_k` optionally gives separate K
    contexts of the same shape.

Kernel dispatch is the JAX package's:
  * self-attention goes through `dot_product_attention` (the flash kernel
    at >= 512 query and >= 256 key tokens);
  * cross-attention takes the fused kernel when its K/V were hoisted by
    `precompute_cross_kv` and there are >= 512 query tokens;
  * the feed-forward takes the fused GEGLU kernel when `fused_eligible`.

Not in this slice (they raise NotImplementedError): activation capture,
conv-attention, DeepCache (`cache_depth`), ToMe, int8 and the fused
GroupNorm-SiLU-conv.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from adaprompt_tpu_torch.models.vae import _resize_mask_nearest
from adaprompt_tpu_torch.ops.attention import NEG_BIG, dot_product_attention, fused_cross_attention
from adaprompt_tpu_torch.ops.geglu import fused_eligible, geglu
from adaprompt_tpu_torch.ops.layers import Conv2d, Linear, Norm, gelu, group_norm, layer_norm, silu

_FUSED_CROSS_MIN_Q = 512


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: tuple = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attention_ds: tuple = (1, 2, 4)  # downsample factors with cross-attention
    num_heads: int = 8
    context_dim: int = 768
    # options of the JAX package that this slice does not port yet
    fused_conv: bool = False
    quant: str | None = None
    tome_ratio: float = 0.0

    @property
    def time_embed_dim(self):
        return self.model_channels * 4


SD15_UNET_CONFIG = UNetConfig()


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embeddings, cos-then-sin order."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def build_plan(cfg: UNetConfig):
    """(input_plan, middle, output_plan): static description of the blocks
    (kind 'conv'|'res'|'down', cin, cout, attn, up)."""
    ch = cfg.model_channels
    inp = [dict(kind="conv", cin=cfg.in_channels, cout=ch, attn=False)]
    skips = [ch]
    ds = 1
    cur = ch
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            out = mult * ch
            inp.append(dict(kind="res", cin=cur, cout=out, attn=ds in cfg.attention_ds))
            cur = out
            skips.append(cur)
        if level != len(cfg.channel_mult) - 1:
            inp.append(dict(kind="down", cin=cur, cout=cur, attn=False))
            skips.append(cur)
            ds *= 2
    mid = dict(kind="mid", ch=cur, attn=True)
    outp = []
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            out = ch * mult
            entry = dict(kind="res", cin=cur + skips.pop(), cout=out,
                         attn=ds in cfg.attention_ds,
                         up=bool(level and i == cfg.num_res_blocks))
            cur = out
            outp.append(entry)
            if entry["up"]:
                ds //= 2
    return inp, mid, outp


def layer_ca_map(inp_plan, out_plan) -> dict:
    """layer_idx -> cross-attention idx, numbering the attention layers in order."""
    l2ca = {}
    li = 0
    for e in inp_plan:
        if e.get("attn"):
            l2ca[li] = len(l2ca)
        li += 1
    l2ca[li] = len(l2ca)  # middle block
    li += 1
    for e in out_plan:
        if e.get("attn"):
            l2ca[li] = len(l2ca)
        li += 1
    return l2ca


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def _res(cin, cout, temb, kw):
    p = {"norm_in": Norm(cin, **kw), "conv_in": Conv2d(cin, cout, 3, **kw),
         "emb": Linear(temb, cout, **kw), "norm_out": Norm(cout, **kw),
         "conv_out": Conv2d(cout, cout, 3, zero_init=True, **kw)}
    if cin != cout:
        p["skip"] = Conv2d(cin, cout, 1, **kw)
    return nn.ModuleDict(p)


def _st(c, cfg, kw):
    def ca(ctx_dim):
        return nn.ModuleDict({"to_q": Linear(c, c, bias=False, **kw),
                              "to_k": Linear(ctx_dim, c, bias=False, **kw),
                              "to_v": Linear(ctx_dim, c, bias=False, **kw),
                              "to_out": Linear(c, c, **kw)})

    return nn.ModuleDict({
        "norm": Norm(c, **kw),
        "proj_in": Conv2d(c, c, 1, **kw),
        "block": nn.ModuleDict({
            "norm1": Norm(c, **kw), "attn1": ca(c),
            "norm2": Norm(c, **kw), "attn2": ca(cfg.context_dim),
            "norm3": Norm(c, **kw),
            "ff": nn.ModuleDict({"proj": Linear(c, c * 8, **kw),   # GEGLU: 2 * 4c
                                 "out": Linear(c * 4, c, **kw)}),
        }),
        "proj_out": Conv2d(c, c, 1, zero_init=True, **kw),
    })


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _resblock(p, x, emb):
    # GroupNorm32 -> SiLU -> conv; + time; GroupNorm32 -> SiLU -> conv (eps 1e-5)
    h = group_norm(x, p["norm_in"].weight, p["norm_in"].bias, eps=1e-5, activation="silu")
    h = p["conv_in"](h)
    e = p["emb"](silu(emb))
    h = h + e[:, None, None, :].to(h.dtype)
    h = group_norm(h, p["norm_out"].weight, p["norm_out"].bias, eps=1e-5, activation="silu")
    h = p["conv_out"](h)
    if "skip" in p:
        x = p["skip"](x)
    return x + h


def _cross_attention(p, x, ctx_v, ctx_k, num_heads, self_mask=None, kv=None):
    """LDM CrossAttention with separate V/K contexts (self-attention when
    ctx_v is None). self_mask [B, N] (1 = keep) masks self-attention keys;
    kv: K/V [B, S, H, hd] hoisted by precompute_cross_kv."""
    b, n, c = x.shape
    hd = c // num_heads
    scale = hd ** -0.5
    if kv is not None and n >= _FUSED_CROSS_MIN_Q:
        return fused_cross_attention(x, p["to_q"].weight, kv[0], kv[1],
                                     p["to_out"].weight, p["to_out"].bias, scale, num_heads)
    if ctx_v is None:
        ctx_v = ctx_k = x
    q = p["to_q"](x).reshape(b, n, num_heads, hd)
    if kv is not None:
        k, v = kv
    else:
        k = p["to_k"](ctx_k).reshape(b, -1, num_heads, hd)
        v = p["to_v"](ctx_v).reshape(b, -1, num_heads, hd)
    key_bias = None
    if self_mask is not None:
        key_bias = (self_mask.float() - 1.0) * (-NEG_BIG)   # keep -> 0, drop -> -1e9
    out = dot_product_attention(q, k, v, key_bias=key_bias, scale=scale)
    return p["to_out"](out.reshape(b, n, c))


def _geglu_ff(p, x):
    w1, b1 = p["proj"].weight, p["proj"].bias
    if fused_eligible(x, w1):
        return geglu(x, w1, b1, p["out"].weight, p["out"].bias)
    a, gate = p["proj"](x).chunk(2, dim=-1)
    return p["out"](a * gelu(gate))


def _spatial_transformer(p, x, ctx_v, ctx_k, num_heads, img_mask=None, kv=None):
    b, h, w, c = x.shape
    y = group_norm(x, p["norm"].weight, p["norm"].bias, eps=1e-6)
    y = p["proj_in"](y).reshape(b, h * w, c)
    bp = p["block"]
    self_mask = None
    if img_mask is not None:
        self_mask = _resize_mask_nearest(img_mask, (h, w)).reshape(b, h * w)
    ln = lambda t, norm: layer_norm(t, bp[norm].weight, bp[norm].bias)
    y = y + _cross_attention(bp["attn1"], ln(y, "norm1"), None, None, num_heads,
                             self_mask=self_mask)
    y = y + _cross_attention(bp["attn2"], ln(y, "norm2"), ctx_v, ctx_k, num_heads, kv=kv)
    y = y + _geglu_ff(bp["ff"], ln(y, "norm3"))
    y = p["proj_out"](y.reshape(b, h, w, c))
    return x + y


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

class UNet(nn.Module):
    """Weights mirror the JAX pytree: time_embed{fc1, fc2}, input_blocks[i],
    middle_block{res1, attn, res2}, output_blocks[i], out{norm, conv}."""

    def __init__(self, cfg: UNetConfig = SD15_UNET_CONFIG, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        if cfg.fused_conv or cfg.quant is not None or cfg.tome_ratio > 0:
            raise NotImplementedError("fused_conv, quant and ToMe are not ported yet")
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        inp, mid, outp = build_plan(cfg)
        self.l2ca = layer_ca_map(inp, outp)
        te = cfg.time_embed_dim

        def block(entry):
            if entry["kind"] == "conv":
                return nn.ModuleDict({"conv": Conv2d(entry["cin"], entry["cout"], 3, **kw)})
            if entry["kind"] == "down":
                return nn.ModuleDict({"downsample": Conv2d(entry["cin"], entry["cout"], 3, **kw)})
            p = {"res": _res(entry["cin"], entry["cout"], te, kw)}
            if entry["attn"]:
                p["attn"] = _st(entry["cout"], cfg, kw)
            if entry.get("up"):
                p["upsample"] = Conv2d(entry["cout"], entry["cout"], 3, **kw)
            return nn.ModuleDict(p)

        self.time_embed = nn.ModuleDict({"fc1": Linear(cfg.model_channels, te, **kw),
                                         "fc2": Linear(te, te, **kw)})
        self.input_blocks = nn.ModuleList(block(e) for e in inp)
        self.middle_block = nn.ModuleDict({"res1": _res(mid["ch"], mid["ch"], te, kw),
                                           "attn": _st(mid["ch"], cfg, kw),
                                           "res2": _res(mid["ch"], mid["ch"], te, kw)})
        self.output_blocks = nn.ModuleList(block(e) for e in outp)
        self.out = nn.ModuleDict({"norm": Norm(cfg.model_channels, **kw),
                                  "conv": Conv2d(cfg.model_channels, cfg.out_channels, 3,
                                                 zero_init=True, **kw)})

    def _attn2(self, layer_idx):
        n_inp = len(self.input_blocks)
        if layer_idx < n_inp:
            return self.input_blocks[layer_idx]["attn"]["block"]["attn2"]
        if layer_idx == n_inp:
            return self.middle_block["attn"]["block"]["attn2"]
        return self.output_blocks[layer_idx - n_inp - 1]["attn"]["block"]["attn2"]

    def precompute_cross_kv(self, context: torch.Tensor,
                            context_k: torch.Tensor | None = None) -> dict:
        """Hoist every cross-attention layer's K/V projection out of a
        sampler loop: {layer_idx: (k [B,S,H,hd], v [B,S,H,hd])}."""
        context = context if context.ndim == 4 else context[None]
        context_k = context if context_k is None else (
            context_k if context_k.ndim == 4 else context_k[None])
        L = context.shape[0]
        nh = self.cfg.num_heads
        out = {}
        for layer_idx, ca in self.l2ca.items():
            p = self._attn2(layer_idx)
            i = min(ca, L - 1)
            cv, ck = context[i], context_k[i]
            b = cv.shape[0]
            hd = p["to_k"].weight.shape[0] // nh
            out[layer_idx] = (p["to_k"](ck).reshape(b, -1, nh, hd),
                              p["to_v"](cv).reshape(b, -1, nh, hd))
        return out

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor, *,
                context_k: torch.Tensor | None = None,
                img_mask: torch.Tensor | None = None,
                cross_kv: dict | None = None,
                capture_ca: bool = False,
                conv_attn: dict | None = None,
                cache_depth: int = 0) -> torch.Tensor:
        """Predict epsilon. x [B, H, W, 4] NHWC; timesteps [B]; context
        [L, B, S, D] or [B, S, D]; img_mask [B, H0, W0, 1] restricts
        self-attention keys. Returns eps [B, H, W, 4]."""
        if capture_ca or conv_attn is not None or cache_depth:
            raise NotImplementedError("capture_ca, conv_attn and cache_depth are not ported yet")
        cfg = self.cfg
        context = context if context.ndim == 4 else context[None]
        context_k = context if context_k is None else (
            context_k if context_k.ndim == 4 else context_k[None])
        L = context.shape[0]

        t_emb = timestep_embedding(timesteps, cfg.model_channels).to(x.dtype)
        emb = self.time_embed["fc2"](silu(self.time_embed["fc1"](t_emb)))

        def ctx_for(layer_idx):
            ca = self.l2ca.get(layer_idx)
            if ca is None:
                return None, None
            i = min(ca, L - 1)
            return context[i], context_k[i]

        def run_block(bp, h, layer_idx):
            if "conv" in bp:
                return bp["conv"](h)
            if "downsample" in bp:
                return bp["downsample"](h, stride=2, padding=1)
            h = _resblock(bp["res"], h, emb)
            if "attn" in bp:
                cv, ck = ctx_for(layer_idx)
                kv = cross_kv.get(layer_idx) if cross_kv is not None else None
                h = _spatial_transformer(bp["attn"], h, cv, ck, cfg.num_heads,
                                         img_mask=img_mask, kv=kv)
            if "upsample" in bp:
                h = h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
                h = bp["upsample"](h)
            return h

        hs = []
        h = x
        for i, bp in enumerate(self.input_blocks):
            h = run_block(bp, h, i)
            hs.append(h)

        n_inp = len(self.input_blocks)
        mb = self.middle_block
        cv, ck = ctx_for(n_inp)
        kv = cross_kv.get(n_inp) if cross_kv is not None else None
        h = _resblock(mb["res1"], h, emb)
        h = _spatial_transformer(mb["attn"], h, cv, ck, cfg.num_heads, img_mask=img_mask, kv=kv)
        h = _resblock(mb["res2"], h, emb)

        for i, bp in enumerate(self.output_blocks):
            h = torch.cat([h, hs.pop()], dim=-1)
            h = run_block(bp, h, n_inp + 1 + i)

        h = group_norm(h, self.out["norm"].weight, self.out["norm"].bias, eps=1e-5,
                       activation="silu")
        return self.out["conv"](h)
