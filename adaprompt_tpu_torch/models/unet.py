"""SD-1.5 UNet, NHWC, with per-layer cross-attention contexts.

Port of `adaprompt_tpu/models/unet.py`: the forward of sampling and of
training, where the weights are frozen and gradients flow to the context
(and, through `img_mask`, the self-attention key bias masks dropped pixels).
Structure:
model_channels 320, channel_mult (1,2,4,4), 2 ResBlocks a level, spatial
transformers at downsample factors {1,2,4} and in the middle block, 8 heads,
context_dim 768. 25 addressable layers (input 0-11, middle 12, output
13-24), 16 of them with cross-attention.

    context: [L, B, S, D] with L in {1, 16}: cross-attention layer `ca`
    reads context[min(ca, L-1)]; `context_k` optionally gives separate K
    contexts of the same shape.

Kernel dispatch is the JAX package's:
  * self-attention goes through `dot_product_attention` (the flash kernel
    at >= 512 query and >= 256 key tokens, in the form that
    `UNetConfig.flash_variant` picks: the one-chain natural-log kernels by
    default, else the two-chain or no-max forward and/or the exp2 forms);
  * cross-attention takes the fused kernel when its K/V were hoisted by
    `precompute_cross_kv` and there are >= 512 query tokens (under
    `quant="int8"` its w8a8 variant);
  * the feed-forward takes the fused GEGLU kernel when `fused_eligible`;
    under `quant="int8"` the w8a8 kernel when `fused_int8_eligible` (C=320
    and C=640), and otherwise (C=1280) the unfused bf16 linears.
  * under `fused_conv`, a ResBlock's GroupNorm-SiLU-conv3x3 takes the fused
    kernel where `conv_halo.fused_conv_eligible` (bf16 and one of three
    (H, C, O) shapes: 9 of a full-width pass's 44 ResBlock convs at 64x64
    latents); every other conv stays GroupNorm + cuDNN. Forward only.
Every other projection stays in the compute dtype under `quant="int8"`,
as the JAX package's `_qlinear` keeps it. The int8 weights come from
`quantize_int8`, and the fused convs' repacked weights from
`pack_fused_conv_weights`, each made once per sampler loop and passed as
`int8_weights` / `fused_conv_weights`.

The serving accelerations of the JAX package (all sampler-only):
  * ToMe (`tome_ratio`, ops/tome.py) merges tokens in the transformer
    blocks of >= `tome_min_tokens` tokens, for self-attention and the
    feed-forward by default, never for cross-attention; it is off for the
    whole forward under `img_mask`;
  * DeepCache (`cache_depth`, `cache`): a full pass also returns the hidden
    state entering output block n_out - depth (before its skip concat); a
    shallow pass given that cache runs only input blocks [0:depth] and
    output blocks [n_out-depth:].

Gradient rematerialization (`use_checkpoint`, on by default as in the JAX
package) checkpoints each block with `torch.utils.checkpoint` whenever
autograd records: the backward recomputes the whole block's forward. The
JAX package's default policy (`dots_saveable`) keeps the matmul outputs
instead; both give the same numbers. Full-block recompute is the simpler of
the two in PyTorch (no per-op save policy over the kernels' ctypes calls)
and holds the least memory; it costs one more forward of each block.
Over a device mesh the recompute gathers the block's sharded weights
(`parallel/mesh.py`), as the forward gathered the model's.

Training semantics of the recon iterations, as in the JAX package:
  * `capture_ca=True` returns, beside eps, the cross-attention activations
    of the layers in DISTILL_LAYER_INDICES (7, 8, 12, 16-24): "q" (scaled
    by sqrt(scale), [B, H, N, hd]), "attn" and "attnscore" ([B, H, N, 77]
    fp32 probabilities and logits) and "outfeat" (the block's output,
    Upsample included; after res2 in the middle block). Under block
    recompute the captures are outputs of the checkpointed function, never
    side effects;
  * `conv_attn` replaces the subject tokens' score columns by a
    convolutional attention (ops/conv_attn.py), with the JAX gating: an int
    kernel size is forced to 1 on cross-attention layers 6-10, a dict gives
    one size a layer.
A cross-attention layer that captures or takes conv-attention computes its
logits in fp32 from the compute-dtype q and k, the softmax in fp32 and P.V
in the compute dtype (plain PyTorch: 77 keys, as in both packages'
training); self-attention keeps the flash kernels with the key bias.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from adaprompt_tpu_torch.models.vae import _resize_mask_nearest
from adaprompt_tpu_torch.ops import conv_halo, tome
from adaprompt_tpu_torch.ops.conv_attn import replace_rows_by_conv_attn
from adaprompt_tpu_torch.ops.attention import (NEG_BIG, FlashVariant, dot_product_attention,
                                               fused_cross_attention, fused_cross_attention_int8)
from adaprompt_tpu_torch.ops.geglu import fused_eligible, fused_int8_eligible, geglu, geglu_int8
from adaprompt_tpu_torch.ops.layers import Conv2d, Linear, Norm, gelu, group_norm, layer_norm, silu
from adaprompt_tpu_torch.ops.quant import quantize_weight
from adaprompt_tpu_torch.parallel import mesh as mesh_mod
from adaprompt_tpu_torch.utils.torch_port import layer_names, renamed

_FUSED_CROSS_MIN_Q = 512
# the layers whose cross-attention activations feed the recon and
# distillation regularizers
DISTILL_LAYER_INDICES = (7, 8, 12, 16, 17, 18, 19, 20, 21, 22, 23, 24)


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
    use_checkpoint: bool = True
    # "int8": the w8a8 fused cross-attention and GEGLU kernels (forward only)
    quant: str | None = None
    # ToMe in the transformer blocks with >= tome_min_tokens tokens: merge
    # `tome_ratio` of the tokens for self-attention / cross-attention / FF
    tome_ratio: float = 0.0
    tome_min_tokens: int = 4096
    tome_attn: bool = True
    tome_cross: bool = False
    tome_mlp: bool = False
    # the fused GroupNorm-SiLU-conv3x3 kernel in the ResBlocks, for the
    # shapes of conv_halo._FUSED_TABLE (bf16 only, forward only)
    fused_conv: bool = False
    # the form of the flash kernels that self-attention takes (the JAX
    # package's ADAPROMPT_FLASH_EXP2 / _ILV / _NOMAX switches)
    flash_variant: FlashVariant = FlashVariant()

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


def resblock_conv_shapes(cfg: UNetConfig, latent_size: int) -> list:
    """(H, C, O) of every ResBlock 3x3 conv of one full pass over square
    latents of `latent_size`, in execution order (conv_in then conv_out of
    each ResBlock: 44 at SD-1.5's plan). Under `fused_conv` the bf16 ones
    found in conv_halo._FUSED_TABLE take the fused kernel."""
    inp, mid, outp = build_plan(cfg)
    h, shapes = latent_size, []
    for e in inp:
        if e["kind"] == "res":
            shapes += [(h, e["cin"], e["cout"]), (h, e["cout"], e["cout"])]
        elif e["kind"] == "down":
            h //= 2
    shapes += [(h, mid["ch"], mid["ch"])] * 4
    for e in outp:
        shapes += [(h, e["cin"], e["cout"]), (h, e["cout"], e["cout"])]
        if e["up"]:
            h *= 2
    return shapes


def from_torch(state_dict, cfg: UNetConfig = SD15_UNET_CONFIG) -> dict[str, torch.Tensor]:
    """An openaimodel UNetModel state dict (keys under
    'model.diffusion_model.' as in an SD checkpoint, or without it) -> a
    state dict for `UNet(cfg)`, the blocks found by `build_plan`. The
    layouts agree (SD-1.5's proj_in and proj_out are 1x1 convs here too), so
    only the names change."""
    sd = {k.removeprefix("model.diffusion_model.").removeprefix("diffusion_model."): v
          for k, v in state_dict.items()}
    pairs = [("time_embed.fc1", "time_embed.0"), ("time_embed.fc2", "time_embed.2"),
             ("out.norm", "out.0"), ("out.conv", "out.2")]

    def res(dst, src):
        pairs.extend([(dst + ".norm_in", src + ".in_layers.0"),
                      (dst + ".conv_in", src + ".in_layers.2"),
                      (dst + ".emb", src + ".emb_layers.1"),
                      (dst + ".norm_out", src + ".out_layers.0"),
                      (dst + ".conv_out", src + ".out_layers.3")])
        if src + ".skip_connection.weight" in sd:
            pairs.append((dst + ".skip", src + ".skip_connection"))

    def st(dst, src):
        b, tb = dst + ".block", src + ".transformer_blocks.0"
        pairs.extend([(dst + ".norm", src + ".norm"), (dst + ".proj_in", src + ".proj_in"),
                      (dst + ".proj_out", src + ".proj_out"),
                      (b + ".ff.proj", tb + ".ff.net.0.proj"), (b + ".ff.out", tb + ".ff.net.2")])
        pairs.extend((f"{b}.norm{n}", f"{tb}.norm{n}") for n in (1, 2, 3))
        for a in ("attn1", "attn2"):
            pairs.extend((f"{b}.{a}.to_{n}", f"{tb}.{a}.to_{n}") for n in ("q", "k", "v"))
            pairs.append((f"{b}.{a}.to_out", f"{tb}.{a}.to_out.0"))

    inp, _, outp = build_plan(cfg)
    for i, e in enumerate(inp):
        p = f"input_blocks.{i}"
        if e["kind"] == "conv":
            pairs.append((p + ".conv", p + ".0"))
        elif e["kind"] == "down":
            pairs.append((p + ".downsample", p + ".0.op"))
        else:
            res(p + ".res", p + ".0")
            if e["attn"]:
                st(p + ".attn", p + ".1")
    res("middle_block.res1", "middle_block.0")
    st("middle_block.attn", "middle_block.1")
    res("middle_block.res2", "middle_block.2")
    for i, e in enumerate(outp):
        p = f"output_blocks.{i}"
        res(p + ".res", p + ".0")
        if e["attn"]:
            st(p + ".attn", p + ".1")
        if e.get("up"):
            pairs.append((p + ".upsample", f"{p}.{2 if e['attn'] else 1}.conv"))
    return renamed(sd, layer_names(pairs, sd))


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

def _resblock(p, x, emb, fused_weights=None):
    """GroupNorm32 -> SiLU -> conv; + time; GroupNorm32 -> SiLU -> conv (eps
    1e-5). fused_weights: {conv module: packed weight} under fused_conv
    (`UNet.pack_fused_conv_weights`), else None."""
    def gn_silu_conv(v, norm, conv):
        # per-conv dispatch: the fused kernel for the shapes of conv_halo._FUSED_TABLE
        if fused_weights is not None and conv_halo.fused_conv_eligible(v, conv.weight.shape[0]):
            return conv_halo.gn_silu_conv3x3_halo(v, norm.weight, norm.bias, conv.weight,
                                                  conv.bias, packed=fused_weights.get(conv))
        return conv(group_norm(v, norm.weight, norm.bias, eps=1e-5, activation="silu"))

    h = gn_silu_conv(x, p["norm_in"], p["conv_in"])
    e = p["emb"](silu(emb))
    h = h + e[:, None, None, :].to(h.dtype)
    h = gn_silu_conv(h, p["norm_out"], p["conv_out"])
    if "skip" in p:
        x = p["skip"](x)
    return x + h


def _cross_attention(p, x, ctx_v, ctx_k, num_heads, self_mask=None, kv=None, qw=None,
                     flash_variant=FlashVariant(), capture=False, conv_attn=None,
                     infeat_size=None):
    """LDM CrossAttention with separate V/K contexts (self-attention when
    ctx_v is None). self_mask [B, N] (1 = keep) masks self-attention keys;
    kv: K/V [B, S, H, hd] hoisted by precompute_cross_kv; qw: the int8
    ((wq_q, wq_s), (wo_q, wo_s)) of the quant="int8" path; flash_variant:
    the form of the flash kernels where the dispatch rule takes them (the
    77-key cross-attention never does); conv_attn: {"subj_pos" [BS, M],
    "kernel_size", "mix_weight"} of this layer, over the (h, w) =
    infeat_size map. Returns (out, {"q", "attn", "attnscore"} when
    capture, else None)."""
    b, n, c = x.shape
    hd = c // num_heads
    scale = hd ** -0.5
    if kv is not None and not capture and conv_attn is None and n >= _FUSED_CROSS_MIN_Q:
        if qw is not None:
            (wq_q, wq_s), (wo_q, wo_s) = qw
            return fused_cross_attention_int8(x, wq_q, wq_s, kv[0], kv[1], wo_q, wo_s,
                                              p["to_out"].bias, scale, num_heads), None
        return fused_cross_attention(x, p["to_q"].weight, kv[0], kv[1],
                                     p["to_out"].weight, p["to_out"].bias, scale,
                                     num_heads), None
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
    use_conv_attn = conv_attn is not None and conv_attn["kernel_size"] > 1
    if capture or use_conv_attn:
        # fp32 logits from the compute-dtype q and k (exact products, fp32 sums)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
        if key_bias is not None:
            logits = logits + key_bias[:, None, None, :]
        if use_conv_attn:
            logits = replace_rows_by_conv_attn(
                logits, q.transpose(1, 2).float(), k.transpose(1, 2).float(),
                conv_attn["subj_pos"], infeat_size, conv_attn["kernel_size"], scale,
                conv_attn_mix_weight=conv_attn.get("mix_weight", 1.0))
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v).reshape(b, n, c)
        cached = None
        if capture:
            cached = {"q": q.transpose(1, 2) * math.sqrt(scale), "attn": probs,
                      "attnscore": logits}
        return p["to_out"](out), cached
    out = dot_product_attention(q, k, v, key_bias=key_bias, scale=scale, variant=flash_variant)
    return p["to_out"](out.reshape(b, n, c)), None


def _geglu_ff(p, x, qw=None):
    """GEGLU feed-forward; qw: the int8 ((w1_q, w1_s), (w2_q, w2_s)) of the
    quant="int8" path, where only `fused_int8_eligible` layers go int8."""
    w1, b1 = p["proj"].weight, p["proj"].bias
    if qw is not None:
        if fused_int8_eligible(x, w1):
            (w1_q, w1_s), (w2_q, w2_s) = qw
            return geglu_int8(x, w1_q, w1_s, b1, w2_q, w2_s, p["out"].bias)
    elif fused_eligible(x, w1):
        return geglu(x, w1, b1, p["out"].weight, p["out"].bias)
    a, gate = p["proj"](x).chunk(2, dim=-1)
    return p["out"](a * gelu(gate))


def _spatial_transformer(p, x, ctx_v, ctx_k, num_heads, img_mask=None, kv=None, qw=None,
                         tome_cfg=None, flash_variant=FlashVariant(), capture=False,
                         conv_attn=None):
    """qw: this block's int8 weights {"cross", "ff"} (quant="int8");
    tome_cfg: the UNetConfig whose ToMe options apply, when ToMe is on;
    flash_variant: the flash kernels' form in self-attention; capture and
    conv_attn: the cross-attention's. Returns (out, the cross-attention's
    captures or None)."""
    b, h, w, c = x.shape
    y = group_norm(x, p["norm"].weight, p["norm"].bias, eps=1e-6)
    y = p["proj_in"](y).reshape(b, h * w, c)
    bp = p["block"]
    self_mask = None
    if img_mask is not None:
        self_mask = _resize_mask_nearest(img_mask, (h, w)).reshape(b, h * w)
    ident = (lambda t: t, lambda t: t)
    (m_a, u_a), (m_c, u_c), (m_f, u_f) = ident, ident, ident
    if tome_cfg is not None and h * w >= tome_cfg.tome_min_tokens > 0:
        merge, unmerge, _ = tome.build_merge(y, h, w, tome_cfg.tome_ratio)
        pick = lambda on: (merge, unmerge) if on else ident
        (m_a, u_a), (m_c, u_c), (m_f, u_f) = (pick(tome_cfg.tome_attn),
                                              pick(tome_cfg.tome_cross),
                                              pick(tome_cfg.tome_mlp))
    qw = qw or {}
    ln = lambda t, norm: layer_norm(t, bp[norm].weight, bp[norm].bias)
    a1, _ = _cross_attention(bp["attn1"], m_a(ln(y, "norm1")), None, None, num_heads,
                             self_mask=self_mask, flash_variant=flash_variant)
    y = y + u_a(a1)
    a2, cached = _cross_attention(bp["attn2"], m_c(ln(y, "norm2")), ctx_v, ctx_k, num_heads,
                                  kv=kv, qw=qw.get("cross"), capture=capture,
                                  conv_attn=conv_attn, infeat_size=(h, w))
    y = y + u_c(a2)
    y = y + u_f(_geglu_ff(bp["ff"], m_f(ln(y, "norm3")), qw=qw.get("ff")))
    y = p["proj_out"](y.reshape(b, h, w, c))
    return x + y, cached


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def _check_options(cfg: UNetConfig):
    if cfg.quant not in (None, "int8"):
        raise ValueError(f"unknown quant {cfg.quant!r}")


class UNet(nn.Module):
    """Weights mirror the JAX pytree: time_embed{fc1, fc2}, input_blocks[i],
    middle_block{res1, attn, res2}, output_blocks[i], out{norm, conv}."""

    def __init__(self, cfg: UNetConfig = SD15_UNET_CONFIG, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        _check_options(cfg)
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

    def _block(self, layer_idx):
        """The transformer block (attn1, attn2, ff, norms) of a layer."""
        n_inp = len(self.input_blocks)
        if layer_idx < n_inp:
            return self.input_blocks[layer_idx]["attn"]["block"]
        if layer_idx == n_inp:
            return self.middle_block["attn"]["block"]
        return self.output_blocks[layer_idx - n_inp - 1]["attn"]["block"]

    def quantize_int8(self) -> dict:
        """The int8 weights of the quant="int8" path, made once per sampler
        loop: {layer_idx: {"cross": ((wq_q, wq_s), (wo_q, wo_s)),
        "ff": ((w1_q, w1_s), (w2_q, w2_s))}} (quant.quantize_weight). The
        C=1280 feed-forward weights are quantized too, though
        `fused_int8_eligible` never admits them."""
        q = lambda lin: quantize_weight(lin.weight)
        return {layer_idx: {"cross": (q(bp["attn2"]["to_q"]), q(bp["attn2"]["to_out"])),
                            "ff": (q(bp["ff"]["proj"]), q(bp["ff"]["out"]))}
                for layer_idx, bp in ((li, self._block(li)) for li in self.l2ca)}

    def _resblocks(self):
        for bp in [*self.input_blocks, *self.output_blocks]:
            if "res" in bp:
                yield bp["res"]
        yield self.middle_block["res1"]
        yield self.middle_block["res2"]

    def pack_fused_conv_weights(self) -> dict:
        """The repacked weights of the fused_conv path, made once per sampler
        loop: {conv module: [9, C, O] weight (conv_halo.pack_conv_weight)}
        for every ResBlock 3x3 conv whose (C, O) is in conv_halo._FUSED_TABLE
        at some H."""
        pairs = {(c, o) for _, c, o in conv_halo._FUSED_TABLE}
        return {conv: conv_halo.pack_conv_weight(conv.weight)
                for rp in self._resblocks() for conv in (rp["conv_in"], rp["conv_out"])
                if (conv.weight.shape[1], conv.weight.shape[0]) in pairs}

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
            p = self._block(layer_idx)["attn2"]
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
                cache_depth: int = 0,
                cache: torch.Tensor | None = None,
                int8_weights: dict | None = None,
                fused_conv_weights: dict | None = None,
                cfg: UNetConfig | None = None):
        """Predict epsilon. x [B, H, W, 4] NHWC; timesteps [B]; context
        [L, B, S, D] or [B, S, D]; img_mask [B, H0, W0, 1] restricts
        self-attention keys (and turns ToMe off). `cfg` overrides the
        model's options (quant, ToMe, fused_conv, flash_variant) for this call; under
        quant="int8", `int8_weights` from `quantize_int8`, and under
        fused_conv, `fused_conv_weights` from `pack_fused_conv_weights`
        (each made here when not given).

        capture_ca: also return the cross-attention activations of the
        DISTILL_LAYER_INDICES layers. conv_attn: {"subj_pos" [BS, M] token
        positions, "kernel_size" int or {layer_idx: int}, "mix_weight"}, the
        subject-token conv-attention of the cross-attention layers (an int
        size is forced to 1 on cross-attention layers 6-10).

        Returns eps [B, H, W, 4]; with capture_ca, (eps, {"q" | "attn" |
        "attnscore" | "outfeat": {layer_idx: tensor}}); with cache_depth >
        0, (eps, deep_cache): the cache a full pass (cache=None) leaves for
        the shallow passes, or the `cache` a shallow pass was given."""
        if capture_ca and cache_depth > 0:
            raise ValueError("deep-cache is a sampler-only fast path: no capture_ca with it")
        cfg = self.cfg if cfg is None else cfg
        _check_options(cfg)
        context = context if context.ndim == 4 else context[None]
        context_k = context if context_k is None else (
            context_k if context_k.ndim == 4 else context_k[None])
        L = context.shape[0]
        if cfg.quant == "int8" and int8_weights is None:
            int8_weights = self.quantize_int8()
        int8_weights = int8_weights or {}
        remat = cfg.use_checkpoint and torch.is_grad_enabled()
        if cfg.fused_conv:
            if remat and x.device.type != "cpu":
                raise RuntimeError("fused_conv is forward only (its kernel has no backward): "
                                   "call the UNet under torch.no_grad()")
            if fused_conv_weights is None:
                fused_conv_weights = self.pack_fused_conv_weights()
        else:
            fused_conv_weights = None
        # ToMe is sampler-only: a training forward (masked, capturing or with
        # conv-attention) turns it off throughout
        tome_cfg = (cfg if cfg.tome_ratio > 0 and img_mask is None and not capture_ca
                    and conv_attn is None else None)

        t_emb = timestep_embedding(timesteps, cfg.model_channels).to(x.dtype)
        emb = self.time_embed["fc2"](silu(self.time_embed["fc1"](t_emb)))

        def conv_attn_for(layer_idx):
            if conv_attn is None:
                return None
            ks = conv_attn["kernel_size"]
            if isinstance(ks, dict):
                ks = ks.get(layer_idx, 0)
            elif ks > 0 and self.l2ca.get(layer_idx) in (6, 7, 8, 9, 10):
                ks = 1     # 8x8 to 32x32 maps: too small for a conv head
            return {**conv_attn, "kernel_size": ks} if ks > 1 else None

        def transformer(p, h, layer_idx):
            ca = self.l2ca[layer_idx]
            i = min(ca, L - 1)
            kv = cross_kv.get(layer_idx) if cross_kv is not None else None
            return _spatial_transformer(p, h, context[i], context_k[i], cfg.num_heads,
                                        img_mask=img_mask, kv=kv,
                                        qw=int8_weights.get(layer_idx), tome_cfg=tome_cfg,
                                        flash_variant=cfg.flash_variant,
                                        capture=capture_ca and layer_idx in DISTILL_LAYER_INDICES,
                                        conv_attn=conv_attn_for(layer_idx))

        # each block returns (h, its captures or None): under block recompute
        # the captures are outputs of the checkpointed function
        def run_block(bp, h, layer_idx):
            if "conv" in bp:
                return bp["conv"](h), None
            if "downsample" in bp:
                return bp["downsample"](h, stride=2, padding=1), None
            h = _resblock(bp["res"], h, emb, fused_conv_weights)
            cached = None
            if "attn" in bp:
                h, cached = transformer(bp["attn"], h, layer_idx)
            if "upsample" in bp:
                h = h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
                h = bp["upsample"](h)
            if cached is not None:
                cached["outfeat"] = h          # after the whole block, Upsample included
            return h, cached

        def run_middle(mb, h, layer_idx):
            h = _resblock(mb["res1"], h, emb, fused_conv_weights)
            h, cached = transformer(mb["attn"], h, layer_idx)
            h = _resblock(mb["res2"], h, emb, fused_conv_weights)
            if cached is not None:
                cached["outfeat"] = h
            return h, cached

        captures = {}

        def call(fn, bp, h, layer_idx):
            if remat:
                h, cached = torch.utils.checkpoint.checkpoint(
                    fn, bp, h, layer_idx, use_reentrant=False,
                    context_fn=functools.partial(mesh_mod.recompute_context, bp))
            else:
                h, cached = fn(bp, h, layer_idx)
            if cached is not None:
                captures[layer_idx] = cached
            return h

        n_inp, n_out = len(self.input_blocks), len(self.output_blocks)
        shallow = cache is not None and cache_depth > 0
        hs = []
        h = x
        for i, bp in enumerate(self.input_blocks[:cache_depth] if shallow else self.input_blocks):
            h = call(run_block, bp, h, i)
            hs.append(h)

        if shallow:
            h = cache.to(x.dtype)
        else:
            h = call(run_middle, self.middle_block, h, n_inp)

        deep_cache = cache
        for i in range(n_out - cache_depth if shallow else 0, n_out):
            if cache_depth > 0 and not shallow and i == n_out - cache_depth:
                deep_cache = h
            h = torch.cat([h, hs.pop()], dim=-1)
            h = call(run_block, self.output_blocks[i], h, n_inp + 1 + i)

        h = group_norm(h, self.out["norm"].weight, self.out["norm"].bias, eps=1e-5,
                       activation="silu")
        eps = self.out["conv"](h)
        if capture_ca:
            return eps, {key: {li: c[key] for li, c in captures.items()}
                         for key in ("outfeat", "attn", "attnscore", "q")}
        return (eps, deep_cache) if cache_depth > 0 else eps
