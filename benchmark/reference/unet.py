"""SD-1.5 UNet (LDM's openaimodel UNetModel with SpatialTransformer), plain.

Structure as CompVis `v1-inference.yaml` states it: model_channels 320,
channel_mult (1, 2, 4, 4), 2 ResBlocks a level, transformers at downsample
factors 1, 2 and 4 and in the middle block, 8 heads, context_dim 768. A
ResBlock is GroupNorm32 (eps 1e-5) - SiLU - conv3x3, plus the time
embedding, GroupNorm32 - SiLU - conv3x3, with a 1x1 skip where the width
changes. A transformer is GroupNorm (eps 1e-6), a 1x1 proj_in, pre-LN self-
attention, cross-attention over the context and a GEGLU feed-forward, a 1x1
proj_out, and the residual. Weight names are the port's (`UNet.state_dict()`).
Activations are NCHW inside; the public functions take NHWC latents. An image
mask (training's padding mask) drops the masked pixels as self-attention keys
at every level: a nearest resize (source index floor(i * H0 / H)), and a bias
of -1e9 on the dropped keys' logits.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import nn


def plan(c: dict):
    """(input blocks, middle width, output blocks) as dicts of kind, cin, cout,
    attn, up."""
    ch = c["model_channels"]
    inp = [dict(kind="conv", cin=c["in_channels"], cout=ch, attn=False)]
    skips, ds, cur = [ch], 1, ch
    for level, mult in enumerate(c["channel_mult"]):
        for _ in range(c["num_res_blocks"]):
            inp.append(dict(kind="res", cin=cur, cout=mult * ch, attn=ds in c["attention_ds"]))
            cur = mult * ch
            skips.append(cur)
        if level != len(c["channel_mult"]) - 1:
            inp.append(dict(kind="down", cin=cur, cout=cur, attn=False))
            skips.append(cur)
            ds *= 2
    mid = cur
    outp = []
    for level, mult in list(enumerate(c["channel_mult"]))[::-1]:
        for i in range(c["num_res_blocks"] + 1):
            e = dict(kind="res", cin=cur + skips.pop(), cout=ch * mult, attn=ds in c["attention_ds"],
                     up=bool(level and i == c["num_res_blocks"]))
            cur = ch * mult
            outp.append(e)
            if e["up"]:
                ds //= 2
    return inp, mid, outp


def self_attention_layers(c: dict) -> list:
    """(downsample factor, width) of each transformer block in forward order."""
    inp, mid, outp = plan(c)
    ds, out = 1, []
    for e in inp:
        if e["kind"] == "down":
            ds *= 2
        elif e["attn"]:
            out.append((ds, e["cout"]))
    out.append((ds, mid))
    for e in outp:
        if e["attn"]:
            out.append((ds, e["cout"]))
        if e["up"]:
            ds //= 2
    return out


def param_shapes(c: dict) -> list:
    ch, te, ctx = c["model_channels"], 4 * c["model_channels"], c["context_dim"]
    out = []

    def conv(name, cin, cout, k):
        std = 1.0 / math.sqrt(3 * cin * k * k)    # the spread of uniform(+-1/sqrt(fan_in))
        out.extend([(name + ".weight", (cout, cin, k, k), ("normal", std)),
                    (name + ".bias", (cout,), ("normal", std))])

    def lin(name, cin, cout, bias=True):
        std = 1.0 / math.sqrt(3 * cin)
        out.append((name + ".weight", (cout, cin), ("normal", std)))
        if bias:
            out.append((name + ".bias", (cout,), ("normal", std)))

    def norm(name, n):
        out.extend([(name + ".weight", (n,), ("one", 0.05)), (name + ".bias", (n,), ("normal", 0.05))])

    def res(p, cin, cout):
        norm(p + ".norm_in", cin)
        conv(p + ".conv_in", cin, cout, 3)
        lin(p + ".emb", te, cout)
        norm(p + ".norm_out", cout)
        conv(p + ".conv_out", cout, cout, 3)
        if cin != cout:
            conv(p + ".skip", cin, cout, 1)

    def st(p, n):
        norm(p + ".norm", n)
        conv(p + ".proj_in", n, n, 1)
        b = p + ".block"
        for a, kv in (("attn1", n), ("attn2", ctx)):
            norm(f"{b}.norm{a[-1]}", n)
            lin(f"{b}.{a}.to_q", n, n, bias=False)
            lin(f"{b}.{a}.to_k", kv, n, bias=False)
            lin(f"{b}.{a}.to_v", kv, n, bias=False)
            lin(f"{b}.{a}.to_out", n, n)
        norm(b + ".norm3", n)
        lin(b + ".ff.proj", n, 8 * n)
        lin(b + ".ff.out", 4 * n, n)
        conv(p + ".proj_out", n, n, 1)

    lin("time_embed.fc1", ch, te)
    lin("time_embed.fc2", te, te)
    inp, mid, outp = plan(c)
    for i, e in enumerate(inp):
        p = f"input_blocks.{i}"
        if e["kind"] == "conv":
            conv(p + ".conv", e["cin"], e["cout"], 3)
        elif e["kind"] == "down":
            conv(p + ".downsample", e["cin"], e["cout"], 3)
        else:
            res(p + ".res", e["cin"], e["cout"])
            if e["attn"]:
                st(p + ".attn", e["cout"])
    res("middle_block.res1", mid, mid)
    st("middle_block.attn", mid)
    res("middle_block.res2", mid, mid)
    for i, e in enumerate(outp):
        p = f"output_blocks.{i}"
        res(p + ".res", e["cin"], e["cout"])
        if e["attn"]:
            st(p + ".attn", e["cout"])
        if e["up"]:
            conv(p + ".upsample", e["cout"], e["cout"], 3)
    norm("out.norm", ch)
    conv("out.conv", ch, c["out_channels"], 3)
    return out


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float64, device=t.device) / half)
    args = t.double()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1).float()


NEG_BIG = -1e9


def resize_mask(m: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest resize of [B, H0, W0, 1] masks to [B, h, w, 1]."""
    rows = torch.floor(torch.arange(h, device=m.device) * (m.shape[1] / h)).long()
    cols = torch.floor(torch.arange(w, device=m.device) * (m.shape[2] / w)).long()
    return m[:, rows][:, :, cols]


def forward(w: dict, c: dict, x: torch.Tensor, t: torch.Tensor, ctx: torch.Tensor,
            img_mask: torch.Tensor | None = None) -> torch.Tensor:
    """eps of NHWC latents x [B, H, W, 4] at timesteps t [B] under the context
    ctx [B, S, 768]; img_mask [B, H, W, 1] (1 = keep) -> NHWC eps."""
    heads = c["num_heads"]
    dt = ctx.dtype
    emb = timestep_embedding(t, c["model_channels"]).to(dt)
    emb = nn.linear(nn.silu(nn.linear(emb, w["time_embed.fc1.weight"], w["time_embed.fc1.bias"])),
                    w["time_embed.fc2.weight"], w["time_embed.fc2.bias"])

    def cv(p, h, **kw):
        return nn.conv(h, w[p + ".weight"], w[p + ".bias"], **kw)

    def gn_silu(p, h, eps):
        return nn.silu(nn.group_norm(h, w[p + ".weight"], w[p + ".bias"], eps))

    def res(p, h):
        y = cv(p + ".conv_in", gn_silu(p + ".norm_in", h, 1e-5))
        y = y + nn.linear(nn.silu(emb), w[p + ".emb.weight"], w[p + ".emb.bias"])[:, :, None, None]
        y = cv(p + ".conv_out", gn_silu(p + ".norm_out", y, 1e-5))
        if p + ".skip.weight" in w:
            h = cv(p + ".skip", h)
        return h + y

    def attn(p, y, kv, mask=None):
        q = nn.linear(y, w[p + ".to_q.weight"])
        k = nn.linear(kv, w[p + ".to_k.weight"])
        v = nn.linear(kv, w[p + ".to_v.weight"])
        return nn.linear(nn.attention(q, k, v, heads, mask=mask), w[p + ".to_out.weight"],
                         w[p + ".to_out.bias"])

    def st(p, h):
        b, n, hh, ww = h.shape
        y = cv(p + ".proj_in", nn.group_norm(h, w[p + ".norm.weight"], w[p + ".norm.bias"], 1e-6))
        y = y.reshape(b, n, hh * ww).transpose(1, 2)
        bp = p + ".block."
        ln = lambda v, k: nn.layer_norm(v, w[bp + k + ".weight"], w[bp + k + ".bias"])
        z = ln(y, "norm1")
        mask = None
        if img_mask is not None:
            keep = resize_mask(img_mask, hh, ww).reshape(b, 1, 1, hh * ww).to(z.dtype)
            mask = (1.0 - keep) * NEG_BIG
        y = y + attn(bp + "attn1", z, z, mask)
        y = y + attn(bp + "attn2", ln(y, "norm2"), ctx)
        a, gate = nn.linear(ln(y, "norm3"), w[bp + "ff.proj.weight"], w[bp + "ff.proj.bias"]).chunk(2, dim=-1)
        y = y + nn.linear(a * nn.gelu(gate), w[bp + "ff.out.weight"], w[bp + "ff.out.bias"])
        y = y.transpose(1, 2).reshape(b, n, hh, ww)
        return h + cv(p + ".proj_out", y)

    def block(p, e, h):
        if e["kind"] == "conv":
            return cv(p + ".conv", h)
        if e["kind"] == "down":
            return cv(p + ".downsample", h, stride=2, padding=1)
        h = res(p + ".res", h)
        if e["attn"]:
            h = st(p + ".attn", h)
        if e.get("up"):
            h = cv(p + ".upsample", h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3))
        return h

    inp, _, outp = plan(c)
    h = x.permute(0, 3, 1, 2).to(dt)
    hs = []
    for i, e in enumerate(inp):
        h = block(f"input_blocks.{i}", e, h)
        hs.append(h)
    h = res("middle_block.res1", h)
    h = st("middle_block.attn", h)
    h = res("middle_block.res2", h)
    for i, e in enumerate(outp):
        h = block(f"output_blocks.{i}", e, torch.cat([h, hs.pop()], dim=1))
    h = cv("out.conv", gn_silu("out.norm", h, 1e-5))
    return h.permute(0, 2, 3, 1)
