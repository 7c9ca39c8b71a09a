"""CLIP text transformer (openai/clip-vit-large-patch14's text tower), plain.

Pre-LN blocks with quick-GELU, a causal mask, the final LayerNorm, and the
two optional parts that AdaFace uses: the token embeddings given directly
(`inputs_embeds`, where a face vector or subject vectors are spliced in) and
clip-skip weights over the last N hidden states (the inputs of the last
N - 1 layers and the last layer's output, the weights normalized to sum to
one, before the final LayerNorm). A layer whose k and v projections are m
times wider than the model ([m D, D], AdaFace's K/V multiplier) attends over
m copies of every key position, each position's copies next to each other.
"""

from __future__ import annotations

import torch

from benchmark.reference import nn


def param_shapes(c: dict, prefix: str = "", kv_mult=None) -> list:
    """[(name, shape, init)] of the port's CLIPTextModel layout. c: hidden_size,
    intermediate_size, num_layers, vocab_size, max_positions; kv_mult: the
    K/V multiplier of each layer (1 by default)."""
    d, i = c["hidden_size"], c["intermediate_size"]
    kv_mult = kv_mult or [1] * c["num_layers"]
    out = [(prefix + "token_embedding", (c["vocab_size"], d), ("normal", 0.02)),
           (prefix + "position_embedding", (c["max_positions"], d), ("normal", 0.02))]
    for li in range(c["num_layers"]):
        p = f"{prefix}layers.{li}."
        m = kv_mult[li]
        for ln in ("ln1", "ln2"):
            out += [(p + ln + ".weight", (d,), ("one", 0.05)), (p + ln + ".bias", (d,), ("normal", 0.02))]
        for n, rows in (("q", d), ("k", m * d), ("v", m * d), ("out", d)):
            out += [(f"{p}attn.{n}.weight", (rows, d), ("normal", 0.02)),
                    (f"{p}attn.{n}.bias", (rows,), ("normal", 0.01))]
        out += [(p + "mlp.fc1.weight", (i, d), ("normal", 0.02)), (p + "mlp.fc1.bias", (i,), ("normal", 0.01)),
                (p + "mlp.fc2.weight", (d, i), ("normal", 0.02)), (p + "mlp.fc2.bias", (d,), ("normal", 0.01))]
    out += [(prefix + "final_ln.weight", (d,), ("one", 0.05)), (prefix + "final_ln.bias", (d,), ("normal", 0.02))]
    return out


def encode(w: dict, c: dict, embeds: torch.Tensor, prefix: str = "", skip_weights=None) -> torch.Tensor:
    """Token embeddings [B, S, D] -> the last hidden state after the final LN."""
    g = lambda n: w[prefix + n]
    s, d = embeds.shape[1], c["hidden_size"]
    heads = c["num_heads"]
    eps = c.get("layer_norm_eps", 1e-5)
    x = embeds + g("position_embedding")[:s][None]
    causal = torch.full((s, s), float("-inf"), device=x.device, dtype=x.dtype).triu(1)
    n_skip = 0 if skip_weights is None else skip_weights.shape[0]
    collected = []
    for li in range(c["num_layers"]):
        p = f"layers.{li}."
        if n_skip and li >= c["num_layers"] - n_skip + 1:
            collected.append(x)
        h = nn.layer_norm(x, g(p + "ln1.weight"), g(p + "ln1.bias"), eps)
        q = nn.linear(h, g(p + "attn.q.weight"), g(p + "attn.q.bias"))
        k = nn.linear(h, g(p + "attn.k.weight"), g(p + "attn.k.bias"))
        v = nn.linear(h, g(p + "attn.v.weight"), g(p + "attn.v.bias"))
        m = k.shape[-1] // d
        b = x.shape[0]
        k, v = k.reshape(b, s * m, d), v.reshape(b, s * m, d)
        mask = causal.repeat_interleave(m, dim=-1) if m > 1 else causal
        o = nn.attention(q, k, v, heads, mask=mask)
        x = x + nn.linear(o, g(p + "attn.out.weight"), g(p + "attn.out.bias"))
        h = nn.layer_norm(x, g(p + "ln2.weight"), g(p + "ln2.bias"), eps)
        h = nn.quick_gelu(nn.linear(h, g(p + "mlp.fc1.weight"), g(p + "mlp.fc1.bias")))
        x = x + nn.linear(h, g(p + "mlp.fc2.weight"), g(p + "mlp.fc2.bias"))
    if n_skip:
        collected.append(x)
        sw = skip_weights.to(x.dtype).reshape(n_skip, -1)
        sw = sw / sw.sum(dim=0, keepdim=True)
        x = (torch.stack(collected) * sw[:, None, None, :]).sum(dim=0)
    return nn.layer_norm(x, g("final_ln.weight"), g("final_ln.bias"), eps)
