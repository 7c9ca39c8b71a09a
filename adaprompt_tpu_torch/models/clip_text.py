"""CLIP text transformer (the SD-1.5 conditioning encoder).

Port of `adaprompt_tpu/models/clip_text.py`: `encode` with an optional
`inputs_embeds` injection point, the causal mask, and clip-skip weights
over the last N pre-final-LN hidden states (normalized to sum to 1 over the
layers). Parameters mirror the JAX pytree (see convert.from_jax_params).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from adaprompt_tpu_torch.ops.attention import causal_mask, dot_product_attention
from adaprompt_tpu_torch.ops.layers import Linear, Norm, layer_norm, quick_gelu


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_positions: int = 77
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407


SD15_TEXT_CONFIG = CLIPTextConfig()  # openai/clip-vit-large-patch14 text tower


class CLIPTextModel(nn.Module):
    """Weights: token/position embeddings, `layers[i]` = {ln1, attn{q,k,v,out},
    ln2, mlp{fc1, fc2}}, final_ln. Random init: normal(0, 0.02) weights,
    zero biases, unit norms."""

    def __init__(self, cfg: CLIPTextConfig = SD15_TEXT_CONFIG, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        d, i = cfg.hidden_size, cfg.intermediate_size
        lin = lambda cin, cout: Linear(cin, cout, init_std=0.02, **kw)
        self.token_embedding = nn.Parameter(torch.empty(cfg.vocab_size, d, **kw),
                                            requires_grad=False)
        self.position_embedding = nn.Parameter(torch.empty(cfg.max_positions, d, **kw),
                                               requires_grad=False)
        self.layers = nn.ModuleList(
            nn.ModuleDict({
                "ln1": Norm(d, **kw),
                "attn": nn.ModuleDict({n: lin(d, d) for n in ("q", "k", "v", "out")}),
                "ln2": Norm(d, **kw),
                "mlp": nn.ModuleDict({"fc1": lin(d, i), "fc2": lin(i, d)}),
            }) for _ in range(cfg.num_layers))
        self.final_ln = Norm(d, **kw)

    def reset(self, gen: torch.Generator):
        """Random-init the embeddings (layers.reset_parameters does the rest)."""
        self.token_embedding.normal_(0.0, 0.02, generator=gen)
        self.position_embedding.normal_(0.0, 0.02, generator=gen)

    def _self_attn(self, p, x, mask):
        b, s, d = x.shape
        nh = self.cfg.num_heads
        q = p["q"](x).reshape(b, s, nh, d // nh)
        k = p["k"](x).reshape(b, s, nh, d // nh)
        v = p["v"](x).reshape(b, s, nh, d // nh)
        o = dot_product_attention(q, k, v, mask=mask, use_flash=False)
        return p["out"](o.reshape(b, s, d))

    def encode(self, input_ids: torch.Tensor, *,
               inputs_embeds: torch.Tensor | None = None,
               hidden_state_layer_weights=None,
               return_pooled: bool = False):
        """input_ids [B, S] -> last hidden state [B, S, D] after the final LN
        (and the EOS-pooled [B, D] with return_pooled)."""
        cfg = self.cfg
        if inputs_embeds is None:
            inputs_embeds = self.token_embedding[input_ids]
        seq_len = inputs_embeds.shape[1]
        x = inputs_embeds + self.position_embedding[None, :seq_len]
        mask = causal_mask(seq_len, x.dtype, x.device)

        n_skip = 0
        if hidden_state_layer_weights is not None:
            w = torch.as_tensor(hidden_state_layer_weights, device=x.device)
            n_skip = w.shape[0]
        collected = []
        eps = cfg.layer_norm_eps
        for i, lp in enumerate(self.layers):
            # hidden_states[i] (the input of layer i) is collected; the last
            # entry is the final layer's output, appended below
            if n_skip and i >= cfg.num_layers - n_skip + 1:
                collected.append(x)
            h = layer_norm(x, lp["ln1"].weight, lp["ln1"].bias, eps)
            x = x + self._self_attn(lp["attn"], h, mask)
            h = layer_norm(x, lp["ln2"].weight, lp["ln2"].bias, eps)
            x = x + lp["mlp"]["fc2"](quick_gelu(lp["mlp"]["fc1"](h)))

        if n_skip:
            collected.append(x)
            stacked = torch.stack(collected)                  # [N, B, S, D]
            w = w.to(stacked.dtype)
            if w.ndim == 1:
                w = w[:, None]
            w = w / w.sum(dim=0, keepdim=True)                # normalize over layers
            x = (stacked * w[:, None, None, :]).sum(dim=0)

        x = layer_norm(x, self.final_ln.weight, self.final_ln.bias, eps)
        if return_pooled:
            if cfg.eos_token_id == 2:
                eos_idx = input_ids.argmax(dim=-1)            # legacy: highest id
            else:
                eos_idx = (input_ids == cfg.eos_token_id).int().argmax(dim=-1)
            return x, x[torch.arange(x.shape[0], device=x.device), eos_idx]
        return x
