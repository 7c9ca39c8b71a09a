"""CLIP text transformer (the SD-1.5 conditioning encoder).

Port of `adaprompt_tpu/models/clip_text.py`: `encode` with an optional
`inputs_embeds` injection point, the causal mask, and clip-skip weights
over the last N pre-final-LN hidden states (normalized to sum to 1 over the
layers). Parameters mirror the JAX pytree (see convert.from_jax_params).

The K/V multiplier ("MKV") attention of AdaFace's `prompt2token_proj`: a
layer whose k and v projections are m times wider ([D*m, D]) folds the m
copies into a key sequence of S*m, each key position's mask repeated m
times. `extend_attention_mkv` widens layers so; `from_torch` reads the HF
`text_model.*` layout and `match_kv_widths` sizes a model's layers to a
state dict's.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from adaprompt_tpu_torch.ops.attention import causal_mask, dot_product_attention
from adaprompt_tpu_torch.ops.layers import Linear, Norm, layer_norm, quick_gelu
from adaprompt_tpu_torch.utils.torch_port import layer_names, renamed


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

    # read outside the model's methods (a splice embeds its tokens itself):
    # parallel/mesh.py's shard_params keeps them whole
    whole_leaves = ("token_embedding", "position_embedding")

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

    def match_kv_widths(self, state: dict, prefix: str = "") -> "CLIPTextModel":
        """Give each layer k and v projections as wide as `state`'s (a state
        dict of this model under `prefix`), so that it loads strictly."""
        for i, lp in enumerate(self.layers):
            for name in ("k", "v"):
                old = lp["attn"][name]
                rows = state[f"{prefix}layers.{i}.attn.{name}.weight"].shape[0]
                if rows != old.weight.shape[0]:
                    lp["attn"][name] = _widened(old, rows)
        return self

    def _self_attn(self, p, x, mask):
        b, s, d = x.shape
        nh = self.cfg.num_heads
        q = p["q"](x).reshape(b, s, nh, d // nh)
        k, v = p["k"](x), p["v"](x)
        # K/V multiplier: [B, S, D*m] holds m copies of each key position
        m = k.shape[-1] // d
        k = k.reshape(b, s * m, nh, d // nh)
        v = v.reshape(b, s * m, nh, d // nh)
        if m > 1:
            mask = mask.repeat_interleave(m, dim=-1)
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


def _widened(old: Linear, rows: int) -> Linear:
    """A k/v projection of `rows` outputs on `old`'s device and dtype, as
    trainable as `old` (its values to be loaded or copied in)."""
    w = old.weight
    new = Linear(w.shape[1], rows, init_std=0.02, device=w.device, dtype=w.dtype)
    return new.requires_grad_(w.requires_grad)


@torch.no_grad()
def extend_attention_mkv(model: CLIPTextModel, multiplier: int = 2, noise_std: float = 0.1,
                         begin_layer: int = -1, end_layer: int = -1, *,
                         generator: torch.Generator | None = None,
                         noise=None) -> CLIPTextModel:
    """Widen the k/v projections of layers [begin_layer, end_layer) (-1: no
    bound) by `multiplier`, in place: the weight is stacked with
    multiplier - 1 noised copies, each w + N(0, 1) * noise_std * (the mean
    over inputs of the standard deviation over outputs of w), and the bias
    repeated unperturbed. The standard-normal draws come from `generator`,
    or from `noise(layer, name, copy)` (a tensor of the weight's shape,
    name "k" or "v") when given."""
    for i, lp in enumerate(model.layers):
        if (begin_layer >= 0 and i < begin_layer) or (end_layer >= 0 and i >= end_layer):
            continue
        for name in ("k", "v"):
            old = lp["attn"][name]
            w = old.weight
            rel = w.std(dim=0, unbiased=False).mean()
            reps = [w]
            for r in range(multiplier - 1):
                z = (noise(i, name, r) if noise is not None else
                     torch.randn(w.shape, generator=generator, device=w.device, dtype=w.dtype))
                reps.append(w + z.to(w) * (noise_std * rel))
            new = _widened(old, w.shape[0] * multiplier)
            new.weight.copy_(torch.cat(reps, dim=0))
            new.bias.copy_(old.bias.repeat(multiplier))
            lp["attn"][name] = new
    return model


def from_torch(state_dict, cfg: CLIPTextConfig = SD15_TEXT_CONFIG) -> dict[str, torch.Tensor]:
    """A transformers CLIPTextModel state dict (keys under 'text_model.',
    or without it) -> a state dict for `CLIPTextModel(cfg)`. The layouts
    agree, so only the names change; K/V-widened k_proj/v_proj ([D*m, D])
    keep their width (`match_kv_widths` sizes the model to it). Entries no
    parameter reads (`position_ids`) are left out."""
    sd = {k.removeprefix("text_model."): v for k, v in state_dict.items()}
    names = {"token_embedding": "embeddings.token_embedding.weight",
             "position_embedding": "embeddings.position_embedding.weight"}
    pairs = [("final_ln", "final_layer_norm")]
    for i in range(cfg.num_layers):
        src, dst = f"encoder.layers.{i}", f"layers.{i}"
        pairs += [(f"{dst}.ln1", f"{src}.layer_norm1"), (f"{dst}.ln2", f"{src}.layer_norm2"),
                  (f"{dst}.mlp.fc1", f"{src}.mlp.fc1"), (f"{dst}.mlp.fc2", f"{src}.mlp.fc2")]
        pairs += [(f"{dst}.attn.{n}", f"{src}.self_attn.{n}_proj") for n in ("q", "k", "v", "out")]
    return renamed(sd, {**names, **layer_names(pairs, sd)})
