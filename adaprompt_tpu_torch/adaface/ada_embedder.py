"""Legacy dynamic per-layer embedders: AttentionalPooler / AdaEmbedding /
Embedding3d.

Port of `adaprompt_tpu/adaface/ada_embedder.py`, the reference's
non-zero-shot "Ada" path. Dormant there as in the JAX package: no trainer
builds it; a user migrating an old Ada checkpoint gets the math through
`ada_from_torch` + `ada_forward` (or `convert.from_jax_params` of a JAX
tree into `AdaEmbedder`, strict).

  * AttentionalPooler: per cross-attention (CA) layer, pools the UNet
    layer's input features into one fg and one bg vector. The CA layer's own
    to_k projects the static subject / bg probe embeddings into feature
    space as queries; keys and values are the layer features
    (v = x + LN(q_feat), head-scaled); the fg/bg scores are LoRA-reduced per
    head (the grouped 1x1 conv is a per-head einsum, never a conv),
    smoothed 0.5/0.5 with the head average, optionally image-masked
    (nearest resize, source pixel floor(i*S/s)), then softmaxed over the
    joint (fg/bg x patches) space, or per stream.
  * AdaEmbedding: per layer, cat(LN(fg), LN(bg)) and LN(time_emb[:td]) ->
    Linear -> K sets of r coefficients over K x r basis vectors (the first
    N rows the init words' pre_vecs; per sample under zero-shot) ->
    LayerNorm -> / sqrt(D) -> + the layer's bias.
  * Embedding3d: a [L, K, D] table with per-layer lookup and caching.

The modules hold the weights under the JAX tree's names (`poolers.i.lora_to_k`,
`coeff_w.i`, `coeff_b.i`, `basis_vecs`, `pre_vecs`, `bias`,
`cached_bg_weight`); the functions take the tree as a dict of tensors
(`module.params()`), as the JAX functions do. Weights are in PyTorch's
layouts: a pooler's LoRA weights [o, C/H] (the Conv1d kernel squeezed), the
coefficient map [r*K, d_in], the CA layer's to_k [C, D_ctx].

No kernel: at most 16 small matmuls a step on [B, HW, C] features, plain torch
on any device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from adaprompt_tpu_torch.adaface.gradient import grad_scale
from adaprompt_tpu_torch.ops.layers import layer_norm

# 25 UNet layers -> 16 conditioned CA layers
LAYER_IDX2CA = {1: 0, 2: 1, 4: 2, 5: 3, 7: 4, 8: 5, 12: 6, 16: 7,
                17: 8, 18: 9, 19: 10, 20: 11, 21: 12, 22: 13, 23: 14, 24: 15}
CA_INFEAT_DIMS = (320, 320, 640, 640, 1280, 1280, 1280, 1280,
                  1280, 1280, 640, 640, 640, 320, 320, 320)
POOLER_WEIGHTS = ("lora_to_k", "lora_to_fg_q", "lora_to_bg_q")


def _norm(x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, None, None)


# ---------------------------------------------------------------------------
# AttentionalPooler
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnPoolerConfig:
    feat_dim: int                      # C of the CA layer (320/640/1280)
    feat_reduction_ratio: int = 8      # lora_dim = C / ratio
    n_heads: int = 8
    infeat_grad_scale: float = 0.5     # 1.0 when owned by AdaEmbedding
    is_fgbg_competitive: bool = True

    @property
    def lora_dim(self) -> int:
        return self.feat_dim // self.feat_reduction_ratio


def _grouped_linear(x: torch.Tensor, w: torch.Tensor, n_heads: int) -> torch.Tensor:
    """torch Conv1d(C_in, C_out, 1, groups=H, bias=False) as a per-head
    linear. x [..., C_in]; w [C_out, C_in/H]. Returns [..., C_out]."""
    c_out, c_in_g = w.shape
    wg = w.reshape(n_heads, c_out // n_heads, c_in_g)                 # [H, o, c]
    xg = x.reshape(*x.shape[:-1], n_heads, c_in_g)                    # [..., H, c]
    out = torch.einsum("...hc,hoc->...ho", xg, wg.to(x.dtype))
    return out.reshape(*x.shape[:-1], c_out)


class AttentionalPooler(nn.Module):
    """The three LoRA weights of one CA layer's pooler, [lora_dim, C/H] each."""

    def __init__(self, cfg: AttnPoolerConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        shape = (cfg.lora_dim, cfg.feat_dim // cfg.n_heads)
        for name in POOLER_WEIGHTS:
            setattr(self, name, nn.Parameter(torch.zeros(shape, device=device, dtype=dtype)))

    @torch.no_grad()
    def reset(self, gen: torch.Generator):
        """torch Conv1d's default init: U(-sqrt(k), sqrt(k)), k = groups / C_in."""
        bound = float(np.sqrt(self.cfg.n_heads / self.cfg.feat_dim))
        for name in POOLER_WEIGHTS:
            w = getattr(self, name)
            w.copy_(torch.rand(w.shape, generator=gen, device=w.device, dtype=w.dtype)
                    * (2 * bound) - bound)
        return self

    def params(self) -> dict:
        return {name: getattr(self, name) for name in POOLER_WEIGHTS}

    def forward(self, layer_attn: dict, fg_q_emb, bg_q_emb, img_mask=None) -> dict:
        return attn_pooler_forward(self.params(), self.cfg, layer_attn, fg_q_emb, bg_q_emb,
                                   img_mask)


def attn_pooler_init(gen: torch.Generator, cfg: AttnPoolerConfig, *, device=None,
                     dtype=torch.float32) -> AttentionalPooler:
    return AttentionalPooler(cfg, device=device, dtype=dtype).reset(gen)


def _cpu_f32(v) -> torch.Tensor:
    """A state dict's entry (tensor or numpy) as a float32 CPU tensor."""
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu()
    return torch.from_numpy(np.asarray(v, np.float32))


@torch.no_grad()
def _load_pooler(pooler: AttentionalPooler, state_dict, prefix: str) -> AttentionalPooler:
    for name in POOLER_WEIGHTS:
        getattr(pooler, name).copy_(_cpu_f32(state_dict[f"{prefix}{name}.weight"])[..., 0])
    return pooler


def attn_pooler_from_torch(state_dict, cfg: AttnPoolerConfig, prefix: str = "", *,
                           device=None, dtype=torch.float32) -> AttentionalPooler:
    """The reference's pooler weights `<prefix>lora_to_*.weight` [o, c, 1]."""
    return _load_pooler(AttentionalPooler(cfg, device=device, dtype=dtype), state_dict, prefix)


def attn_pooler_forward(params: dict, cfg: AttnPoolerConfig, layer_attn: dict,
                        fg_q_emb: torch.Tensor, bg_q_emb: torch.Tensor,
                        img_mask: torch.Tensor | None = None) -> dict:
    """Eval-mode pooling (dropouts are identity).

    layer_attn: {"x": [B, L, C] layer input features, "q": [B, L, C] the CA
    layer's projected queries, "to_k_w": [C, D_ctx] the CA layer's to_k
    weight (no bias in SD), "infeat_size": (h, w) with h*w == L}.
    fg_q_emb: [D_ctx] static subject embedding probe; bg_q_emb: [B, D_ctx].
    img_mask: optional [B, 1, H0, W0] fg mask (resized here, nearest).
    Returns {"fg_out": [B, C], "bg_out": [B, C], "attn_fg", "attn_bg"}."""
    h = cfg.n_heads
    x = grad_scale(layer_attn["x"], cfg.infeat_grad_scale)
    k_feat = grad_scale(layer_attn["q"], cfg.infeat_grad_scale)
    to_k_w = layer_attn["to_k_w"].to(x.dtype)
    b, l, c = x.shape

    # v = x + LN(q_feat), scaled by H^-1/2; reused as attention keys
    v = (x + _norm(k_feat)) * (h ** -0.5)                              # [B, L, C]

    # the CA layer's to_k turns prompt-space probes into feature-space queries
    fg_q = (fg_q_emb.to(x.dtype)[None] @ to_k_w.t())[None].expand(b, 1, c)
    bg_q = bg_q_emb.to(x.dtype)[:, None] @ to_k_w.t()                  # [B, 1, C]

    extra = h ** -0.5                                  # conv1d_extra_scale
    lora_fg_q = _grouped_linear(_norm(fg_q), params["lora_to_fg_q"], h)
    lora_bg_q = _grouped_linear(_norm(bg_q), params["lora_to_bg_q"], h)
    lora_k = _grouped_linear(v, params["lora_to_k"], h) * extra       # [B, L, ld]
    # fg/bg stacked as 2 query tokens; the head scale twice on q
    lora_q = torch.cat([lora_fg_q, lora_bg_q], dim=1) * (h ** -0.5) * extra

    dl, dv = cfg.lora_dim // h, c // h
    split = lambda t, d: t.reshape(t.shape[0], t.shape[1], h, d).transpose(1, 2)
    q_h, k_h, v_h = split(lora_q, dl), split(lora_k, dl), split(v, dv)

    sim = torch.einsum("bhid,bhjd->bhij", q_h.float(), k_h.float())   # [B, H, 2, L]
    # smooth each head's scores 0.5/0.5 with the head average
    sim = 0.5 * sim + 0.5 * sim.mean(dim=1, keepdim=True)

    if img_mask is not None:
        hw = layer_attn["infeat_size"]
        # torch F.interpolate(mode="nearest"): source pixel floor(i*S/s)
        ri = torch.as_tensor((np.arange(hw[0]) * img_mask.shape[2]) // hw[0],
                             device=img_mask.device)
        ci = torch.as_tensor((np.arange(hw[1]) * img_mask.shape[3]) // hw[1],
                             device=img_mask.device)
        m = img_mask[:, :, ri][:, :, :, ci]
        keep = m.reshape(b, 1, 1, l) != 0
        sim = torch.where(keep, sim, torch.finfo(sim.dtype).min)

    if cfg.is_fgbg_competitive:
        # softmax over the joint (fg/bg, patches) space
        attn = torch.softmax(sim.reshape(b, h, 2 * l), dim=-1).reshape(b, h, 2, l)
    else:
        attn = torch.softmax(sim, dim=-1)

    attn_fg, attn_bg = attn[:, :, :1], attn[:, :, 1:]
    pool = lambda a: torch.einsum("bhij,bhjd->bhid", a.to(v_h.dtype), v_h)
    merge = lambda o: o.transpose(1, 2).reshape(b, c)                 # heads -> C
    return {"fg_out": merge(pool(attn_fg)), "bg_out": merge(pool(attn_bg)),
            "attn_fg": attn_fg, "attn_bg": attn_bg}


# ---------------------------------------------------------------------------
# AdaEmbedding
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdaEmbedderConfig:
    num_layers: int = 16
    num_vectors: int = 1               # K
    fg_emb_count: int = 1
    bg_emb_count: int = 0
    use_cached_bg: bool = False
    out_emb_dim: int = 768
    rank: int = 12                     # r
    num_init_vecs: int = 0             # N (leading pre_vecs rows)
    ca_infeat_dims: tuple = CA_INFEAT_DIMS
    has_bias: bool = True
    attn_pooler_feat_reduction_ratio: int = 8
    do_zero_shot: bool = False         # basis vectors supplied per call

    @property
    def emb_infeat_types(self) -> tuple:
        # 0 = fg, 1 = bg, 2 = fg+bg
        rest = self.num_vectors - self.fg_emb_count - self.bg_emb_count
        return (0,) * self.fg_emb_count + (1,) * self.bg_emb_count + (2,) * rest

    @property
    def is_one_stream_only(self) -> bool:
        return (self.fg_emb_count == self.num_vectors
                or self.bg_emb_count == self.num_vectors)

    @property
    def H(self) -> int:
        return 1 if self.is_one_stream_only else 2

    @property
    def td_frac(self) -> float:
        time_h = max(2 if t == 2 else 1 for t in self.emb_infeat_types)
        return 0.25 * time_h

    def td(self, ca_layer_idx: int) -> int:
        return int(self.td_frac * self.ca_infeat_dims[ca_layer_idx])

    def pooler_cfg(self, ca_layer_idx: int) -> AttnPoolerConfig:
        return AttnPoolerConfig(
            feat_dim=self.ca_infeat_dims[ca_layer_idx],
            feat_reduction_ratio=self.attn_pooler_feat_reduction_ratio,
            infeat_grad_scale=1.0)


class AdaEmbedder(nn.Module):
    """The AdaEmbedding's weights: the 16 poolers, the coefficient maps
    coeff_w [r*K, d_in] / coeff_b [r*K], and, outside zero-shot, the basis
    vectors [K, r - N, D], the init words' pre_vecs [K, N, D] (N =
    `num_pre_vecs`, cfg.num_init_vecs by default) and the per-layer bias
    [L, K, D] (under has_bias); cached_bg_weight (a scalar the forward never
    reads) under use_cached_bg."""

    def __init__(self, cfg: AdaEmbedderConfig, *, num_pre_vecs: int | None = None,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        L, K, r, D = cfg.num_layers, cfg.num_vectors, cfg.rank, cfg.out_emb_dim
        n = cfg.num_init_vecs if num_pre_vecs is None else num_pre_vecs
        kw = dict(device=device, dtype=dtype)
        self.poolers = nn.ModuleList(AttentionalPooler(cfg.pooler_cfg(i), **kw)
                                     for i in range(L))
        d_in = [cfg.ca_infeat_dims[i] * cfg.H + cfg.td(i) for i in range(L)]
        self.coeff_w = nn.ParameterList(nn.Parameter(torch.zeros(r * K, d, **kw))
                                        for d in d_in)
        self.coeff_b = nn.ParameterList(nn.Parameter(torch.zeros(r * K, **kw)) for _ in d_in)
        if not cfg.do_zero_shot:
            self.basis_vecs = nn.Parameter(torch.zeros(K, r - n, D, **kw))
            if n > 0:
                self.pre_vecs = nn.Parameter(torch.zeros(K, n, D, **kw))
            if cfg.has_bias:
                self.bias = nn.Parameter(torch.zeros(L, K, D, **kw))
        if cfg.use_cached_bg:
            self.cached_bg_weight = nn.Parameter(torch.tensor(0.5, **kw))

    def params(self) -> dict:
        p = {"poolers": [pooler.params() for pooler in self.poolers],
             "coeff_w": list(self.coeff_w), "coeff_b": list(self.coeff_b)}
        for name in ("basis_vecs", "pre_vecs", "bias", "cached_bg_weight"):
            if hasattr(self, name):
                p[name] = getattr(self, name)
        return p

    def forward(self, layer_idx: int, layer_attn: dict, time_emb, layer_subj_emb_probe,
                layer_static_extra_emb_mean, img_mask=None, cached_pooler_bg_out=None,
                zs_basis_vecs=None):
        return ada_forward(self.params(), self.cfg, layer_idx, layer_attn, time_emb,
                           layer_subj_emb_probe, layer_static_extra_emb_mean, img_mask=img_mask,
                           cached_pooler_bg_out=cached_pooler_bg_out,
                           zs_basis_vecs=zs_basis_vecs)


def reduce_fg_bg_cross_weights(params: dict, cfg: AdaEmbedderConfig,
                               max_ratio: float = 0.01) -> dict:
    """Init-time weight surgery: for each fg (resp. bg) embedding's rows of
    the coefficient map, scale the columns reading the OTHER stream down to
    at most `max_ratio` of the own-stream mean |w|. Out of place (numpy
    float32, as the JAX package computes it)."""
    if cfg.H == 1:
        return params
    out_w = []
    for li, w in enumerate(params["coeff_w"]):
        d = cfg.ca_infeat_dims[li]
        wk = w.detach().cpu().float().numpy().copy().reshape(cfg.num_vectors, cfg.rank, -1)
        for k, t in enumerate(cfg.emb_infeat_types):
            fg_m = np.abs(wk[k, :, :d]).mean()
            bg_m = np.abs(wk[k, :, d:2 * d]).mean()
            if t == 0:
                wk[k, :, d:2 * d] *= min(1.0, max_ratio * fg_m / (bg_m + 1e-6))
            elif t == 1:
                wk[k, :, :d] *= min(1.0, max_ratio * bg_m / (fg_m + 1e-6))
        out_w.append(torch.from_numpy(wk.reshape(w.shape)).to(device=w.device, dtype=w.dtype))
    return {**params, "coeff_w": out_w}


@torch.no_grad()
def ada_init(gen: torch.Generator, cfg: AdaEmbedderConfig, init_vecs: torch.Tensor | None = None,
             *, device=None, dtype=torch.float32) -> AdaEmbedder:
    """Random weights from `gen`: the poolers as torch Conv1d, the
    coefficient maps as torch Linear (zero bias), basis vectors normal,
    unit-norm / 4 with each k's last one zero, pre_vecs the init words
    tiled over K, zero bias; then the cross-weight surgery."""
    L, K, r, D = cfg.num_layers, cfg.num_vectors, cfg.rank, cfg.out_emb_dim
    n = 0 if init_vecs is None else init_vecs.shape[0]
    ada = AdaEmbedder(cfg, num_pre_vecs=n, device=device, dtype=dtype)
    for pooler in ada.poolers:
        pooler.reset(gen)
    for w in ada.coeff_w:
        bound = float(np.sqrt(1.0 / w.shape[1]))        # torch Linear default init
        w.copy_(torch.rand(w.shape, generator=gen, device=w.device, dtype=dtype)
                * (2 * bound) - bound)
    if not cfg.do_zero_shot:
        bv = torch.randn(ada.basis_vecs.shape, generator=gen, device=ada.basis_vecs.device,
                         dtype=dtype)
        bv = bv / bv.norm(dim=-1, keepdim=True) / 4.0
        bv[:, -1] = 0.0
        ada.basis_vecs.copy_(bv)
        if init_vecs is not None:
            ada.pre_vecs.copy_(torch.as_tensor(init_vecs, dtype=dtype)[None].expand(K, -1, -1))
    for w, new in zip(ada.coeff_w, reduce_fg_bg_cross_weights(ada.params(), cfg)["coeff_w"]):
        w.copy_(new)
    return ada


def ada_from_torch(state_dict, cfg: AdaEmbedderConfig, *, device=None,
                   dtype=torch.float32) -> AdaEmbedder:
    """The reference AdaEmbedding's state dict: `poolers.i.lora_to_*.weight`
    [o, c, 1], `layer_coeff_maps.i.weight` / `.bias`, and those of
    `basis_vecs`, `pre_vecs`, `bias`, `cached_bg_weight` it holds (the
    reference applies the cross-weight surgery before saving)."""
    sd = {k: _cpu_f32(v) for k, v in state_dict.items()}
    n = sd["pre_vecs"].shape[1] if "pre_vecs" in sd else 0
    ada = AdaEmbedder(cfg, num_pre_vecs=n, device=device, dtype=dtype)
    with torch.no_grad():
        for i in range(cfg.num_layers):
            _load_pooler(ada.poolers[i], sd, f"poolers.{i}.")
            ada.coeff_w[i].copy_(sd[f"layer_coeff_maps.{i}.weight"])
            ada.coeff_b[i].copy_(sd[f"layer_coeff_maps.{i}.bias"])
        for name in ("basis_vecs", "pre_vecs", "bias", "cached_bg_weight"):
            if name in sd and hasattr(ada, name):
                getattr(ada, name).copy_(sd[name])
    return ada


def ada_forward(params: dict, cfg: AdaEmbedderConfig, layer_idx: int, layer_attn: dict,
                time_emb: torch.Tensor, layer_subj_emb_probe: torch.Tensor,
                layer_static_extra_emb_mean: torch.Tensor,
                img_mask: torch.Tensor | None = None,
                cached_pooler_bg_out: torch.Tensor | None = None,
                zs_basis_vecs: torch.Tensor | None = None):
    """One layer's dynamic embedding (eval semantics).

    layer_idx: UNet layer index (1..24, a conditioned CA layer).
    layer_attn / img_mask: see attn_pooler_forward. time_emb: [B, 1280].
    layer_subj_emb_probe: [D_ctx]; layer_static_extra_emb_mean: [B, D_ctx].
    zs_basis_vecs: [B, K, r, D] under do_zero_shot.
    Returns (out_vecs [B, K, D], {"bg_out": ...} for bg-token reuse)."""
    ca = LAYER_IDX2CA[layer_idx]
    K, r, D = cfg.num_vectors, cfg.rank, cfg.out_emb_dim

    cached_bg_used = cfg.use_cached_bg and cached_pooler_bg_out is not None
    if cfg.use_cached_bg and cached_pooler_bg_out is None:
        raise ValueError("use_cached_bg requires cached_pooler_bg_out")
    pooled = attn_pooler_forward(params["poolers"][ca], cfg.pooler_cfg(ca), layer_attn,
                                 layer_subj_emb_probe, layer_static_extra_emb_mean, img_mask)
    infeat_fg = pooled["fg_out"]
    infeat_bg = cached_pooler_bg_out if cached_bg_used else pooled["bg_out"]
    if cfg.H == 2:
        infeat = torch.cat([infeat_fg, infeat_bg], dim=-1)
    else:
        infeat = infeat_bg if cfg.bg_emb_count == cfg.num_vectors else infeat_fg

    time_feat = time_emb[:, :cfg.td(ca)]
    # LNCat3: a non-affine LN of each part, then concatenated
    feats = torch.cat([_norm(infeat), _norm(time_feat.to(infeat.dtype))], dim=-1)
    w, bias = params["coeff_w"][ca], params["coeff_b"][ca]
    coeffs = (feats @ w.to(feats.dtype).t() + bias.to(feats.dtype)).reshape(-1, K, r)

    if cfg.do_zero_shot:
        if zs_basis_vecs is None:
            raise ValueError("do_zero_shot requires zs_basis_vecs [B, K, r, D]")
        out = torch.einsum("bkr,bkrd->bkd", coeffs, zs_basis_vecs.to(coeffs.dtype))
    else:
        basis = params["basis_vecs"]                                  # [K, r-N, D]
        if "pre_vecs" in params:
            basis = torch.cat([params["pre_vecs"], basis], dim=1)
        out = torch.einsum("bkr,krd->bkd", coeffs, basis.to(coeffs.dtype))
    out = _norm(out) / float(np.sqrt(D))
    if "bias" in params and not cfg.do_zero_shot:
        out = out + params["bias"][ca][None].to(out.dtype)
    return out, {"bg_out": pooled["bg_out"]}


# ---------------------------------------------------------------------------
# Embedding3d: a [L, K, D] table (the reference's EMA container for ada
# embeddings); plain-tensor helpers, out of place
# ---------------------------------------------------------------------------

def embedding3d_init(num_layers: int = 16, num_vectors: int = 9, out_emb_dim: int = 768,
                     init_embedding: torch.Tensor | None = None, *, device=None,
                     dtype=torch.float32) -> torch.Tensor:
    shape = (num_layers, num_vectors, out_emb_dim)
    if init_embedding is not None:
        return torch.as_tensor(init_embedding, dtype=dtype, device=device).expand(shape).clone()
    return torch.zeros(shape, dtype=dtype, device=device)


def embedding3d_lookup(table: torch.Tensor, layer_idx, token_idx=None) -> torch.Tensor:
    return table[layer_idx] if token_idx is None else table[layer_idx, token_idx]


def embedding3d_cache_layer(table: torch.Tensor, layer_idx,
                            new_embedding: torch.Tensor) -> torch.Tensor:
    out = table.clone()
    out[layer_idx] = new_embedding
    return out
