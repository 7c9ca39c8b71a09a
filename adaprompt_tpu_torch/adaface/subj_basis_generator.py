"""SubjBasisGenerator, the AdaFace encoder: its face and object subject
branches and its background branch.

Port of `adaprompt_tpu/adaface/subj_basis_generator.py`. A trainable CLIP
text model (`prompt2token_proj`) inverts Arc2Face core ID embeddings back
into SD's prompt space through `arc2face.inverse_face_prompt_embs`, with
learnable last-3-hidden-layer weights (init [1, 2, 4], gradient scale 5)
and an output gradient scale of 0.4. The 16 core embeddings are repeated
over the 16 UNet cross-attention layers, and optionally blended with pad
embeddings when `out_id_embs_scale` < 1. The object branch takes DINO CLS
embeddings [B, 384] instead: Linear(384 -> 16 x 768, no bias), a LayerNorm
over each 768-vector, repeated over the 16 layers.

Background branch (`placeholder_is_bg`): the zero-shot CLIP image features
[B, N, 1280] go through Linear(1280 -> 768) + LN, get learned positional
embeddings, and one cross-attention (`prompt_translator`: to_q/to_k/to_v
Linear + LN each, a skip connection on V, an identity out-projection)
from 16 x 4 learned latent queries makes 4 background vectors for each of
the 16 layers, scaled by 768**-0.5.

Every leaf of `prompt2token_proj` is trainable (its token and position
embeddings too), as in the JAX package. The parameter names are the JAX
pytree's after `convert.from_jax_params`.

`from_torch` reads the reference's module names (a generator out of an
`embeddings_gs-*.pt`, `adaface/checkpoint.load_reference_checkpoint`) and
`from_state` builds the module for such a state dict, `prompt2token_proj`'s
k/v as wide as the state's; `extend_prompt2token_proj_attention` is the K/V
multiplier surgery on a built one.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from adaprompt_tpu_torch.adaface import arc2face
from adaprompt_tpu_torch.adaface.gradient import grad_scale
from adaprompt_tpu_torch.models import clip_text
from adaprompt_tpu_torch.models.clip_text import SD15_TEXT_CONFIG, CLIPTextConfig, CLIPTextModel
from adaprompt_tpu_torch.ops.layers import Norm, layer_norm, linear
from adaprompt_tpu_torch.utils.torch_port import renamed


@dataclasses.dataclass(frozen=True)
class SubjBasisConfig:
    placeholder_is_bg: bool = False
    num_out_layers: int = 16
    num_out_embs_per_layer: int = 16        # 16 subj / 4 bg
    num_id_vecs_bg: int = 257               # CLIP vision tokens
    image_embedding_dim: int = 1280         # CLIP-H vision width
    dino_embedding_dim: int = 384
    output_dim: int = 768
    num_heads: int = 6
    prompt2token_proj_grad_scale: float = 0.4
    zs_extra_words_scale: float = 0.5
    hidden_weights_grad_scale: float = 5.0
    text_cfg: CLIPTextConfig = SD15_TEXT_CONFIG


SUBJ_CONFIG = SubjBasisConfig(placeholder_is_bg=False, num_out_embs_per_layer=16)
BG_CONFIG = SubjBasisConfig(placeholder_is_bg=True, num_out_embs_per_layer=4)


class _LinearLN(nn.Module):
    """Linear without bias and a LayerNorm over `d`: the object branch's
    Linear(384 -> 16*768) + LN over each 768-vector, and the background
    branch's projections, whose `forward` is Linear then LN."""

    def __init__(self, cin, cout, d, kw):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, **kw))
        self.ln = Norm(d, **kw)
        self.ln.requires_grad_(True)

    def reset(self, gen):
        self.weight.normal_(0.0, 0.02, generator=gen)

    def forward(self, x):
        return layer_norm(linear(x, self.weight), self.ln.weight, self.ln.bias)


def _bg_cross_attention(p: nn.ModuleDict, q_in: torch.Tensor, context: torch.Tensor,
                        num_heads: int) -> torch.Tensor:
    """The background prompt_translator: q, k and v each a Linear + LN, a
    skip connection on v, fp32 logits at scale hd**-0.5, the probabilities
    cast to v's dtype, no out-projection."""
    q, k = p["to_q"](q_in), p["to_k"](context)
    v = p["to_v"](context) + context
    b, nq, d = q.shape
    hd = d // num_heads
    qh = q.reshape(b, nq, num_heads, hd)
    kh = k.reshape(b, -1, num_heads, hd)
    vh = v.reshape(b, -1, num_heads, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float()) * hd ** -0.5
    probs = torch.softmax(logits, dim=-1).to(vh.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vh).reshape(b, nq, d)


class SubjBasisGenerator(nn.Module):
    def __init__(self, cfg: SubjBasisConfig = SUBJ_CONFIG, *, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        if cfg.placeholder_is_bg:
            d = cfg.output_dim
            n_out = cfg.num_out_layers * cfg.num_out_embs_per_layer
            norm = lambda: Norm(d, **kw).requires_grad_(True)
            self.pos_embs = nn.Parameter(torch.empty(1, cfg.num_id_vecs_bg, d, **kw))
            self.pos_embs_ln = norm()
            self.latent_queries = nn.Parameter(torch.empty(1, n_out, d, **kw))
            self.latent_queries_ln = norm()
            self.bg_proj_in = _LinearLN(cfg.image_embedding_dim, d, d, kw)
            self.prompt_translator = nn.ModuleDict(
                {n: _LinearLN(d, d, d, kw) for n in ("to_q", "to_k", "to_v")})
            return
        self.hidden_state_layer_weights = nn.Parameter(torch.empty(3, 1, **kw))
        self.prompt2token_proj = CLIPTextModel(cfg.text_cfg, **kw).requires_grad_(True)
        self.obj_proj_in = _LinearLN(cfg.dino_embedding_dim, 16 * cfg.output_dim,
                                    cfg.output_dim, kw)

    def reset(self, gen: torch.Generator):
        """Clip-skip weights [1, 2, 4], or the background branch's positional
        embeddings and latent queries N(0, 1); `layers.reset_parameters`
        does the rest."""
        if self.cfg.placeholder_is_bg:
            self.pos_embs.normal_(0.0, 1.0, generator=gen)
            self.latent_queries.normal_(0.0, 1.0, generator=gen)
            return
        self.hidden_state_layer_weights.copy_(torch.tensor([[1.0], [2.0], [4.0]]))

    def forward(self, tokenizer, arc2face_id_embs: torch.Tensor | None = None,
                clip_features: torch.Tensor | None = None,
                raw_id_embs: torch.Tensor | None = None, *,
                out_id_embs_scale: float = 1.0, is_face: bool = True,
                is_training: bool = False,
                adaface_prompt_embs_inf_type: str = "full_half_pad",
                pad_embeddings: torch.Tensor | None = None):
        """-> (subject embeddings [B, L, K, D], adaface prompt embeddings
        [B, 77, D]); the object branch (`is_face` False) reads the DINO
        embeddings `raw_id_embs` [B, 384], the background branch
        `clip_features` [B, N, 1280], and neither gives prompt embeddings
        (None)."""
        cfg = self.cfg
        if cfg.placeholder_is_bg:
            subj_embs = self._background(clip_features)
            return self._blend(subj_embs, out_id_embs_scale, pad_embeddings), None
        if not is_face:
            if raw_id_embs is None:
                raise ValueError("need arc2face_id_embs (face) or raw_id_embs (object)")
            p = self.obj_proj_in
            h = linear(raw_id_embs, p.weight).reshape(raw_id_embs.shape[0], 16, cfg.output_dim)
            h = layer_norm(h, p.ln.weight, p.ln.bias)
            subj_embs = h[:, None].expand(-1, cfg.num_out_layers, -1, -1)
            if out_id_embs_scale != 1.0 and pad_embeddings is None:
                pad_embeddings = arc2face.generate_pad_embeddings(self.prompt2token_proj,
                                                                  tokenizer)
            return self._blend(subj_embs, out_id_embs_scale, pad_embeddings), None
        if pad_embeddings is None:
            pad_embeddings = arc2face.generate_pad_embeddings(self.prompt2token_proj, tokenizer)
        hw = grad_scale(self.hidden_state_layer_weights, cfg.hidden_weights_grad_scale)
        emb_type = "full_pad" if is_training else adaface_prompt_embs_inf_type
        prompt_embs, core_id_embs = arc2face.inverse_face_prompt_embs(
            self.prompt2token_proj, tokenizer, arc2face_id_embs, (emb_type, "core"),
            pad_embeddings, hidden_state_layer_weights=hw,
            zs_extra_words_scale=cfg.zs_extra_words_scale)
        prompt_embs = grad_scale(prompt_embs, cfg.prompt2token_proj_grad_scale)
        core_id_embs = grad_scale(core_id_embs, cfg.prompt2token_proj_grad_scale)
        subj_embs = core_id_embs[:, None].expand(-1, cfg.num_out_layers, -1, -1)
        return self._blend(subj_embs, out_id_embs_scale, pad_embeddings), prompt_embs

    def _background(self, clip_features: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if clip_features is None:
            raise ValueError("the background SubjBasisGenerator needs clip_features")
        if clip_features.ndim != 3 or clip_features.shape[1] != self.pos_embs.shape[1]:
            raise ValueError(f"clip_features of shape {tuple(clip_features.shape)} do not match "
                             f"the positional embeddings of shape {tuple(self.pos_embs.shape)} "
                             f"(num_id_vecs_bg={cfg.num_id_vecs_bg} rows)")
        b = clip_features.shape[0]
        id_embs = self.bg_proj_in(clip_features)
        id_embs = id_embs + layer_norm(self.pos_embs, self.pos_embs_ln.weight,
                                       self.pos_embs_ln.bias)
        lq = layer_norm(self.latent_queries, self.latent_queries_ln.weight,
                        self.latent_queries_ln.bias).expand(b, -1, -1)
        out = _bg_cross_attention(self.prompt_translator, lq, id_embs, cfg.num_heads)
        out = out.reshape(b, cfg.num_out_layers, cfg.num_out_embs_per_layer, cfg.output_dim)
        return out * cfg.output_dim ** -0.5

    def _blend(self, subj_embs, out_id_embs_scale, pad_embeddings):
        """Blend with the pad embeddings' first K core positions when
        out_id_embs_scale != 1 (the background branch must be given them)."""
        if out_id_embs_scale == 1.0:
            return subj_embs
        if pad_embeddings is None:
            raise ValueError("out_id_embs_scale != 1 on the background branch needs "
                             "pad_embeddings")
        k = self.cfg.num_out_embs_per_layer
        pads = pad_embeddings[4:4 + k][None, None]
        return subj_embs * out_id_embs_scale + pads * (1.0 - out_id_embs_scale)


def from_torch(state_dict, cfg: SubjBasisConfig) -> dict[str, torch.Tensor]:
    """A reference SubjBasisGenerator state dict -> a state dict for
    `SubjBasisGenerator(cfg)` (load through `from_state`). Face branch:
    `hidden_state_layer_weights`, `prompt2token_proj.*` in the HF CLIP
    layout (K/V-widened layers keep their width) and, when present,
    `obj_proj_in.0` / `.2` (Linear, LN). Background branch: `bg_proj_in.0`
    / `.1`, `prompt_translator.to_{q,k,v}.0` / `.1`, the positional
    embeddings and latent queries with their LNs."""
    sd = {k: v.to_dense() if getattr(v, "is_sparse", False) else v
          for k, v in state_dict.items()}
    if not cfg.placeholder_is_bg:
        proj = {k.removeprefix("prompt2token_proj."): v for k, v in sd.items()
                if k.startswith("prompt2token_proj.")}
        state = {"prompt2token_proj." + k: v
                 for k, v in clip_text.from_torch(proj, cfg.text_cfg).items()}
        names = {"hidden_state_layer_weights": "hidden_state_layer_weights"}
        if "obj_proj_in.0.weight" in sd:
            names.update({"obj_proj_in.weight": "obj_proj_in.0.weight",
                          "obj_proj_in.ln.weight": "obj_proj_in.2.weight",
                          "obj_proj_in.ln.bias": "obj_proj_in.2.bias"})
        return {**renamed(sd, names), **state}
    names = {n: n for n in ("pos_embs", "latent_queries", "pos_embs_ln.weight",
                            "pos_embs_ln.bias", "latent_queries_ln.weight",
                            "latent_queries_ln.bias")}
    for dst, src in [("bg_proj_in", "bg_proj_in")] + [
            (f"prompt_translator.to_{n}", f"prompt_translator.to_{n}") for n in "qkv"]:
        names.update({dst + ".weight": src + ".0.weight", dst + ".ln.weight": src + ".1.weight",
                      dst + ".ln.bias": src + ".1.bias"})
    return renamed(sd, names)


def from_state(state: dict, cfg: SubjBasisConfig, *, device=None,
               dtype=torch.float32) -> SubjBasisGenerator:
    """A SubjBasisGenerator holding `state` (this module's parameter names,
    as `from_torch` or `convert.from_jax_params` make them), its
    `prompt2token_proj` k/v sized to the state's. A face-branch state
    without the object projection (the JAX package's trees may lack it)
    leaves that projection at zero (the object branch then gives the LN's
    bias)."""
    sbg = SubjBasisGenerator(cfg, device=device, dtype=dtype)
    if not cfg.placeholder_is_bg:
        sbg.prompt2token_proj.match_kv_widths(state, "prompt2token_proj.")
        if "obj_proj_in.weight" not in state:
            state = {**state, **{k: torch.zeros_like(v) for k, v in
                                 sbg.obj_proj_in.state_dict(prefix="obj_proj_in.").items()}}
    sbg.load_state_dict(state, strict=True)
    return sbg


def extend_prompt2token_proj_attention(sbg: SubjBasisGenerator, multiplier: int = 2,
                                       noise_std: float = 0.1, begin_layer: int = -1,
                                       end_layer: int = -1, *,
                                       generator: torch.Generator | None = None,
                                       noise=None) -> SubjBasisGenerator:
    """The K/V multiplier surgery on `prompt2token_proj`, in place
    (`clip_text.extend_attention_mkv`)."""
    clip_text.extend_attention_mkv(sbg.prompt2token_proj, multiplier, noise_std, begin_layer,
                                   end_layer, generator=generator, noise=noise)
    return sbg
