"""SubjBasisGenerator, the AdaFace encoder: its face subject branch.

Port of `adaprompt_tpu/adaface/subj_basis_generator.py`. A trainable CLIP
text model (`prompt2token_proj`) inverts Arc2Face core ID embeddings back
into SD's prompt space through `arc2face.inverse_face_prompt_embs`, with
learnable last-3-hidden-layer weights (init [1, 2, 4], gradient scale 5)
and an output gradient scale of 0.4. The 16 core embeddings are repeated
over the 16 UNet cross-attention layers, and optionally blended with pad
embeddings when `out_id_embs_scale` < 1.

Every leaf of `prompt2token_proj` is trainable (its token and position
embeddings too), as in the JAX package. The parameter names are the JAX
pytree's after `convert.from_jax_params`. The object (DINO) branch's
projection is held so that the parameter set matches the JAX package's;
the object and background branches themselves are not ported yet and raise
NotImplementedError.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from adaprompt_tpu_torch.adaface import arc2face
from adaprompt_tpu_torch.adaface.gradient import grad_scale
from adaprompt_tpu_torch.models.clip_text import SD15_TEXT_CONFIG, CLIPTextConfig, CLIPTextModel
from adaprompt_tpu_torch.ops.layers import Norm


@dataclasses.dataclass(frozen=True)
class SubjBasisConfig:
    placeholder_is_bg: bool = False
    num_out_layers: int = 16
    num_out_embs_per_layer: int = 16        # 16 subj / 4 bg
    dino_embedding_dim: int = 384
    output_dim: int = 768
    prompt2token_proj_grad_scale: float = 0.4
    zs_extra_words_scale: float = 0.5
    hidden_weights_grad_scale: float = 5.0
    text_cfg: CLIPTextConfig = SD15_TEXT_CONFIG


SUBJ_CONFIG = SubjBasisConfig(placeholder_is_bg=False, num_out_embs_per_layer=16)


class _ObjProj(nn.Module):
    """Linear(384 -> 16*768, no bias) + LayerNorm of the object branch."""

    def __init__(self, cin, cout, d, kw):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, **kw))
        self.ln = Norm(d, **kw)
        self.ln.requires_grad_(True)

    def reset(self, gen):
        self.weight.normal_(0.0, 0.02, generator=gen)


class SubjBasisGenerator(nn.Module):
    def __init__(self, cfg: SubjBasisConfig = SUBJ_CONFIG, *, device=None, dtype=torch.float32):
        super().__init__()
        if cfg.placeholder_is_bg:
            raise NotImplementedError("the background SubjBasisGenerator is not ported yet")
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.hidden_state_layer_weights = nn.Parameter(torch.empty(3, 1, **kw))
        self.prompt2token_proj = CLIPTextModel(cfg.text_cfg, **kw).requires_grad_(True)
        self.obj_proj_in = _ObjProj(cfg.dino_embedding_dim, 16 * cfg.output_dim,
                                    cfg.output_dim, kw)

    def reset(self, gen: torch.Generator):
        """Clip-skip weights [1, 2, 4]; `layers.reset_parameters` does the rest."""
        self.hidden_state_layer_weights.copy_(torch.tensor([[1.0], [2.0], [4.0]]))

    def forward(self, tokenizer, arc2face_id_embs: torch.Tensor, *,
                out_id_embs_scale: float = 1.0, is_face: bool = True,
                is_training: bool = False,
                adaface_prompt_embs_inf_type: str = "full_half_pad",
                pad_embeddings: torch.Tensor | None = None):
        """-> (subject embeddings [B, L, K, D], adaface prompt embeddings [B, 77, D])."""
        cfg = self.cfg
        if not is_face:
            raise NotImplementedError("the object (DINO) branch is not ported yet")
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
        if out_id_embs_scale != 1.0:
            k = cfg.num_out_embs_per_layer
            pads = pad_embeddings[4:4 + k][None, None]
            subj_embs = subj_embs * out_id_embs_scale + pads * (1.0 - out_id_embs_scale)
        return subj_embs, prompt_embs
