"""Arc2Face forward and inverse prompt embeddings.

Port of `adaprompt_tpu/adaface/arc2face.py`:

  * `forward_face_embs`: a normalized ArcFace vector [B, 512] goes into the
    Arc2Face CLIP prompt space: "photo of a id person" is tokenized, the
    'id' token embedding is replaced by the zero-padded face vector, and the
    Arc2Face text encoder returns the full embeddings and the 16 "core" ID
    embeddings from the 'id' position on;
  * `inverse_face_prompt_embs`: Arc2Face core embeddings go back into SD's
    prompt space: "photo of a " + ", " * 16 (+ up to 2 extra words), the 16
    core embeddings spliced over the 16 ',' placeholders, through the
    trainable `prompt2token_proj` encoder with learnable last-3-layer
    weights; it returns the requested embedding variants;
  * `generate_pad_embeddings`: the pad (EOS) token's embedding at every
    position, detached.

Placeholder positions come from the tokenizer, so any vocabulary works. A
16-token slice that would run past the sequence starts early enough to fit,
as `jax.lax.dynamic_slice` clamps its start.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from adaprompt_tpu_torch.models.clip_text import CLIPTextModel
from adaprompt_tpu_torch.utils.tokenizer import CLIPTokenizer

NUM_CORE_EMBS = 16
EXTRA_WORDS_MAX_TOKENS = 2

_templates: dict = {}


def _forward_template(tok: CLIPTokenizer, max_length: int):
    """(ids [S], id_pos) for 'photo of a id person'."""
    key = ("forward", id(tok), max_length)
    if key not in _templates:
        id_tok = tok.encode_raw("id")
        ids = tok("photo of a id person", max_length=max_length)[0]
        _templates[key] = (ids, int(np.where(ids == id_tok[0])[0][0]))
    return _templates[key]


def inverse_template(tok: CLIPTokenizer, max_length: int, extra_words: str | None = None):
    """(ids [S], first comma position) for 'photo of a ' + ', ' * 16 [+ extra]."""
    key = ("inverse", id(tok), max_length, extra_words)
    if key not in _templates:
        comma_ids = tok.encode_raw(",")
        if len(comma_ids) != 1:
            raise ValueError("',' must be a single token")
        ids = tok("photo of a " + ", " * NUM_CORE_EMBS + (extra_words or ""),
                  max_length=max_length)[0]
        comma_pos = np.where(ids == comma_ids[0])[0]
        start = int(comma_pos[0])
        if not (comma_pos[:NUM_CORE_EMBS] == np.arange(start, start + NUM_CORE_EMBS)).all():
            raise ValueError("the 16 placeholders must be consecutive tokens")
        _templates[key] = (ids, start)
    return _templates[key]


def _slice_start(start: int, length: int, seq: int) -> int:
    return min(max(start, 0), seq - length)


def _tile_ids(ids_np, b, device):
    return torch.as_tensor(np.asarray(ids_np), device=device).long()[None].expand(b, -1)


def forward_face_embs(text: CLIPTextModel, tokenizer: CLIPTokenizer, face_embs: torch.Tensor,
                      *, input_max_length: int = 77):
    """ArcFace [B, 512] -> (Arc2Face prompt embeddings [B, S, D], core [B, 16, D])."""
    ids_np, id_pos = _forward_template(tokenizer, input_max_length)
    b = face_embs.shape[0]
    ids = _tile_ids(ids_np, b, face_embs.device)
    token_embs = text.token_embedding[ids]
    face = F.pad(face_embs.to(token_embs.dtype), (0, token_embs.shape[-1] - face_embs.shape[-1]))
    token_embs = torch.cat([token_embs[:, :id_pos], face[:, None], token_embs[:, id_pos + 1:]],
                           dim=1)
    prompt_embs = text.encode(ids, inputs_embeds=token_embs)
    start = _slice_start(id_pos, NUM_CORE_EMBS, prompt_embs.shape[1])
    return prompt_embs, prompt_embs[:, start:start + NUM_CORE_EMBS]


def inverse_face_prompt_embs(text: CLIPTextModel, tokenizer: CLIPTokenizer,
                             face_prompt_embs: torch.Tensor, return_emb_types,
                             pad_embeddings: torch.Tensor, *,
                             hidden_state_layer_weights=None,
                             list_extra_words: list | None = None,
                             zs_extra_words_scale: float = 0.5,
                             input_max_length: int = 77) -> list:
    """Arc2Face core embeddings [B, 16, D] -> the SD prompt-space embeddings
    of each of `return_emb_types`: 'full', 'full_pad', 'full_half_pad',
    'full_zeroed_extra', 'core' or 'b_core_e'. pad_embeddings [S, D]."""
    b = face_prompt_embs.shape[0]
    device = face_prompt_embs.device
    if list_extra_words is not None:
        if len(list_extra_words) != b or any(len(w.split()) > 2 for w in list_extra_words):
            raise ValueError("one extra-words string of at most 2 words per row")
        rows = [inverse_template(tokenizer, input_max_length, w) for w in list_extra_words]
        if len({s for _, s in rows}) != 1:
            raise ValueError("extra words moved the placeholder position")
        ids = torch.as_tensor(np.stack([r for r, _ in rows]), device=device).long()
        start = rows[0][1]
    else:
        ids_np, start = inverse_template(tokenizer, input_max_length)
        ids = _tile_ids(ids_np, b, device)

    token_embs = text.token_embedding[ids]
    seq = token_embs.shape[1]
    start = _slice_start(start, NUM_CORE_EMBS, seq)
    token_embs = torch.cat([token_embs[:, :start], face_prompt_embs.to(token_embs.dtype),
                            token_embs[:, start + NUM_CORE_EMBS:]], dim=1)
    prompt_embs = text.encode(ids, inputs_embeds=token_embs,
                              hidden_state_layer_weights=hidden_state_layer_weights)

    core = prompt_embs[:, start:start + NUM_CORE_EMBS]
    core_end = start + NUM_CORE_EMBS
    if list_extra_words is not None:
        extra = prompt_embs[:, core_end:core_end + EXTRA_WORDS_MAX_TOKENS] * zs_extra_words_scale
        core = torch.cat([core, extra], dim=1)

    after = core_end + EXTRA_WORDS_MAX_TOKENS   # after the two extra-word slots
    pad_embeddings = pad_embeddings.to(prompt_embs.dtype)
    pos = np.arange(seq)
    outs = []
    for emb_type in return_emb_types:
        if emb_type == "full":
            outs.append(prompt_embs)
        elif emb_type == "full_pad":
            outs.append(_fill(prompt_embs, pad_embeddings, (pos >= after) & (pos < seq - 1)))
        elif emb_type == "full_half_pad":
            pads = seq - after - 1
            mask = np.zeros(seq, bool)
            if pads >= 2:
                mask[after:after + pads // 2] = True
            outs.append(_fill(prompt_embs, pad_embeddings, mask))
        elif emb_type == "full_zeroed_extra":
            mask = np.zeros(seq, bool)
            mask[after:after + 2] = True
            out = _fill(prompt_embs, pad_embeddings, mask)
            zero = torch.as_tensor((pos >= after + 2) & (pos < seq - 1), device=device)
            outs.append(torch.where(zero[None, :, None], torch.zeros((), dtype=out.dtype,
                                                                     device=device), out))
        elif emb_type == "core":
            outs.append(core)
        elif emb_type == "b_core_e":
            outs.append(torch.cat([prompt_embs[:, :after], prompt_embs[:, -1:]], dim=1))
        else:
            raise ValueError(f"unknown emb type {emb_type!r}")
    return outs


def _fill(prompt_embs, pad_embeddings, mask_np):
    mask = torch.as_tensor(mask_np, device=prompt_embs.device)[None, :, None]
    return torch.where(mask, pad_embeddings[None], prompt_embs)


def generate_pad_embeddings(text: CLIPTextModel, tokenizer: CLIPTokenizer,
                            max_length: int = 77) -> torch.Tensor:
    """[S, D] embeddings of the pad (EOS) token at every position, positional
    embeddings included; detached."""
    with torch.no_grad():
        return (text.token_embedding[tokenizer.eos_id]
                + text.position_embedding[:max_length]).detach()
