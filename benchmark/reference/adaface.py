"""AdaFace's personalization chain (askerlee/adaprompt `adaface_wrapper.py`,
FoivosPar/Arc2Face), plain: photos -> ArcFace -> Arc2Face -> the
SubjBasisGenerator's 16 subject vectors -> the SD prompt with those vectors
in the token table -> cond / uncond contexts.

  * faceid: each photo's centre crop through ArcFace, L2-normalized; the
    mean over photos, L2-normalized (twice, as the wrapper does);
  * Arc2Face: "photo of a id person" (22 tokens), the embedding of the token
    'id' replaced by the face vector zero-padded to 768, through the Arc2Face
    text encoder; the 16 outputs from the 'id' position on are the core ID
    embeddings;
  * SubjBasisGenerator (face branch, inference): "photo of a " + ", " x 16
    (77 tokens), the 16 core embeddings over the 16 commas, through
    `prompt2token_proj` with its learned clip-skip weights over the last 3
    hidden states; the 16 outputs at the commas are the subject vectors (one
    set for every layer at inference, out_id_embs_scale 1);
  * the prompt's 'z' becomes the 16 new tokens z_0 .. z_15, whose rows of
    the SD text encoder's token table hold the subject vectors; SD's text
    encoder with clip-skip weights (1, 1).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import arcface, clip
from benchmark.reference.tokenizer import Tokenizer

NUM_VECTORS = 16


def faceid(w: dict, c: dict, photos: list, device, dtype=torch.float32) -> torch.Tensor:
    """Photos (uint8 HWC) -> the normalized mean embedding [1, F] (float64 sums)."""
    crops = np.stack([arcface.center_crop(p, c["input_size"]) for p in photos])
    x = torch.from_numpy((crops.astype(np.float32) - 127.5) / 127.5).to(device=device, dtype=dtype)
    emb = arcface.forward(w, c, x).double()
    emb = emb / torch.linalg.norm(emb, dim=-1, keepdim=True)
    m = emb.mean(dim=0, keepdim=True)
    m = m / torch.linalg.norm(m, dim=-1, keepdim=True)
    return (m / torch.linalg.norm(m, dim=-1, keepdim=True)).to(dtype)


def sbg_param_shapes(c_text: dict, kv_mult) -> list:
    """[(name, shape, init)] of the SubjBasisGenerator's face branch (its
    clip-skip weights and `prompt2token_proj`, a CLIP text model with the
    K/V multiplier `kv_mult` a layer) and of its unused object projection."""
    d = c_text["hidden_size"]
    out = [("hidden_state_layer_weights", (3, 1), ("values", [1.0, 2.0, 4.0]))]
    out += clip.param_shapes(c_text, "prompt2token_proj.", kv_mult)
    return out + [("obj_proj_in.weight", (16 * d, 384), ("normal", 0.02)),
                  ("obj_proj_in.ln.weight", (d,), ("one", 0.05)), ("obj_proj_in.ln.bias", (d,), ("normal", 0.02))]


def arc2face(w_a2f: dict, c_text: dict, tok: Tokenizer, face: torch.Tensor, max_length: int) -> tuple:
    """Face vectors [B, F] -> (Arc2Face prompt embeddings [B, S, D], core [B, 16, D])."""
    device = face.device
    ids = tok("photo of a id person", max_length=max_length)[0]
    id_pos = int(np.where(ids == tok.encode_raw("id")[0])[0][0])
    ids_t = torch.as_tensor(ids, device=device).long()
    emb = w_a2f["token_embedding"][ids_t][None].repeat(face.shape[0], 1, 1)
    d = emb.shape[-1]
    emb[:, id_pos] = torch.nn.functional.pad(face.to(emb.dtype), (0, d - face.shape[-1]))
    full = clip.encode(w_a2f, c_text, emb)
    start = min(max(id_pos, 0), full.shape[1] - NUM_VECTORS)
    return full, full[:, start:start + NUM_VECTORS]


def inverse_prompt(w_sbg: dict, c_text: dict, tok: Tokenizer, core: torch.Tensor, skip_weights) -> tuple:
    """The SubjBasisGenerator's face branch: core embeddings [B, 16, D] ->
    (its prompt embeddings [B, 77, D], the 16 subject vectors [B, 16, D],
    the position of the first)."""
    device = core.device
    ids = tok("photo of a " + ", " * NUM_VECTORS, max_length=c_text["max_positions"])[0]
    comma = np.where(ids == tok.encode_raw(",")[0])[0]
    start = min(int(comma[0]), len(ids) - NUM_VECTORS)
    ids_t = torch.as_tensor(ids, device=device).long()
    emb = w_sbg["prompt2token_proj.token_embedding"][ids_t][None].repeat(core.shape[0], 1, 1)
    emb = torch.cat([emb[:, :start], core.to(emb.dtype), emb[:, start + NUM_VECTORS:]], dim=1)
    out = clip.encode(w_sbg, c_text, emb, prefix="prompt2token_proj.", skip_weights=skip_weights)
    return out, out[:, start:start + NUM_VECTORS], start


def subject_vectors(w_a2f: dict, w_sbg: dict, c_text: dict, tok: Tokenizer, face: torch.Tensor) -> torch.Tensor:
    """faceid [1, F] -> subject vectors [16, D]."""
    _, core = arc2face(w_a2f, c_text, tok, face, max_length=22)
    _, subj, _ = inverse_prompt(w_sbg, c_text, tok, core, w_sbg["hidden_state_layer_weights"])
    return subj[0]


def contexts(w_text: dict, c_text: dict, tok: Tokenizer, subj: torch.Tensor, prompt: str,
             negative: str) -> tuple:
    """-> (cond [1, 77, D], uncond [1, 77, D]) of the prompt, whose 'z' is
    rewritten to the subject tokens, and of the negative prompt."""
    table = w_text["token_embedding"]
    extra = tok.vocab_size_with_added - table.shape[0]
    table = torch.cat([table, table.new_zeros(extra, table.shape[1])]) if extra > 0 else table.clone()
    table[torch.as_tensor(tok.convert_tokens_to_ids(tok.placeholders), device=table.device)] = subj.to(table.dtype)
    sw = torch.ones(2, dtype=table.dtype, device=table.device)
    out = []
    for text in (tok.rewrite(prompt), negative):
        ids = torch.as_tensor(tok(text, max_length=c_text["max_positions"]), device=table.device).long()
        out.append(clip.encode({**w_text, "token_embedding": table}, c_text, table[ids], skip_weights=sw))
    return tuple(out)
