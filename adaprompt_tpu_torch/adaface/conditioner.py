"""Placeholder tokens and the spliced prompt conditioning.

Port of `adaprompt_tpu/adaface/conditioner.py`: the host side
(`PlaceholderSpec`, `make_placeholders`, `find_placeholder_indices`), the
device path of training and sampling,

    token-embed -> splice subject vectors at the placeholders -> one CLIP
    encode over the L layers' prompts with the clip-skip weights
    -> [L, B, 77, D]

(`encode_spliced` on token ids and given placeholder rows, and
`PromptConditioner` on prompts, which finds the placeholders itself), plus
the training-time embedding noise (`add_noise_to_tensor`,
`add_noise_to_embedding`), whose gaussian draw comes from a
`torch.Generator` or is given as `noise`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from adaprompt_tpu_torch.utils.tokenizer import CLIPTokenizer


@dataclasses.dataclass(frozen=True)
class PlaceholderSpec:
    string: str            # e.g. 'z' (subject), 'y' (background)
    token_id: int
    num_vectors: int       # K vectors spliced starting at the placeholder
    is_bg: bool = False


def make_placeholders(tokenizer: CLIPTokenizer, subject_strings=("z",),
                      background_strings=("y",), num_vectors_subj: int = 16,
                      num_vectors_bg: int = 4) -> list[PlaceholderSpec]:
    """Specs of the placeholder strings; a string that is not one token of
    the vocabulary is added to the tokenizer as a new token."""
    def token_for(s):
        ids = tokenizer.encode_raw(s)
        if len(ids) == 1:
            return ids[0]
        tokenizer.add_tokens([s])
        return tokenizer.convert_tokens_to_ids([s])[0]

    specs = [PlaceholderSpec(s, token_for(s), num_vectors_subj, is_bg=False)
             for s in subject_strings]
    specs += [PlaceholderSpec(s, token_for(s), num_vectors_bg, is_bg=True)
              for s in background_strings or ()]
    return specs


def find_placeholder_indices(token_ids: np.ndarray, spec: PlaceholderSpec):
    """First occurrence of the placeholder per prompt (later ones are
    background). Returns (batch_idx [M], pos [M]) int32 numpy arrays, M the
    number of prompts that contain it."""
    b_idx, positions = [], []
    for i, row in enumerate(np.asarray(token_ids)):
        hits = np.where(row == spec.token_id)[0]
        if len(hits):
            b_idx.append(i)
            positions.append(int(hits[0]))
    return np.asarray(b_idx, np.int32), np.asarray(positions, np.int32)


def splice_subject_embeddings(token_embs: torch.Tensor, subj_embs: torch.Tensor, batch_idx,
                              positions, num_vectors: int) -> torch.Tensor:
    """Write K subject vectors into per-layer token embeddings, out of place.

    token_embs: [L, B, S, D] (L = 16 layerwise, or 1); subj_embs: [M, L', K, D]
    with L' in {1, L}; row m targets prompt batch_idx[m] at positions
    positions[m] .. positions[m] + K - 1."""
    L = token_embs.shape[0]
    dev = token_embs.device
    batch_idx = torch.as_tensor(batch_idx, device=dev).long()
    positions = torch.as_tensor(positions, device=dev).long()
    m = batch_idx.shape[0]
    if m == 0:
        return token_embs
    if subj_embs.shape[1] != L:
        subj_embs = subj_embs.expand(m, L, *subj_embs.shape[2:])
    shape = (L, m, num_vectors)
    li = torch.arange(L, device=dev)[:, None, None].expand(shape)
    bi = batch_idx[None, :, None].expand(shape)
    pi = (positions[None, :, None] + torch.arange(num_vectors, device=dev)[None, None]).expand(shape)
    vals = subj_embs[:, :, :num_vectors].transpose(0, 1)           # [L, M, K, D]
    return token_embs.index_put((li, bi, pi), vals.to(token_embs.dtype))


def encode_spliced(text, ids: torch.Tensor, subj_splices: list, skip_weights,
                   num_ca_layers: int, layerwise: bool = False) -> torch.Tensor:
    """Token-embed `ids` [B, S] with the encoder `text` (a CLIPTextModel),
    apply each (subj_embs [M, L', K, D], batch_idx [M], positions [M], K)
    splice, and encode the L * B prompts with the clip-skip weights
    -> [L, B, S, D]. L = num_ca_layers when `layerwise` or a splice has
    per-layer embeddings, else 1."""
    b = ids.shape[0]
    L = num_ca_layers if (layerwise or any(s[0].shape[1] > 1 for s in subj_splices)) else 1
    token_embs = text.token_embedding[ids]
    token_embs = token_embs[None].expand(L, *token_embs.shape)
    for subj_embs, bi, pos, k in subj_splices:
        token_embs = splice_subject_embeddings(token_embs, subj_embs, bi, pos, k)
    lb = token_embs.reshape(L * b, *token_embs.shape[2:])
    enc = text.encode(ids.repeat(L, 1), inputs_embeds=lb,
                      hidden_state_layer_weights=skip_weights)
    return enc.reshape(L, b, *enc.shape[1:])


class PromptConditioner:
    """Prompts and {placeholder string: subject embeddings [M, L', K, D]}
    -> the context [L, B, 77, D] of the text encoder `text` (a
    CLIPTextModel). L = num_ca_layers when `layerwise`, which by default is
    whether any embeddings differ by layer (L' > 1), else 1. A placeholder
    absent from every prompt is skipped; one row of embeddings serves every
    prompt that holds the placeholder, and fewer rows than such prompts are
    tiled."""

    def __init__(self, text, tokenizer: CLIPTokenizer, placeholders: list,
                 num_ca_layers: int = 16):
        self.text, self.tokenizer = text, tokenizer
        self.placeholders = {p.string: p for p in placeholders}
        self.num_ca_layers = num_ca_layers

    def tokenize(self, prompts) -> np.ndarray:
        return self.tokenizer(prompts, max_length=self.text.cfg.max_positions)

    def __call__(self, prompts, subj_embs_by_placeholder: dict | None = None,
                 skip_weights=(1.0, 1.0), layerwise: bool | None = None) -> torch.Tensor:
        ids_np = self.tokenize(prompts)
        b = ids_np.shape[0]
        subj_embs_by_placeholder = subj_embs_by_placeholder or {}
        if layerwise is None:
            layerwise = any(e.shape[1] > 1 for e in subj_embs_by_placeholder.values())
        L = self.num_ca_layers if layerwise else 1
        dev = self.text.token_embedding.device
        ids = torch.as_tensor(ids_np, device=dev).long()
        token_embs = self.text.token_embedding[ids]
        token_embs = token_embs[None].expand(L, *token_embs.shape)
        for name, embs in subj_embs_by_placeholder.items():
            spec = self.placeholders[name]
            bi, pos = find_placeholder_indices(ids_np, spec)
            if len(bi) == 0:
                continue
            if embs.shape[0] == 1 and len(bi) > 1:
                embs = embs.expand(len(bi), *embs.shape[1:])
            elif embs.shape[0] < len(bi):
                embs = embs.repeat(len(bi) // embs.shape[0], 1, 1, 1)
            token_embs = splice_subject_embeddings(token_embs, embs, bi, pos, spec.num_vectors)
        lb = token_embs.reshape(L * b, *token_embs.shape[2:])
        sw = torch.as_tensor(np.asarray(skip_weights, np.float32), device=dev)
        enc = self.text.encode(ids.repeat(L, 1), inputs_embeds=lb, hidden_state_layer_weights=sw)
        return enc.reshape(L, b, *enc.shape[1:])


def _gaussian(shape, like: torch.Tensor, gen: torch.Generator | None) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=like.device, dtype=like.dtype)


def add_noise_to_tensor(ts: torch.Tensor, noise_std, *, noise: torch.Tensor | None = None,
                        gen: torch.Generator | None = None) -> torch.Tensor:
    """Gaussian noise of std `noise_std` relative to the mean std of ts's
    last axis, the relative std taken without gradient; `noise_std` 0
    disables. The standard-normal draw is `noise` when given, else drawn
    from `gen`."""
    rel = ts.detach().std(dim=-1, correction=0).mean()
    noise = _gaussian(ts.shape, ts, gen) if noise is None else noise.to(ts.dtype)
    return ts + noise * (torch.as_tensor(noise_std, dtype=ts.dtype, device=ts.device) * rel)


def add_noise_to_embedding(embs: torch.Tensor, noise_std_range, training_percent: float,
                           prob_mask, *, noise: torch.Tensor | None = None,
                           gen: torch.Generator | None = None) -> torch.Tensor:
    """Annealed relative noise on subject embeddings: std = lo + (hi - lo) *
    training_percent, relative to the mean std of the last axis (with
    gradient); `prob_mask` ([M] 0/1) picks the rows that get it."""
    lo, hi = noise_std_range
    std = lo + (hi - lo) * training_percent
    rel = embs.std(dim=-1, correction=0).mean()
    noise = _gaussian(embs.shape, embs, gen) if noise is None else noise.to(embs.dtype)
    noise = noise * (std * rel)
    mask = torch.as_tensor(prob_mask, device=embs.device).to(embs.dtype)
    return embs + noise * mask.reshape((-1,) + (1,) * (embs.ndim - 1))
