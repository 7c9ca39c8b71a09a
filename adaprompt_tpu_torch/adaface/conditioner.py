"""Placeholder tokens of the prompt conditioning.

Port of the host-side part of `adaprompt_tpu/adaface/conditioner.py`:
`PlaceholderSpec`, `make_placeholders` and `find_placeholder_indices`. The
splice-and-encode path (`encode_spliced`, `PromptConditioner`) comes with
the recon and serving slices.
"""

from __future__ import annotations

import dataclasses

import numpy as np

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
