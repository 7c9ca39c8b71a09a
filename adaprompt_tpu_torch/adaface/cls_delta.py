"""Class-delta token machinery.

Class prompts replace the subject placeholder with a class string (e.g.
"person") that may tokenize to several tokens; to keep class prompts
token-aligned with subject prompts, the class-delta tokens are merged into
one embedding and the tail shifted left. Port of
`adaprompt_tpu/adaface/cls_delta.py`:

  * `scan_cls_delta_strings`: host-side numpy scan of the class half of a
    compositional batch for the class-delta token sequence near the subject
    position;
  * `merge_cls_token_embeddings`: the weighted average of the M class-delta
    embeddings into one, the rest of the row shifted left by M - 1 (the EOS
    slot kept), the offsets adding up over several deltas in one row;
  * `distribute_embedding_to_M_tokens`: a multi-vector subject's class
    embedding spread over its M placeholder slots, divided by sqrt(M), M or 1;
  * `distribute_embedding_layerwise`, the one of these on the training path:
    in the class rows of the compositional iterations' 4-type prompts, the
    class word's encoded embedding is spread over the K slots that the
    subject placeholder takes in the subject rows, divided by sqrt(K). The
    templates align "z" + K - 1 ", " with "person" + K - 1 ", ", so the class
    word sits at the subject's position.

Each works on a tensor on its own device, out of place. The merge and the
spread divide by a tensor and sum the weighted rows one at a time, so a
card and the CPU give the same bits (a CUDA division by a host scalar is a
multiplication by its reciprocal).
"""

from __future__ import annotations

import numpy as np
import torch

_DIVISORS = {"sqrt_M": np.sqrt, "M": float, "none": lambda k: 1.0, None: lambda k: 1.0}


def scan_cls_delta_strings(tokenized_text, placeholder_bi, placeholder_pos,
                           subj_name_to_cls_delta_tokens: dict, max_search_span: int = 5):
    """Host-side. tokenized_text [B, S] (numpy or a tensor); (placeholder_bi,
    placeholder_pos): first-occurrence subject indices (the first half of
    the batch). Returns [(batch_i, start, M, subj_name), ...] for the class
    half: in each class row, the first of the class strings found at the
    subject's position or up to `max_search_span` tokens after it."""
    if not subj_name_to_cls_delta_tokens:
        return []
    if isinstance(tokenized_text, torch.Tensor):
        tokenized_text = tokenized_text.cpu().numpy()
    tokenized_text = np.asarray(tokenized_text)
    bs = tokenized_text.shape[0]
    if len(placeholder_bi) == bs:
        return []
    half = bs // 2
    out = []
    for batch_i in range(half, bs):
        row = tokenized_text[batch_i]
        start_index = int(placeholder_pos[batch_i - half])
        found = False
        for j in range(max_search_span + 1):
            start = start_index + j
            for subj_name, toks in subj_name_to_cls_delta_tokens.items():
                toks = np.asarray(toks)
                m = len(toks)
                if start + m <= len(row) and (row[start:start + m] == toks).all():
                    out.append((batch_i, start, m, subj_name))
                    found = True
                    break
            if found:
                break
    return out


def merge_cls_token_embeddings(prompt_embedding: torch.Tensor, cls_delta_string_indices: list,
                               subj_name_to_cls_delta_token_weights: dict) -> torch.Tensor:
    """prompt_embedding [B, S, D] (or [B*L, S, D]); the indices from
    `scan_cls_delta_strings`. In each affected row the M class-delta
    embeddings become their weighted sum at the first slot, and the tokens
    after them (read from the input, up to the EOS slot) move left by M - 1,
    past the slots that earlier deltas of the row freed."""
    if not cls_delta_string_indices:
        return prompt_embedding
    s = prompt_embedding.shape[1]
    out = prompt_embedding.clone()
    batch_i2offset: dict = {}
    for batch_i, start, m, subj_name in sorted(cls_delta_string_indices,
                                               key=lambda x: (x[0], x[1])):
        i_off = batch_i2offset.get(batch_i, 0)
        w = torch.as_tensor(np.asarray(subj_name_to_cls_delta_token_weights[subj_name],
                                       np.float32), device=prompt_embedding.device)
        w = w.to(prompt_embedding.dtype)
        cls_embs = prompt_embedding[batch_i, start:start + m]
        avg = cls_embs[0] * w[0]
        for i in range(1, m):
            avg = avg + cls_embs[i] * w[i]
        out[batch_i, start - i_off] = avg
        seg = prompt_embedding[batch_i, start + m:s - 1]
        dst = start + 1 - i_off
        out[batch_i, dst:dst + seg.shape[0]] = seg
        batch_i2offset[batch_i] = i_off + m - 1
    return out


def distribute_embedding_to_M_tokens(text_embedding: torch.Tensor, placeholder_pos,
                                     divide_scheme: str = "sqrt_M") -> torch.Tensor:
    """text_embedding [B, S, D]; placeholder_pos: the M token positions
    (host). The first slot's embedding / d is written into all M slots,
    d = sqrt(M) ("sqrt_M"), M ("M") or 1."""
    pos = np.unique(np.asarray(placeholder_pos))
    m = len(pos)
    if m <= 1:
        return text_embedding
    d = torch.tensor(float(_DIVISORS[divide_scheme](m)), dtype=text_embedding.dtype,
                     device=text_embedding.device)
    first = text_embedding[:, int(pos[0]):int(pos[0]) + 1]
    out = text_embedding.clone()
    out[:, torch.as_tensor(pos, device=text_embedding.device)] = (first / d).expand(
        -1, m, -1).to(text_embedding.dtype)
    return out


def distribute_embedding_layerwise(ctx: torch.Tensor, rows, pos0: torch.Tensor, k: int,
                                   divide_scheme: str = "sqrt_M") -> torch.Tensor:
    """ctx [L, B, S, D]; `rows` the batch rows (host ints) whose class word
    sits at pos0[r] ([m] tensor). Writes the embedding at pos0 / d into the
    k slots pos0 .. pos0 + k - 1 of every layer, out of place; d is sqrt(k)
    ("sqrt_M"), k ("M") or 1."""
    rows = torch.as_tensor(np.asarray(rows), device=ctx.device).long()
    m = rows.shape[0]
    L, _, _, D = ctx.shape
    d = float(_DIVISORS[divide_scheme](k))
    pos0 = pos0.to(ctx.device).long()
    sel = ctx[:, rows]                                                 # [L, m, S, D]
    col0 = torch.gather(sel, 2, pos0.reshape(1, m, 1, 1).expand(L, m, 1, D))
    repl = (col0 / d).expand(L, m, k, D)
    shape = (L, m, k)
    li = torch.arange(L, device=ctx.device)[:, None, None].expand(shape)
    bi = rows[None, :, None].expand(shape)
    pi = (pos0[None, :, None] + torch.arange(k, device=ctx.device)[None, None]).expand(shape)
    return ctx.index_put((li, bi, pi), repl.to(ctx.dtype))
