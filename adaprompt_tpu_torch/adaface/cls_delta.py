"""Class-token spreading over the placeholder's slots.

Port of `adaprompt_tpu/adaface/cls_delta.py::distribute_embedding_layerwise`,
the one function of that module on the training path: in the class rows of
the compositional iterations' 4-type prompts, the class word's encoded
embedding is spread over the K slots that the subject placeholder takes in
the subject rows, divided by sqrt(K). The templates align "z" + K - 1 ", "
with "person" + K - 1 ", ", so the class word sits at the subject's position.
"""

from __future__ import annotations

import numpy as np
import torch

_DIVISORS = {"sqrt_M": np.sqrt, "M": float, "none": lambda k: 1.0, None: lambda k: 1.0}


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
