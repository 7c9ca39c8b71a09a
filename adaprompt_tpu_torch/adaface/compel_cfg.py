"""Compel-style CFG prompt weighting.

Port of `adaprompt_tpu/adaface/compel_cfg.py` (the reference's
prob_apply_compel_cfg): push the conditioning embeddings away from the
empty prompt's by 1.1**level (the compel library's attention-weight
convention), optionally per instance (`batch_mask`) and sparing given token
positions. The coin and the level's draw stay with the caller, who passes
the level (`txt2img --compel_cfg_weight_level`).
"""

from __future__ import annotations

import torch


def apply_compel_cfg(context: torch.Tensor, empty_context: torch.Tensor,
                     weight_level: float, skipped_token_pos=None,
                     batch_mask: torch.Tensor | None = None) -> torch.Tensor:
    """context [..., B, S, D]; empty_context broadcastable to it:
    (context - empty) * 1.1**weight_level + empty, the `skipped_token_pos`
    rows left as they were, and only where `batch_mask` [B] is 1."""
    out = (context - empty_context) * 1.1 ** weight_level + empty_context
    if skipped_token_pos is not None:
        pos = torch.as_tensor(skipped_token_pos, device=context.device).long()
        out = out.clone()
        out[..., pos, :] = context[..., pos, :]
    if batch_mask is not None:
        m = batch_mask.reshape(-1, 1, 1).to(context.dtype)
        out = out * m + context * (1.0 - m)
    return out
