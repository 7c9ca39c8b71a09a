"""Training losses.

Port of `adaprompt_tpu/train/losses.py::calc_recon_loss`, the loss of the
reconstruction and Arc2Face-distillation iterations. The compositional
losses come with the compositional slice.
"""

from __future__ import annotations

import torch


def calc_recon_loss(model_output: torch.Tensor, target: torch.Tensor,
                    img_mask: torch.Tensor | None, fg_mask: torch.Tensor | None,
                    fg_pixel_weight: float = 1.0, bg_pixel_weight: float = 1.0) -> torch.Tensor:
    """img/fg-weighted MSE over NHWC latents, in float32. Masks: [B, H, W, 1]."""
    ones = lambda: torch.ones_like(model_output[..., :1], dtype=torch.float32)
    img_mask = ones() if img_mask is None else img_mask.float()
    fg_mask = ones() if fg_mask is None else fg_mask.float()
    mo = model_output.float() * img_mask
    tg = target.float() * img_mask
    se = (mo - tg) ** 2
    wfg = (fg_mask * img_mask * fg_pixel_weight).expand(se.shape)
    wbg = ((1.0 - fg_mask) * img_mask * bg_pixel_weight).expand(se.shape)
    return ((se * wfg).sum() + (se * wbg).sum()) / (wfg.sum() + wbg.sum() + 1e-6)
