"""Training losses.

Port of `adaprompt_tpu/train/losses.py`: `calc_recon_loss`, the loss of
the reconstruction and Arc2Face-distillation iterations; the masked cosine
alignment `calc_ref_cosine_loss` (with `demean`) that the fg/bg attention
regularizers of `train/fgbg.py` and the compositional losses use;
`ortho_subtract`, which removes from `a` its projection onto `b`; and
`calc_prompt_emb_delta_loss`, the compositional iterations' alignment of
(subj_comp - subj_single) with (cls_comp - cls_single) in prompt space.
"""

from __future__ import annotations

import torch

from adaprompt_tpu_torch.adaface.gradient import grad_scale


def ortho_subtract(a: torch.Tensor, b: torch.Tensor, on_last_n_dims: int = 1) -> torch.Tensor:
    """a - b * (<a, b> / <b, b>) over the last n dims (broadcasting allowed)."""
    if on_last_n_dims > 1:
        a, b = torch.broadcast_tensors(a, b)
        shape = a.shape
        a = a.reshape(*a.shape[:-on_last_n_dims], -1)
        b = b.reshape(*b.shape[:-on_last_n_dims], -1)
    w = (a * b).sum(dim=-1) / ((b * b).sum(dim=-1) + 1e-6)
    res = a - b * w[..., None]
    return res.reshape(shape) if on_last_n_dims > 1 else res


def demean(x: torch.Tensor, dim=-1) -> torch.Tensor:
    return x - x.mean(dim=dim, keepdim=True)


def _safe_norm(x: torch.Tensor, dim=-1) -> torch.Tensor:
    """L2 norm whose gradient is 0 (not NaN) at the zero vector: masked-out
    rows are exactly zero."""
    sq = (x * x).sum(dim=dim)
    return torch.sqrt(torch.maximum(sq, sq.new_tensor(1e-24)))


def _cosine_embedding_loss(a: torch.Tensor, b: torch.Tensor, label: int = 1) -> torch.Tensor:
    """F.cosine_embedding_loss(reduction='none') with margin 0."""
    cos = (a * b).sum(dim=-1) / (_safe_norm(a) * _safe_norm(b) + 1e-12)
    if label == 1:
        return 1.0 - cos
    return torch.maximum(cos, torch.zeros_like(cos))


def calc_ref_cosine_loss(delta: torch.Tensor, ref_delta: torch.Tensor, *,
                         emb_mask: torch.Tensor | None = None,
                         batch_mask: torch.Tensor | None = None,
                         exponent: float = 2.0, do_demean_first: bool = False,
                         first_n_dims_to_flatten: int = 3, ref_grad_scale: float = 0.0,
                         aim_to_align: bool = True, margin: float = 0.0) -> torch.Tensor:
    """Masked cosine alignment of `delta` with the grad-scaled, signed power
    `exponent` of `ref_delta`. delta, ref_delta: [B, ..., D]; emb_mask
    broadcastable to the first `first_n_dims_to_flatten` dims (weights,
    zeros drop embeddings); batch_mask [B] 0/1; the per-row loss less
    `margin`, floored at 0."""
    b = delta.shape[0]
    lead = tuple(delta.shape[:first_n_dims_to_flatten])
    d = delta.reshape(b, -1, delta.shape[-1])
    rd = ref_delta.expand(delta.shape).reshape(b, -1, delta.shape[-1])
    if do_demean_first:
        d, rd = demean(d), demean(rd)
    rd = grad_scale(rd, ref_grad_scale)
    rd_pow = rd * rd.abs() ** (exponent - 1)
    losses = _cosine_embedding_loss(d, rd_pow, 1 if aim_to_align else -1)    # [B, N]
    if emb_mask is not None:
        m = emb_mask.expand(lead + (1,)).reshape(b, -1).to(losses.dtype)
        per = (losses * m).sum(dim=-1) / (m.sum(dim=-1) + 1e-8)
    else:
        per = losses.mean(dim=-1)
    if margin > 0:
        per = torch.maximum(per - margin, torch.zeros_like(per))
    if batch_mask is None:
        return per.mean()
    batch_mask = batch_mask.to(per.dtype)
    return (per * batch_mask).sum() / torch.maximum(batch_mask.sum(), per.new_tensor(1e-8))


def calc_prompt_emb_delta_loss(static_embeddings: torch.Tensor,
                               prompt_emb_mask: torch.Tensor | None,
                               cls_delta_grad_scale: float = 0.05) -> torch.Tensor:
    """static_embeddings [4B', L, 77, D] stacked as (subj_single, subj_comp,
    cls_single, cls_comp); prompt_emb_mask [4B', 77, 1] (BOS excluded here)."""
    ss, sc, cs, cc = static_embeddings.chunk(4, dim=0)
    weighted = None
    if prompt_emb_mask is not None:
        mask = torch.cat([torch.zeros_like(prompt_emb_mask[:, :1]), prompt_emb_mask[:, 1:]], dim=1)
        m_ss, m_sc, _, _ = mask.chunk(4, dim=0)
        weighted = ((m_ss + m_sc) ** 2 / 4.0)[:, None]               # [B', 1, 77, 1]
    return calc_ref_cosine_loss(ortho_subtract(sc, ss), ortho_subtract(cc, cs),
                                emb_mask=weighted, do_demean_first=True,
                                first_n_dims_to_flatten=3, ref_grad_scale=cls_delta_grad_scale,
                                aim_to_align=True)


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
