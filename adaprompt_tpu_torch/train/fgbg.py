"""Foreground/background attention regularizers of the recon iterations.

Port of `adaprompt_tpu/train/fgbg.py`:
  * calc_fg_mb_suppress_loss: suppress subject-token attention on the mask
    background (margin 0.4 above the average foreground score);
  * calc_fg_bg_complementary_loss: background-token attention orthogonal to
    subject-token attention, plus the mf/mb margin-contrast terms;
  * calc_fg_bg_xlayer_consist_loss: each layer's subject (background)
    attention map aligned with the layer below it (cosine after demeaning,
    the larger map resized bilinearly to the smaller grid);
  * masked_mean, resize_mask_for_attn and bilinear_resize_torch.

Attention-score captures are [B, heads, Q, 77] (`UNet(capture_ca=True)`'s
"attnscore"); a token selection sums over the K embeddings of the subject
or background placeholder.
"""

from __future__ import annotations

import numpy as np
import torch

from adaprompt_tpu_torch.adaface.gradient import grad_scale
from adaprompt_tpu_torch.models.vae import _resize_mask_nearest
from adaprompt_tpu_torch.train.losses import calc_ref_cosine_loss

ATTN_ALIGN_LAYER_WEIGHTS = {7: 0.5, 8: 0.5, 12: 1., 16: 1., 17: 1., 18: 1.,
                            19: 1., 20: 1., 21: 1., 22: 1., 23: 1., 24: 1.}
XLAYER_WEIGHTS = {8: 0.5, 12: 1., 16: 1., 17: 1., 18: 1., 19: 0.5, 20: 0.5,
                  21: 0.5, 22: 0.25, 23: 0.25, 24: 0.25}
XLAYER_MAPS = {8: 7, 12: 8, 16: 12, 17: 16, 18: 17, 19: 18, 20: 19, 21: 20,
               22: 21, 23: 22, 24: 23}


def _zero(ca_attnscores: dict) -> torch.Tensor:
    return torch.zeros((), device=next(iter(ca_attnscores.values())).device
                       if ca_attnscores else None)


def _norm_w(d):
    s = sum(d.values())
    return {k: v / s for k, v in d.items()}


def bilinear_resize_torch(x: torch.Tensor, out_hw: tuple) -> torch.Tensor:
    """F.interpolate(mode='bilinear', align_corners=False) semantics, point
    sampled without antialiasing, as the JAX package's gather form. x:
    [B, H, W, C]."""
    b, h, w, c = x.shape
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return x

    def axis_weights(in_size, out_size):
        src = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
        src = np.clip(src, 0, in_size - 1)
        lo = np.floor(src).astype(np.int64)
        hi = np.minimum(lo + 1, in_size - 1)
        frac = torch.as_tensor((src - lo).astype(np.float32), device=x.device)
        return torch.as_tensor(lo, device=x.device), torch.as_tensor(hi, device=x.device), frac

    ylo, yhi, yf = axis_weights(h, oh)
    xlo, xhi, xf = axis_weights(w, ow)
    yf = yf[None, :, None, None]
    xf = xf[None, None, :, None]
    top = x[:, ylo][:, :, xlo] * (1 - xf) + x[:, ylo][:, :, xhi] * xf
    bot = x[:, yhi][:, :, xlo] * (1 - xf) + x[:, yhi][:, :, xhi] * xf
    return top * (1 - yf) + bot * yf


def masked_mean(ts: torch.Tensor, mask: torch.Tensor | None, dim=None,
                keepdim: bool = False) -> torch.Tensor:
    if mask is None:
        return ts.mean()
    mask = mask.to(ts.dtype).expand(ts.shape)
    denom = torch.clamp(mask.sum(dim=dim, keepdim=keepdim), min=1e-6)
    return (ts * mask).sum(dim=dim, keepdim=keepdim) / denom


def resize_mask_for_attn(mask: torch.Tensor, target_hw: int) -> torch.Tensor:
    """fg_mask [B, H0, W0, 1] -> [B, target, target, 1], the larger of the
    nearest and the bilinear resize."""
    near = _resize_mask_nearest(mask, (target_hw, target_hw))
    bili = bilinear_resize_torch(mask.float(), (target_hw, target_hw))
    return torch.maximum(near.float(), bili)


def _select_score(attnscore: torch.Tensor, pos) -> torch.Tensor:
    """[B, heads, Q, 77] and K token positions -> summed [B, heads, Q]; pos
    [K] (shared by the rows) or [B, K] (per row)."""
    pos = torch.as_tensor(pos, device=attnscore.device).long()
    if pos.ndim == 2:
        b = attnscore.shape[0]
        idx = pos[:b, None, None, :].expand(*attnscore.shape[:3], pos.shape[-1])
        return torch.gather(attnscore, -1, idx).sum(dim=-1)
    return attnscore[:, :, :, pos].sum(dim=-1)


def _margin_excess_mean(score, margin, avg_ref):
    excess = score + margin - avg_ref
    return masked_mean(excess, excess > 0)


def _fg_bg_masks(subj_score: torch.Tensor, fg_mask: torch.Tensor, block_size: int):
    """(fg3, bg3, valid): valid is 0, skipping the layer, when some row's
    foreground or background mask is empty."""
    hw = int(np.sqrt(subj_score.shape[-1]))
    m = resize_mask_for_attn(fg_mask, hw).reshape(block_size, 1, hw * hw).expand(subj_score.shape)
    fg3 = (m > 1e-6).float()
    bg3 = 1.0 - fg3
    valid = ((fg3.sum(dim=(1, 2)) > 0).all() & (bg3.sum(dim=(1, 2)) > 0).all()).float()
    return fg3, bg3, valid


def calc_fg_mb_suppress_loss(ca_attnscores: dict, subj_pos, block_size: int,
                             fg_mask: torch.Tensor | None) -> torch.Tensor:
    """The subject's attention on the mask background above the foreground's
    average less 0.4, per layer weighted."""
    if fg_mask is None:
        return _zero(ca_attnscores)
    w = _norm_w(ATTN_ALIGN_LAYER_WEIGHTS)
    scale, margin = 0.05, 0.4
    losses = []
    for li, score in ca_attnscores.items():
        if li not in w:
            continue
        subj = _select_score(score[:block_size], subj_pos)
        fg3, bg3, valid = _fg_bg_masks(subj, fg_mask[:block_size], block_size)
        s_mf = grad_scale(subj * fg3, 0.5)
        s_mb = subj * bg3
        avg_mf = masked_mean(s_mf, fg3, dim=(1, 2), keepdim=True)
        losses.append(_margin_excess_mean(s_mb, margin, avg_mf) * w[li] * scale * valid)
    return sum(losses) if losses else _zero(ca_attnscores)


def calc_fg_bg_complementary_loss(ca_attnscores: dict, subj_pos, bg_pos, block_size: int, *,
                                  fg_grad_scale: float = 0.1,
                                  fg_mask: torch.Tensor | None = None):
    """-> (loss_fg_bg_complementary, loss_subj_mb_suppress,
    loss_bg_mf_suppress, loss_fg_bg_mask_contrast); without background
    positions, (0, calc_fg_mb_suppress_loss, 0, 0)."""
    zero = _zero(ca_attnscores)
    if subj_pos is None:
        return zero, zero, zero, zero
    if bg_pos is None:
        return zero, calc_fg_mb_suppress_loss(ca_attnscores, subj_pos, block_size,
                                              fg_mask), zero, zero

    w = _norm_w(ATTN_ALIGN_LAYER_WEIGHTS)
    # the leading size of the positions: K for [K], B for per-row [B, K]
    k_fg, k_bg = len(subj_pos), len(bg_pos)
    subj_mb_scale, bg_mf_scale, contrast_scale = 0.05, 0.1, 0.05
    mfmb_margin = 0.4
    subj_bg_at_mf_margin = 0.4 * k_fg / k_bg
    bg_subj_at_mb_margin = 0.4

    l_comple, l_subj_mb, l_bg_mf, l_contrast = [], [], [], []
    for li, score in ca_attnscores.items():
        if li not in w:
            continue
        subj = _select_score(score[:block_size], subj_pos)      # [B, h, Q]
        bg = _select_score(score[:block_size], bg_pos)
        l_comple.append(calc_ref_cosine_loss(
            bg, subj, exponent=2, do_demean_first=False, first_n_dims_to_flatten=2,
            ref_grad_scale=fg_grad_scale, aim_to_align=False) * w[li])
        if fg_mask is None:
            continue
        fg3, bg3, valid = _fg_bg_masks(subj, fg_mask[:block_size], block_size)
        s_mf = grad_scale(subj * fg3, 0.5)
        b_mf = bg * fg3
        s_mb = subj * bg3
        b_mb = bg * bg3
        avg_s_mf = masked_mean(s_mf, fg3, dim=(1, 2), keepdim=True)
        avg_b_mb = masked_mean(b_mb, bg3, dim=(1, 2), keepdim=True)
        l_subj_mb.append(_margin_excess_mean(s_mb, mfmb_margin, avg_s_mf)
                         * w[li] * subj_mb_scale * valid)
        l_bg_mf.append(_margin_excess_mean(b_mf, mfmb_margin, avg_b_mb)
                       * w[li] * bg_mf_scale * valid)
        c1 = _margin_excess_mean(b_mf, subj_bg_at_mf_margin, avg_s_mf)
        c2 = _margin_excess_mean(s_mb, bg_subj_at_mb_margin, avg_b_mb)
        l_contrast.append((c1 + c2) * w[li] * contrast_scale * valid)

    s = lambda xs: sum(xs) if xs else zero
    return s(l_comple), s(l_subj_mb), s(l_bg_mf), s(l_contrast)


def calc_fg_bg_xlayer_consist_loss(ca_attnscores: dict, subj_pos, bg_pos, ssb_size: int):
    """-> (loss_fg_xlayer, loss_bg_xlayer), the second 0 without bg_pos."""
    w = _norm_w(XLAYER_WEIGHTS)
    zero = _zero(ca_attnscores)
    l_fg, l_bg = [], []

    def layer_attn(score, pos):
        # mean over heads, sum over the K tokens -> [SSB, Q]
        return _select_score(score[:ssb_size], pos).mean(dim=1)

    for li, score in ca_attnscores.items():
        if li not in w or XLAYER_MAPS.get(li) not in ca_attnscores:
            continue
        score_x = ca_attnscores[XLAYER_MAPS[li]]

        def pair_loss(pos):
            a = layer_attn(score, pos)
            b = layer_attn(score_x, pos)
            if b.shape[-1] > a.shape[-1]:
                a, b = b, a
            h = int(np.sqrt(a.shape[-1]))
            hx = int(np.sqrt(b.shape[-1]))
            a2 = bilinear_resize_torch(a.reshape(ssb_size, h, h, 1), (hx, hx))
            return calc_ref_cosine_loss(a2.reshape(ssb_size, hx * hx), b, exponent=2,
                                        do_demean_first=True, first_n_dims_to_flatten=1,
                                        ref_grad_scale=1.0, aim_to_align=True)

        l_fg.append(pair_loss(subj_pos) * w[li])
        if bg_pos is not None:
            l_bg.append(pair_loss(bg_pos) * w[li])

    return (sum(l_fg) if l_fg else zero, sum(l_bg) if l_bg else zero)
