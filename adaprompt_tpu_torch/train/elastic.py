"""Elastic-matching fg/bg preservation losses of the compositional iterations.

Port of `adaprompt_tpu/train/elastic.py`: the image tokens of the comp
instances are soft-matched onto the single instances through q-feature
similarity, then
  * the subj-comp -> subj-single and mix-comp -> mix-single soft maps are
    aligned,
  * the subj-single fg features, rebuilt from the subj-comp features
    through the map, are cosine-matched with the originals,
  * subj-comp and mix-comp features are cosine-matched on inferred-background
    tokens,
  * subject attention on the comp instances' inferred-background tokens is
    suppressed.

Foreground columns are weighted by a binary mask rather than gathered, as in
the JAX package (the same values at static shapes). Standard deviations and
variances are population ones, except the running variance of the q
BatchNorm statistics, which is unbiased (n / (n - 1)).
"""

from __future__ import annotations

import numpy as np
import torch

from adaprompt_tpu_torch.adaface.gradient import grad_scale
from adaprompt_tpu_torch.train.compos import (FEAT_DISTILL_LAYER_WEIGHTS, _avg_pool,
                                              _layer_norm_free, _normalize_weights)
from adaprompt_tpu_torch.train.fgbg import bilinear_resize_torch, masked_mean, resize_mask_for_attn
from adaprompt_tpu_torch.train.losses import calc_ref_cosine_loss


def calc_elastic_matching_loss(ca_q: torch.Tensor, ca_outfeat: torch.Tensor, fg_mask: torch.Tensor,
                               *, fg_bg_cutoff_prob: float = 0.25,
                               single_q_grad_scale: float = 0.1,
                               single_feat_grad_scale: float = 0.01,
                               mix_feat_grad_scale: float = 0.05):
    """ca_q, ca_outfeat [4, C, N] (the 4-type batch, spatial flattened);
    fg_mask [1, 1, N] binary. -> (loss_map_align, loss_sc_ss_fg_match,
    loss_sc_mc_bg_match, sc_bg_prob, mc_bg_prob)."""
    fg = fg_mask.reshape(1, -1)                                        # [1, N]
    ss_q, sc_q, ms_q, mc_q = ca_q.chunk(4, dim=0)
    ss_q_gs = grad_scale(ss_q, single_q_grad_scale)
    ms_q_gs = grad_scale(ms_q, single_q_grad_scale)
    # matching probabilities, normalized over the comp tokens
    sc_map_ss = torch.softmax(torch.einsum("bci,bcj->bij", sc_q, ss_q_gs), dim=1)   # [1, Nc, Ns]
    mc_map_ms = torch.softmax(torch.einsum("bci,bcj->bij", mc_q, ms_q_gs), dim=1)
    ss_feat, sc_feat, ms_feat, mc_feat = ca_outfeat.chunk(4, dim=0)

    loss_map_align = masked_mean((sc_map_ss - mc_map_ms).abs(), fg[:, :, None] * fg[:, None, :])

    # the subj-single features rebuilt from subj-comp through the map, on fg columns
    sc_recon_ss = torch.einsum("bcn,bnj->bcj", sc_feat, sc_map_ss).transpose(1, 2)  # [1, Ns, C]
    ss_feat_gs = grad_scale(ss_feat.transpose(1, 2), single_feat_grad_scale)
    loss_sc_ss_fg_match = calc_ref_cosine_loss(
        sc_recon_ss, ss_feat_gs, emb_mask=fg[..., None], exponent=2, do_demean_first=False,
        first_n_dims_to_flatten=2, ref_grad_scale=1.0)

    # the probability each comp token maps into the single instance's fg
    fgf = fg.to(sc_map_ss.dtype)[..., None]                            # [1, N, 1]
    sc_fg_prob = torch.matmul(sc_map_ss, fgf).transpose(1, 2)          # [1, 1, Nc]
    mc_fg_prob = torch.matmul(mc_map_ms, fgf).transpose(1, 2)
    sc_bg_prob = torch.clamp(fg_bg_cutoff_prob - sc_fg_prob, min=0.0)
    mc_bg_prob = torch.clamp(fg_bg_cutoff_prob - mc_fg_prob, min=0.0)

    loss_sc_mc_bg_match = calc_ref_cosine_loss(
        sc_feat.transpose(1, 2), mc_feat.transpose(1, 2), emb_mask=mc_bg_prob.transpose(1, 2),
        exponent=2, do_demean_first=False, first_n_dims_to_flatten=2,
        ref_grad_scale=mix_feat_grad_scale)
    return loss_map_align, loss_sc_ss_fg_match, loss_sc_mc_bg_match, sc_bg_prob, mc_bg_prob


def calc_comp_fg_bg_preserve_loss(ca_outfeats: dict, ca_qs: dict, ca_attnscores: dict,
                                  fg_mask: torch.Tensor | None, subj_pos, block_size: int = 1,
                                  normalize_q_outfeat: bool = True):
    """ca_outfeats {layer: [4B, H, W, C]}; ca_qs {layer: [4B, heads, N, d]}
    (the UNet's q capture); ca_attnscores {layer: [4B, heads, Q, 77]};
    fg_mask [B, H0, W0, 1]; subj_pos the K subject token positions.

    With normalize_q_outfeat, q passes through an affine-free BatchNorm with
    batch statistics and the outfeats through an affine-free LayerNorm
    before the matching.

    -> ((loss_comp_single_map_align, loss_sc_ss_fg_match, 0 (mc-ms fg match),
         loss_sc_mc_bg_match, loss_comp_subj_bg_attn_suppress,
         loss_comp_mix_bg_attn_suppress),
        q_bn_stats {layer: (mean [C], unbiased var [C])}, detached, for the
        trainer's running BatchNorm statistics)."""
    first = next(iter(ca_outfeats.values()))
    zero = torch.zeros((), device=first.device)
    q_bn_stats: dict = {}
    if fg_mask is None:
        return (zero,) * 6, q_bn_stats
    w = _normalize_weights(FEAT_DISTILL_LAYER_WEIGHTS)
    mix_gs = 0.02
    l_map, l_scss, l_scmc, l_subj_sup, l_mix_sup = [], [], [], [], []
    pos = torch.as_tensor(np.asarray(subj_pos), device=first.device).long()

    for li, outfeat in ca_outfeats.items():
        if li not in w or li not in ca_qs:
            continue
        lw = w[li]
        q = ca_qs[li]
        b4, heads, n, d = q.shape
        qh = int(np.sqrt(n))
        # [4B, heads, N, d] -> NHWC [4B, qh, qh, heads * d]
        q_sp = q.transpose(2, 3).reshape(b4, heads * d, qh, qh).permute(0, 2, 3, 1)
        if normalize_q_outfeat:
            q_mean = q_sp.mean(dim=(0, 1, 2))
            q_var = q_sp.var(dim=(0, 1, 2), correction=0)
            cnt = q_sp.shape[0] * q_sp.shape[1] * q_sp.shape[2]
            q_bn_stats[li] = (q_mean.detach(), (q_var * cnt / max(cnt - 1, 1)).detach())
            q_sp = (q_sp - q_mean) * torch.rsqrt(q_var + 1e-5)

        of = outfeat
        if tuple(of.shape[1:3]) != tuple(q_sp.shape[1:3]):
            of = bilinear_resize_torch(of, tuple(q_sp.shape[1:3]))
        if normalize_q_outfeat:
            of = _layer_norm_free(of)

        pool = (lambda x: _avg_pool(x, 4, 2)) if of.shape[1] > 8 else (lambda x: x)
        q_pooled, of_pooled = pool(q_sp), pool(of)
        q_flat = q_pooled.reshape(b4, -1, q_pooled.shape[-1]).transpose(1, 2)    # [4B, C, N]
        of_flat = of_pooled.reshape(b4, -1, of_pooled.shape[-1]).transpose(1, 2)

        fg4 = resize_mask_for_attn(fg_mask[:block_size], of.shape[1])
        fg_bin = (pool(fg4).reshape(1, 1, -1) > 1e-6).float()
        any_fg = (fg_bin.sum() > 0).float()

        loss_map, loss_scss, loss_scmc, sc_bg_prob, mc_bg_prob = \
            calc_elastic_matching_loss(q_flat, of_flat, fg_bin)
        l_map.append(loss_map * lw * any_fg)
        l_scss.append(loss_scss * lw * any_fg)
        l_scmc.append(loss_scmc * lw * any_fg)

        # subject attention on the inferred-background tokens
        subj_attn = ca_attnscores[li][:, :, :, pos].sum(dim=-1)         # [4B, heads, Q]
        hh = int(np.sqrt(subj_attn.shape[-1]))
        sa = subj_attn.reshape(b4, subj_attn.shape[1], hh, hh).permute(0, 2, 3, 1)
        if tuple(sa.shape[1:3]) != tuple(of.shape[1:3]):
            sa = bilinear_resize_torch(sa, tuple(of.shape[1:3]))
        sa = pool(sa)
        sa = sa.reshape(b4, -1, sa.shape[-1]).transpose(1, 2)            # [4B, heads, N]
        ss_a, sc_a, ms_a, mc_a = sa.chunk(4, dim=0)
        mc_a_gs = grad_scale(mc_a, mix_gs)
        l_subj_sup.append(masked_mean(torch.relu(sc_a), sc_bg_prob) * lw * any_fg)
        l_mix_sup.append(masked_mean(torch.relu(mc_a_gs), mc_bg_prob) * lw * any_fg)

    s = lambda xs: sum(xs) if xs else zero
    return (s(l_map), s(l_scss), zero, s(l_scmc), s(l_subj_sup), s(l_mix_sup)), q_bn_stats
