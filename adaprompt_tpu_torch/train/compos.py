"""Compositional ("mix prompt") distillation: the Stage-2 losses.

Port of `adaprompt_tpu/train/compos.py`:
  * mix_static_vk_embeddings: the mixed class-prompt V and K contexts. At
    the subject token positions the class embedding is blended with the
    subject embedding by layer (V: class scale 1.0 -> 0.7 over the sync
    layers, K: 1.0); the mixes are grad-scaled by 0.05, then blended with
    the subject context by a t-dependent layer mask;
  * calc_delta_alignment_loss, convert_attn_to_spatial_weight;
  * calc_prompt_mix_loss: feature-delta alignment, subject-attention delta
    alignment and attention-norm distillation over the captured
    cross-attention activations of the 4-type batch (subj_single,
    subj_comp, mix_single, mix_comp);
  * the CLIP teacher filter's operating point (clip_teachability,
    select_teachable_candidate).

Captures are NHWC outfeats [4B, H, W, C] and attention scores [4B, heads,
Q, 77]; the 4-type batch is ordered (subj_single, subj_comp, mix_single,
mix_comp) along dim 0, BLOCK_SIZE rows a type. Standard deviations and
variances are population ones (correction=0), as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from adaprompt_tpu_torch.adaface.gradient import grad_scale
from adaprompt_tpu_torch.train.fgbg import bilinear_resize_torch
from adaprompt_tpu_torch.train.losses import calc_ref_cosine_loss, ortho_subtract

SYNC_LAYER_CA_INDICES = (4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)  # CA idx of layers 7..24

FEAT_DISTILL_LAYER_WEIGHTS = {7: 0.5, 8: 0.5, 12: 1., 16: 1., 17: 1., 18: 1.,
                              19: 1., 20: 1., 21: 1., 22: 1., 23: 1., 24: 1.}
ATTN_DELTA_LAYER_WEIGHTS = dict(FEAT_DISTILL_LAYER_WEIGHTS)
ATTN_NORM_LAYER_WEIGHTS = dict(FEAT_DISTILL_LAYER_WEIGHTS)
FEAT_SIZE2POOLER_SPEC = {8: (4, 2), 16: (4, 2), 32: (8, 4), 64: (8, 4)}

# the teacher filter's operating point
CLIP_LOSS_THRESHOLD = 0.28
CLIP_LOSS_MARGIN = 0.002


def _normalize_weights(d):
    s = sum(d.values())
    return {k: v / s for k, v in d.items()}


def layer_cls_mix_scales(bs: int, scale_range, n_ca_layers: int = 16,
                         sync_layers=SYNC_LAYER_CA_INDICES, device=None) -> torch.Tensor:
    """[BS, L] class-embedding mix scales by layer: 1 outside the sync
    layers, a linear ramp from scale_range[0] to scale_range[1] over them."""
    first, final = scale_range
    scales = np.ones((bs, n_ca_layers), np.float32)
    step = (final - first) / (len(sync_layers) - 1)
    scales[:, list(sync_layers)] = first + np.arange(len(sync_layers)) * step
    return torch.as_tensor(scales, device=device)


def _mix_at_indices(cls_emb, subj_emb, subj_pos, cls_scales):
    """The class embedding everywhere except at the subject token positions,
    where cls * scale + subj * (1 - scale). [L, B, S, D]; cls_scales [B, L]."""
    L, B, S, _ = cls_emb.shape
    pos = torch.as_tensor(np.asarray(subj_pos), device=cls_emb.device).long()
    scale = torch.ones((L, B, S, 1), dtype=cls_emb.dtype, device=cls_emb.device)
    scale[:, :, pos] = cls_scales.T.to(scale)[:, :, None, None].expand(L, B, pos.shape[0], 1)
    return cls_emb * scale + subj_emb * (1.0 - scale)


def mix_static_vk_embeddings(subj_emb: torch.Tensor, cls_emb: torch.Tensor, subj_pos,
                             t_frac: torch.Tensor, training_percent, *,
                             k_cls_scale_range=(1.0, 1.0), v_cls_scale_range=(1.0, 0.7),
                             sync_layers=SYNC_LAYER_CA_INDICES,
                             prompt_mix_grad_scale: float = 0.05):
    """subj_emb, cls_emb [L, B, S, D] (the subject and class contexts of the
    same prompts); subj_pos the subject embeddings' token positions (host);
    t_frac [B] t / T. -> (mix_v, mix_k), each [L, B, S, D]: the V and K
    contexts of the mix half of the compositional batch (the subject half
    keeps subj_emb for both)."""
    L, B = subj_emb.shape[:2]
    dev = subj_emb.device
    v_scales = layer_cls_mix_scales(B, v_cls_scale_range, L, sync_layers, device=dev)
    k_scales = layer_cls_mix_scales(B, k_cls_scale_range, L, sync_layers, device=dev)
    mix_v = grad_scale(_mix_at_indices(cls_emb, subj_emb, subj_pos, v_scales),
                       prompt_mix_grad_scale)
    mix_k = grad_scale(_mix_at_indices(cls_emb, subj_emb, subj_pos, k_scales),
                       prompt_mix_grad_scale)
    # the sync layers take 1 - t_frac * (1 - training_percent * 0.3) of the
    # subject embedding
    lm = torch.zeros(L, device=dev)
    lm[list(sync_layers)] = 1.0
    subj_frac = 1.0 - t_frac.float()[None, :, None, None] * (1.0 - training_percent * 0.3)
    layer_mask = lm[:, None, None, None] * subj_frac                # [L, B, 1, 1]
    out_v = subj_emb * layer_mask + mix_v * (1.0 - layer_mask)
    out_k = subj_emb * layer_mask + mix_k * (1.0 - layer_mask)
    return out_v, out_k


# -- mix-prompt distillation losses ---------------------------------------------------

def calc_delta_alignment_loss(feat_base, feat_ex, ref_feat_base, ref_feat_ex, *,
                              ref_grad_scale=0.1, feat_base_grad_scale=0.05,
                              cosine_exponent=2.0,
                              delta_types=("feat_to_ref", "ex_to_base")) -> dict:
    """-> {delta_type: loss}: "feat_to_ref" aligns (feat_ex - its projection
    on ref_ex) with (feat_base - its projection on ref_base); "ex_to_base"
    aligns (feat_ex ortho feat_base) with (ref_ex ortho ref_base)."""
    rb = grad_scale(ref_feat_base, ref_grad_scale)
    re = grad_scale(ref_feat_ex, ref_grad_scale)
    if feat_base_grad_scale == -1:
        feat_base_grad_scale = min(ref_grad_scale / 2, 1)
    fb = grad_scale(feat_base, feat_base_grad_scale)
    out = {}
    for dt in delta_types:
        if dt == "feat_to_ref":
            src, tgt = ortho_subtract(fb, rb), ortho_subtract(feat_ex, re)
        elif dt == "ex_to_base":
            src, tgt = ortho_subtract(re, rb), ortho_subtract(feat_ex, fb)
        else:
            raise ValueError(dt)
        out[dt] = calc_ref_cosine_loss(tgt, src, exponent=cosine_exponent,
                                       do_demean_first=False,
                                       first_n_dims_to_flatten=feat_base.ndim - 1,
                                       ref_grad_scale=1.0, aim_to_align=True)
    return out


def convert_attn_to_spatial_weight(flat_attn: torch.Tensor, bs: int, out_hw,
                                   reversed: bool = True):
    """flat_attn [bs * n_occ, heads, Q] (taken without gradient) -> (the
    spatial weight [bs, H, W, 1], the attention map it came from): the map
    summed over occurrences and averaged over heads, resized to out_hw;
    weight = min(exp(-+(map - mean) / max(std + 1e-3, mean / 2)), 1),
    normalized to mean 1."""
    flat_attn = flat_attn.detach()
    n = flat_attn.shape[-1]
    h, w = out_hw
    scale = np.sqrt(n / (h * w))
    h2, w2 = int(h * scale), int(w * scale)
    sa = flat_attn.reshape(bs, -1, flat_attn.shape[-2], n).mean(dim=2).sum(dim=1)
    sa = bilinear_resize_torch(sa.reshape(bs, h2, w2, 1), (h, w))
    mean = sa.mean(dim=(1, 2), keepdim=True)
    std = sa.std(dim=(1, 2), keepdim=True, correction=0)
    denom = torch.maximum(std + 0.001, mean / 2)
    m = -1.0 if reversed else 1.0
    wgt = torch.clamp(torch.exp(m * (sa - mean) / denom), max=1.0)
    return wgt / wgt.mean(dim=(1, 2), keepdim=True), sa


def _avg_pool(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """AvgPool2d(kernel, stride), no padding, on NHWC."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), kernel, stride).permute(0, 2, 3, 1)


def select_subj_attn(attnscore: torch.Tensor, subj_pos) -> torch.Tensor:
    """attnscore [4B, heads, Q, 77] and the K subject token positions ->
    the subject attention summed over them [4B, heads, Q]."""
    pos = torch.as_tensor(np.asarray(subj_pos), device=attnscore.device).long()
    return attnscore[:, :, :, pos].sum(dim=-1)


def _layer_norm_free(x: torch.Tensor) -> torch.Tensor:
    """Affine-free LayerNorm over the last dim (eps 1e-5)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + 1e-5)


def calc_prompt_mix_loss(ca_outfeats: dict, ca_attnscores: dict, subj_pos,
                         block_size: int = 1, normalize_outfeat=0.0):
    """ca_outfeats {layer: [4B, H, W, C]}; ca_attnscores {layer: [4B, heads,
    Q, 77]}; subj_pos the K subject token positions (the same in the 4
    blocks). normalize_outfeat: the host's 0/1 coin for the affine-free
    LayerNorm of the outfeats (the caller scales feat-delta by 5 when set).

    -> (loss_feat_delta_align, loss_subj_attn_delta_align,
        loss_subj_attn_norm_distill)."""
    feat_w = _normalize_weights(FEAT_DISTILL_LAYER_WEIGHTS)
    attn_delta_w = _normalize_weights(ATTN_DELTA_LAYER_WEIGHTS)
    attn_norm_w = _normalize_weights(ATTN_NORM_LAYER_WEIGHTS)
    mix_feat_gs, mix_attn_gs = 0.1, 0.05
    l_attn_delta, l_feat_delta, l_attn_norm = [], [], []
    first = next(iter(ca_outfeats.values()))
    norm_flag = torch.as_tensor(normalize_outfeat, dtype=torch.float32, device=first.device)

    for li, outfeat in ca_outfeats.items():
        if li not in feat_w and li not in attn_norm_w:
            continue
        outfeat = norm_flag * _layer_norm_free(outfeat) + (1.0 - norm_flag) * outfeat
        subj_attn = select_subj_attn(ca_attnscores[li], subj_pos)          # [4B, h, Q]
        ss_a, sc_a, ms_a, mc_a = subj_attn.chunk(4, dim=0)

        if li in attn_norm_w:
            mc_gs = grad_scale(mc_a, mix_attn_gs)
            ms_gs = grad_scale(ms_a, mix_attn_gs)
            if attn_delta_w.get(li, 0) > 0:
                d = calc_delta_alignment_loss(ss_a, sc_a, ms_a, mc_a, ref_grad_scale=mix_attn_gs,
                                              feat_base_grad_scale=1.0, cosine_exponent=3.0,
                                              delta_types=("feat_to_ref",))
                l_attn_delta.append(d["feat_to_ref"] * attn_delta_w[li])
            comp_norm = (sc_a.mean(-1) - mc_gs.mean(-1)).abs().mean()
            single_norm = (ss_a.mean(-1) - ms_gs.mean(-1)).abs().mean()
            l_attn_norm.append((comp_norm + single_norm) * attn_norm_w[li])

        if li not in feat_w:
            continue
        h, w = outfeat.shape[1:3]
        sw_mix, _ = convert_attn_to_spatial_weight(mc_a, block_size, (h, w))
        sw_subj, _ = convert_attn_to_spatial_weight(sc_a, block_size, (h, w))
        of = outfeat * ((sw_mix + sw_subj) / 2).repeat(4, 1, 1, 1)
        if h in FEAT_SIZE2POOLER_SPEC:
            kernel, stride = FEAT_SIZE2POOLER_SPEC[h]
        else:
            # feature sizes of no SD config (tiny tests): proportional pooling
            kernel, stride = max(2, h // 4), max(1, h // 8)
        pooled = _avg_pool(of, kernel, stride)
        ss_f, sc_f, ms_f, mc_f = pooled.reshape(pooled.shape[0], -1).chunk(4, dim=0)
        ms_f = grad_scale(ms_f, mix_feat_gs)
        mc_f = grad_scale(mc_f, mix_feat_gs)
        resid = ortho_subtract(ortho_subtract(sc_f, mc_f), ortho_subtract(ss_f, ms_f))
        l_feat_delta.append((resid * resid).mean() * feat_w[li])

    zero = torch.zeros((), device=first.device)
    s = lambda xs: sum(xs) if xs else zero
    return s(l_feat_delta), s(l_attn_delta), s(l_attn_norm)


def clip_teachability(clip_loss_cls_comp, clip_loss_subj_comp):
    """Teachable iff the class prompt's CLIP loss <= 0.28 and the subject's
    exceeds it by more than 0.002 (numpy arrays or tensors)."""
    return (clip_loss_cls_comp <= CLIP_LOSS_THRESHOLD) & \
           (clip_loss_subj_comp - clip_loss_cls_comp > CLIP_LOSS_MARGIN)


def select_teachable_candidate(loss_subj_comp, loss_cls_comp):
    """N candidates' CLIP losses [N] (host) -> (is_teachable, best index):
    among the teachable candidates, the one with the largest subj - cls
    margin (the first on a tie); (False, 0) when none is."""
    loss_subj = np.asarray(loss_subj_comp, np.float64).reshape(-1)
    loss_cls = np.asarray(loss_cls_comp, np.float64).reshape(-1)
    diffs = loss_subj - loss_cls
    teachable = clip_teachability(loss_cls, loss_subj)
    if not teachable.any():
        return False, 0
    return True, int(np.argmax(np.where(teachable, diffs, -1e4)))
