"""The Stage-2 compositional distillation step and its host pieces.

Port of `adaprompt_tpu/train/compos_step.py`. A compositional iteration:

  1. fresh: t ~ U(800, 1000); x_start = the training image's foreground
     latents pasted on noise, randomly shrunk (`init_x_with_fg_from_training_image`,
     scale from `pick_fg_rand_scale`), one candidate each of N;
     reuse: (x_start, t) from `CachedInits`, t ~ U(400, 700) capped at
     prev_t - 150;
  2. the 4-type contexts (subj_single, subj_comp, cls_single, cls_comp)
     and their V/K mixes;
  3. the filter (`make_filter_phase`, no gradient): one denoise of the
     candidates' comp pairs, decoded for the CLIP teacher filter;
  4. if teachable, the train phase (`ComposStep`): the 4-type batch
     denoised with activation capture; prompt-delta, mix-prompt
     distillation, cross-layer consistency and elastic fg/bg preservation
     losses; the update through the trainer's optimizer;
  5. the denoised x_recon cached for a later reuse iteration.

`ComposStep.loss` takes every random tensor as an argument (`draws`: the
embedding noise of the subject vectors); `ComposStep.draw` makes them from
a `torch.Generator`.
"""

from __future__ import annotations

import numpy as np
import torch

from adaprompt_tpu_torch.models.vae import SD_SCALE_FACTOR
from adaprompt_tpu_torch.sampling.schedule import (SD15_SCHEDULE, DiffusionSchedule,
                                                   predict_start_from_noise, q_sample)
from adaprompt_tpu_torch.train import compos as compos_mod, fgbg
from adaprompt_tpu_torch.train.elastic import calc_comp_fg_bg_preserve_loss
from adaprompt_tpu_torch.train.losses import calc_prompt_emb_delta_loss
from adaprompt_tpu_torch.train.steps import TrainState, global_norm, trainable_parameters


def scale_into_canvas(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Shrink the content of x [B, H, W, C] by `scale` into the centre of a
    canvas of the same size (zeros outside), sampled bilinearly."""
    _, h, w, _ = x.shape

    def gather_axis(v, coords, dim):
        size = v.shape[dim]
        lo = np.floor(coords).astype(np.int64)
        frac = (coords - lo).astype(np.float32)
        valid = ((coords >= 0) & (coords <= size - 1)).astype(np.float32)
        idx = lambda i: torch.as_tensor(np.clip(i, 0, size - 1), device=v.device)
        shape = [1] * v.ndim
        shape[dim] = -1
        f = torch.as_tensor(frac, device=v.device).reshape(shape)
        ok = torch.as_tensor(valid, device=v.device).reshape(shape)
        return (v.index_select(dim, idx(lo)) * (1 - f) + v.index_select(dim, idx(lo + 1)) * f) * ok

    ys = (np.arange(h) - (h - 1) / 2) / scale + (h - 1) / 2
    xs = (np.arange(w) - (w - 1) / 2) / scale + (w - 1) / 2
    return gather_axis(gather_axis(x, ys, 1), xs, 2)


def init_x_with_fg_from_training_image(x_start: torch.Tensor, fg_mask: torch.Tensor,
                                       filtered_fg_mask: torch.Tensor, fg_rand_scale: float, *,
                                       noise: torch.Tensor | None = None,
                                       noise2: torch.Tensor | None = None,
                                       gen: torch.Generator | None = None):
    """The (shrunk) foreground of the training latents on noise: inside the
    filtered fg mask x_start, else `noise`; scaled into the canvas by
    fg_rand_scale; outside the scaled mask `noise2`. The two standard-normal
    draws of x_start's shape are made from `gen` unless given. -> (x_start,
    fg_mask, filtered_fg_mask), all [B, h, w, .] NHWC."""
    draw = lambda: torch.randn(x_start.shape, generator=gen, device=x_start.device,
                               dtype=x_start.dtype)
    noise = draw() if noise is None else noise
    noise2 = draw() if noise2 is None else noise2
    x_fg = torch.where(filtered_fg_mask.bool(), x_start, noise)
    stacked = torch.cat([x_fg, fg_mask.to(x_fg.dtype), filtered_fg_mask.to(x_fg.dtype)], dim=-1)
    scaled = scale_into_canvas(stacked, fg_rand_scale)
    c = x_start.shape[-1]
    x_s, fg_s, ffg_s = scaled[..., :c], scaled[..., c:c + 1], scaled[..., c + 1:]
    return torch.where(ffg_s.bool(), x_s, noise2), fg_s, ffg_s


def pick_fg_rand_scale(fg_mask_np: np.ndarray, rng: np.random.Generator,
                       base_scale_range=(0.7, 1.0)) -> float:
    """The host's random scale, narrowed where the foreground is large."""
    pct = float(fg_mask_np.sum()) / fg_mask_np.size
    lb, ub = base_scale_range
    if pct > 0.1:
        extra = (0.1 / pct) ** 0.35
        lb, ub = lb * extra, max(0.5, ub * extra)
    return float(rng.uniform(lb, ub))


def make_filter_phase(*, sched: DiffusionSchedule = SD15_SCHEDULE, compute_dtype=torch.bfloat16):
    """One no-gradient denoise of the (subj_comp x N, mix_comp x N)
    candidate batch, decoded for CLIP scoring: the conditional pass alone,
    as the trainer's filter runs it (no unconditional pass).

    phase(mp, ctx_v, ctx_k, x_start, t, noise) with mp {'unet', 'vae'};
    ctx_v, ctx_k [L, 2N, S, D]; x_start, noise [2N, h, w, 4]; t [2N]
    -> (x_recon, images in [-1, 1] float32)."""

    @torch.no_grad()
    def phase(mp, ctx_v, ctx_k, x_start, t, noise):
        dt = compute_dtype
        x_t = q_sample(sched, x_start, t, noise)
        eps = mp["unet"](x_t.to(dt), t, ctx_v.to(dt), context_k=ctx_k.to(dt)).float()
        x_recon = predict_start_from_noise(sched, x_t, t, eps)
        imgs = mp["vae"].decode((x_recon / SD_SCALE_FACTOR).to(dt)).float()
        return x_recon, imgs

    return phase


# the weights of the compositional loss terms
LOSS_WEIGHTS = {"prompt_emb_delta": 2e-4, "mix_prompt_distill": 1e-4,
                "comp_fg_bg_preserve": 1e-3, "fg_bg_xlayer_consist": 5e-5}


class ComposStep:
    """The with-gradient compositional phase: the 4-type batch denoised with
    activation capture, the distillation losses, and the update.

    context_fn(params, mp, batch, draws) -> {'ctx4' [L, 4, S, D] the 4-type
    contexts before the V/K mixing, 'static_embs' [4, L, S, D] for the
    prompt-delta loss, 'prompt_emb_mask' [4, S, 1] | None, 'subj_pos' the
    subject embeddings' token positions (host), 'bg_pos' | None}.
    batch: {'x_start' [4, h, w, 4], 't' [4], 'noise' [4, h, w, 4],
    'fg_mask' [1, h0, w0, 1] | None, 'training_percent' scalar in [0, 1]
    (the mix-scale anneal), 'normalize_outfeat' 0/1, and what context_fn
    reads}. draws: {'emb_noise' of the subject vectors' shape}."""

    def __init__(self, context_fn, emb_shape: tuple, *, sched: DiffusionSchedule = SD15_SCHEDULE,
                 compute_dtype=torch.bfloat16):
        self.context_fn, self.emb_shape = context_fn, tuple(emb_shape)
        self.sched, self.compute_dtype = sched, compute_dtype

    def draw(self, gen: torch.Generator, device) -> dict:
        """The standard-normal embedding noise of the subject vectors, from `gen`."""
        return {"emb_noise": torch.randn(self.emb_shape, generator=gen, device=device)}

    def loss(self, params: dict, mp: dict, batch: dict, draws: dict):
        """-> (loss, {metric: scalar tensor}, x_recon [4, h, w, 4] detached,
        q_bn_stats {layer: (mean, var)})."""
        cinfo = self.context_fn(params, mp, batch, draws)
        ctx4, subj_pos = cinfo["ctx4"], cinfo["subj_pos"]
        sched, dt = self.sched, self.compute_dtype
        subj_ctx, cls_ctx = ctx4[:, 0:2], ctx4[:, 2:4]                  # [L, 2, S, D]
        t = batch["t"]
        t_frac = t[2:4].float() / sched.num_timesteps
        mix_v, mix_k = compos_mod.mix_static_vk_embeddings(
            subj_ctx, cls_ctx, subj_pos, t_frac, batch.get("training_percent", 0.0))
        ctx_v = torch.cat([subj_ctx, mix_v], dim=1)                     # [L, 4, S, D]
        ctx_k = torch.cat([subj_ctx, mix_k], dim=1)

        x_t = q_sample(sched, batch["x_start"], t, batch["noise"])
        # no img_mask: every self-attention key is kept (no key bias)
        eps, caps = mp["unet"](x_t.to(dt), t, ctx_v.to(dt), context_k=ctx_k.to(dt),
                               capture_ca=True)
        x_recon = predict_start_from_noise(sched, x_t, t, eps.float())
        outfeats = {li: v.float() for li, v in caps["outfeat"].items()}
        attnscores = {li: v.float() for li, v in caps["attnscore"].items()}

        # the host's 50% coin: affine-free LayerNorm of the outfeats, and the
        # feat-delta term x5 (base scale 0.5 under zero-shot training)
        norm_of = batch.get("normalize_outfeat", 0.0)
        loss_feat, loss_attn_delta, loss_attn_norm = compos_mod.calc_prompt_mix_loss(
            outfeats, attnscores, subj_pos, block_size=1, normalize_outfeat=norm_of)
        feat_scale = 0.5 * (1.0 + 4.0 * torch.as_tensor(norm_of, dtype=torch.float32,
                                                        device=x_t.device))
        loss_mix = loss_feat * feat_scale + loss_attn_delta + loss_attn_norm * 10.0
        loss_delta = calc_prompt_emb_delta_loss(cinfo["static_embs"], cinfo.get("prompt_emb_mask"))
        loss_fg_x, loss_bg_x = fgbg.calc_fg_bg_xlayer_consist_loss(
            attnscores, subj_pos, cinfo.get("bg_pos"), ssb_size=2)

        fg_mask = batch.get("fg_mask")
        loss_preserve = torch.zeros((), device=x_t.device)
        q_bn_stats: dict = {}
        if fg_mask is not None:
            qs = {li: v.float() for li, v in caps["q"].items()}
            (l_map, l_scss, l_mcms, l_scmc, l_subj_sup, l_mix_sup), q_bn_stats = \
                calc_comp_fg_bg_preserve_loss(outfeats, qs, attnscores, fg_mask, subj_pos,
                                              block_size=1)
            loss_preserve = l_map + l_scss + l_mcms + l_scmc + (l_subj_sup + l_mix_sup) * 10.0

        lw = LOSS_WEIGHTS
        loss = (lw["mix_prompt_distill"] * loss_mix + lw["prompt_emb_delta"] * loss_delta
                + lw["fg_bg_xlayer_consist"] * (loss_fg_x + loss_bg_x)
                + lw["comp_fg_bg_preserve"] * loss_preserve)
        metrics = {"loss_compos": loss, "loss_mix_prompt_distill": loss_mix,
                   "loss_prompt_emb_delta": loss_delta, "loss_fg_xlayer_consist": loss_fg_x,
                   "loss_bg_xlayer_consist": loss_bg_x, "loss_comp_fg_bg_preserve": loss_preserve}
        return loss, metrics, x_recon.detach(), q_bn_stats

    def __call__(self, state: TrainState, mp: dict, batch: dict, gen: torch.Generator | None,
                 draws: dict | None = None):
        """-> (state, metrics with 'grad_norm' and 'q_bn_stats', x_recon)."""
        draws = self.draw(gen, batch["x_start"].device) if draws is None else draws
        params = trainable_parameters(state.params)
        state.optimizer.zero_grad()
        loss, metrics, x_recon, q_bn_stats = self.loss(state.params, mp, batch, draws)
        loss.backward()
        # the gradients' norm before clipping
        grad_norm = global_norm([p.grad for p in params if p.grad is not None])
        state.optimizer.step()
        state.step += 1
        metrics = {name: v.detach() for name, v in metrics.items()}
        metrics.update(grad_norm=grad_norm, q_bn_stats=q_bn_stats)
        return state, metrics, x_recon


class CachedInits:
    """The host's cache of denoised x_recon, by subject, for reuse iterations."""

    def __init__(self, num_timesteps: int = 1000):
        self.cache: dict = {}
        self.T = num_timesteps

    def put(self, subject_name: str, x_recon: np.ndarray, t: np.ndarray):
        self.cache[subject_name] = {"x_start": np.asarray(x_recon), "t": np.asarray(t)}

    def has(self, subject_name: str) -> bool:
        return subject_name in self.cache

    def take(self, subject_name: str, rng: np.random.Generator):
        """Pop the entry: (x_start, t ~ U(0.4T, 0.7T) capped at prev_t - 0.15T, >= 0)."""
        entry = self.cache.pop(subject_name)
        x_start, prev_t = entry["x_start"], entry["t"]
        t_mid = rng.integers(int(self.T * 0.4), int(self.T * 0.7), size=prev_t.shape)
        t = np.minimum(t_mid, prev_t - int(self.T * 0.15))
        return x_start, np.maximum(t, 0).astype(np.int32)
