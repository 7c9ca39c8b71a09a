"""Training steps: the Stage-1 Arc2Face distillation step.

Port of `adaprompt_tpu/train/steps.py` (`TrainState`, `FrozenSD`,
`frozen_params`, `make_arc2face_distill_step`). The frozen Arc2Face
teacher denoises a chain of ND steps; the student, the frozen SD UNet
conditioned on the AdaFace inverse prompt embeddings that the trainable
SubjBasisGenerator makes, matches the teacher's noise predictions over the
last max(7 // B, 1) steps, the loss summed and divided by sqrt(ND). The
gradient flows back through the frozen student UNet (its self-attention
through the flash backward kernel on the card) and the frozen SD text
encoder into the SubjBasisGenerator.

A step draws all its randomness in `DistillStep.draw`, from a
`torch.Generator`: the timesteps, the first noise, and the chain's uniform
and normal draws. `DistillStep.loss` takes those draws as inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from adaprompt_tpu_torch.adaface import arc2face
from adaprompt_tpu_torch.models.clip_text import CLIPTextModel
from adaprompt_tpu_torch.models.unet import UNet
from adaprompt_tpu_torch.sampling.schedule import SD15_SCHEDULE, DiffusionSchedule, q_sample
from adaprompt_tpu_torch.train.arc2face_teacher import teacher_denoise_chain
from adaprompt_tpu_torch.train.losses import calc_recon_loss


def trainable_parameters(params: dict) -> list:
    """The parameters of a {name: module or parameter} dict, in order."""
    out = []
    for v in params.values():
        out.extend(v.parameters() if isinstance(v, torch.nn.Module) else [v])
    return out


@dataclasses.dataclass
class TrainState:
    params: dict          # {"subj_basis": SubjBasisGenerator, "emb_scales": Parameter}
    optimizer: object     # prodigy.GradientPipeline over those parameters
    step: int = 0


@dataclasses.dataclass(frozen=True, eq=False)
class FrozenSD:
    """The frozen models of the distillation step. Without a teacher
    (teacher_unet None) the chain would distill the student against its own
    frozen UNet; that needs allow_self_teacher=True (smoke runs only)."""
    unet: UNet
    text: CLIPTextModel
    arc2face_text: CLIPTextModel
    teacher_unet: UNet | None


def frozen_params(frozen: FrozenSD) -> dict:
    """The frozen models as the step's argument."""
    fp = {"unet": frozen.unet, "text": frozen.text, "arc2face_text": frozen.arc2face_text}
    if frozen.teacher_unet is not None:
        fp["teacher_unet"] = frozen.teacher_unet
    return fp


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


class DistillStep:
    """One compiled-variant's worth of the JAX step: a fixed ND.

    step(state, fp, batch, gen) -> (state, metrics) with batch
    {'z0' [B,h,w,4] scaled latents, 'faceid' [B,512] normalized,
     'fg_mask' [B,h,w,1] | None, 'aug_mask' [B,h,w,1] | None}."""

    def __init__(self, frozen: FrozenSD, tokenizer, subj_basis_cfg, *,
                 num_denoising_steps: int = 1, sched: DiffusionSchedule = SD15_SCHEDULE,
                 compute_dtype=torch.bfloat16, skip_weights=(0.5, 0.5),
                 allow_self_teacher: bool = False):
        if frozen.teacher_unet is None and not allow_self_teacher:
            raise ValueError(
                "arc2face distillation requires a teacher UNet (Arc2Face checkpoint); pass "
                "allow_self_teacher=True only for smoke runs that knowingly distill the "
                "student against its own frozen UNet")
        self.frozen, self.tokenizer, self.subj_basis_cfg = frozen, tokenizer, subj_basis_cfg
        self.nd, self.sched, self.compute_dtype = num_denoising_steps, sched, compute_dtype
        self.skip_weights = np.asarray(skip_weights, np.float32)

    def draw(self, gen: torch.Generator, z0: torch.Tensor) -> dict:
        """Every random draw of one step, from `gen` (on z0's device)."""
        b, nd, dev = z0.shape[0], self.nd, z0.device
        return {
            "t": torch.randint(0, self.sched.num_timesteps, (b,), generator=gen, device=dev),
            "noise": torch.randn(z0.shape, generator=gen, device=dev),
            "rels": torch.rand((nd - 1, b), generator=gen, device=dev),
            "next_noises": torch.randn((nd - 1,) + tuple(z0.shape), generator=gen, device=dev),
        }

    def loss(self, sbg, fp: dict, batch: dict, draws: dict) -> torch.Tensor:
        z0 = batch["z0"]
        b, nd, dt = z0.shape[0], self.nd, self.compute_dtype
        tok = self.tokenizer
        with torch.no_grad():
            # teacher conditioning: Arc2Face forward embeddings, 21 tokens
            teacher_ctx, core_id = arc2face.forward_face_embs(
                fp["arc2face_text"], tok, batch["faceid"], input_max_length=21)
        noise_preds, pred_x0s, noises, ts = teacher_denoise_chain(
            fp.get("teacher_unet", fp["unet"]), z0, draws["noise"], draws["t"], teacher_ctx,
            draws["rels"], draws["next_noises"], num_denoising_steps=nd, sched=self.sched,
            compute_dtype=dt)

        # student conditioning: the AdaFace inverse prompt embeddings
        # ('full_pad' in training) re-encoded by the frozen SD text encoder
        _, prompt_embs = sbg(tok, core_id, is_training=True)
        text = fp["text"]
        ids_np, _ = arc2face.inverse_template(tok, text.cfg.max_positions)
        ids = torch.as_tensor(ids_np, device=z0.device).long()[None].expand(b, -1)
        student_ctx = text.encode(ids, inputs_embeds=prompt_embs,
                                  hidden_state_layer_weights=torch.as_tensor(
                                      self.skip_weights, device=z0.device))

        loss_start = max(0, nd - max(7 // b if b > 0 else 1, 1))
        fg_mask, img_mask = batch.get("fg_mask"), batch.get("aug_mask")
        losses = []
        for s in range(loss_start, nd):
            # the student's input is the teacher's previous pred_x0 (s = 0
            # wraps to the last)
            x_s = q_sample(self.sched, pred_x0s[s - 1], ts[s], noises[s])
            eps_s = fp["unet"](x_s.to(dt), ts[s], student_ctx[None].to(dt),
                               img_mask=img_mask).float()
            # bg_pixel_weight 0: the teacher-suppressed background is not distilled
            losses.append(calc_recon_loss(eps_s, noise_preds[s], img_mask, fg_mask,
                                          fg_pixel_weight=1.0, bg_pixel_weight=0.0))
        return sum(losses) / np.sqrt(nd)

    def __call__(self, state: TrainState, fp: dict, batch: dict, gen: torch.Generator,
                 draws: dict | None = None):
        draws = self.draw(gen, batch["z0"]) if draws is None else draws
        params = trainable_parameters(state.params)
        state.optimizer.zero_grad()
        loss = self.loss(state.params["subj_basis"], fp, batch, draws)
        loss.backward()
        grad_norm = global_norm([p.grad for p in params if p.grad is not None])
        state.optimizer.step()
        state.step += 1
        return state, {"loss_arc2face_distill": loss.detach(), "grad_norm": grad_norm}


def make_arc2face_distill_step(frozen: FrozenSD, tokenizer, subj_basis_cfg, **kw) -> DistillStep:
    return DistillStep(frozen, tokenizer, subj_basis_cfg, **kw)
