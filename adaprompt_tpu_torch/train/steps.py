"""Training steps: the Arc2Face distillation step, the zero-shot
reconstruction step and the static (textual-inversion) one.

Port of `adaprompt_tpu/train/steps.py` (`TrainState`, `create_train_state`,
`masked_recon_loss`, `make_recon_step`, `FrozenSD`, `frozen_params`,
`make_arc2face_distill_step`) and of the JAX trainer's `apply_emb_scale`,
`make_zs_recon_step` and `make_static_recon_step`.

Full-UNet reconstruction (`UNetReconStep`, `make_recon_step`). The masked
reconstruction loss of the noised latents under a given context. By default
the state's params are {"unet": UNet}: the UNet's own float32 weights are
trained, with the activations in the compute dtype. With `context_fn`
(params, batch) -> [L, B, S, D], the step trains whatever makes the context
against the frozen UNet in batch["unet"].

Distillation (`DistillStep`). The frozen Arc2Face
teacher denoises a chain of ND steps; the student, the frozen SD UNet
conditioned on the AdaFace inverse prompt embeddings that the trainable
SubjBasisGenerator makes, matches the teacher's noise predictions over the
last max(7 // B, 1) steps, the loss summed and divided by sqrt(ND). The
gradient flows back through the frozen student UNet (its self-attention
through the flash backward kernel on the card) and the frozen SD text
encoder into the SubjBasisGenerator.

Reconstruction (`ReconStep`). The trainable SubjBasisGenerator's subject
vectors, with the host-drawn embedding noise and the learnable global
scale (`apply_emb_scale`), are spliced into the caption at the subject
placeholder and encoded by the frozen SD text encoder; under `use_bg` the
trainable background SubjBasisGenerator's 4 vectors a layer, made from the
batch's zero-shot CLIP features, are spliced at the background placeholder
of each of the 16 layers' prompts as well. The frozen UNet
reconstructs the noised latents under the augmentation mask, optionally
with subject conv-attention. The loss is the fg/bg-weighted MSE and, under
`fgbg_reg`, the fg/bg attention regularizers on the captured
cross-attention scores (`train/fgbg.py`).

Static reconstruction (`StaticReconStep`, the legacy textual-inversion
mode of the JAX trainer's `make_static_recon_step`). A trainable
StaticLayerwiseEmbedding's [L, K, D] embeddings, the same for every sample,
are spliced per layer at the subject placeholder; the rest is the recon
step's UNet pass and fg/bg-weighted MSE, without regularizers.

A step draws all its randomness in its `draw`, from a `torch.Generator`:
the timesteps, the first noise, the distillation chain's uniform and
normal draws or the recon step's embedding noise. Its `loss` takes those
draws as inputs.

Over a device mesh (`rows`, the trainer's `distribute`), the batch a step
is given holds this rank's rows of the global batch. The step draws for
the global batch and takes its rows of each draw (`DRAW_AXES`), computes
its share of every loss (`parallel/mesh.py`: each reduction over rows is
global), and sums the gradients and the metrics over the dp ranks; the
optimizer's sums run over the shards of the sharded parameters.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from adaprompt_tpu_torch.adaface import arc2face
from adaprompt_tpu_torch.adaface.conditioner import add_noise_to_tensor, encode_spliced
from adaprompt_tpu_torch.models.clip_text import CLIPTextModel
from adaprompt_tpu_torch.models.unet import UNet
from adaprompt_tpu_torch.parallel import mesh as mesh_mod
from adaprompt_tpu_torch.sampling.schedule import SD15_SCHEDULE, DiffusionSchedule, q_sample
from adaprompt_tpu_torch.train import fgbg
from adaprompt_tpu_torch.train.arc2face_teacher import teacher_denoise_chain
from adaprompt_tpu_torch.train.losses import calc_recon_loss


def named_trainable(params: dict) -> list:
    """(qualified name, tensor) of a {name: module or parameter} dict, in
    order: '<name>.<parameter>' for a module's parameters, '<name>' for a
    bare tensor."""
    out = []
    for name, v in params.items():
        if isinstance(v, torch.nn.Module):
            out.extend((f"{name}.{n}", p) for n, p in v.named_parameters())
        else:
            out.append((name, v))
    return out


def trainable_parameters(params: dict) -> list:
    """The parameters of a {name: module or parameter} dict, in order."""
    return [p for _, p in named_trainable(params)]


@dataclasses.dataclass
class TrainState:
    params: dict          # {"subj_basis": SubjBasisGenerator, "emb_scales": Parameter}
    optimizer: object     # prodigy.GradientPipeline over those parameters
    step: int = 0


def _train_step(state: TrainState, loss_fn, rows=None):
    """One update of the state's parameters: loss_fn() -> (loss, {metric:
    scalar tensor}), its backward and the pipeline's step. Returns (state,
    the metrics detached, with the gradients' norm before clipping). With
    `rows` (a mesh whose dp splits the batch) the loss is this rank's share:
    the gradients and metrics are summed over dp."""
    params = trainable_parameters(state.params)
    state.optimizer.zero_grad()
    with mesh_mod.split_rows(rows):
        loss, metrics = loss_fn()
    loss.backward()
    if rows is not None:
        mesh_mod.sync_grads(params, rows)
    norm = grad_norm(state)
    state.optimizer.step()
    state.step += 1
    metrics = mesh_mod.sum_over_rows({name: v.detach() for name, v in metrics.items()}, rows)
    metrics["grad_norm"] = norm
    return state, metrics


def _draws(step, gen, batch: dict, draws: dict | None, rows) -> dict:
    """The step's draws for the global batch (made from `gen` unless
    given), cut to this rank's rows along each draw's batch axis."""
    if draws is None:
        z0 = batch["z0"]
        if rows is not None:
            z0 = z0.new_empty((z0.shape[0] * rows["dp"].size(),) + tuple(z0.shape[1:]))
        draws = step.draw(gen, z0)
    if rows is None:
        return draws
    return {k: mesh_mod.take_rows(v, rows, step.DRAW_AXES.get(k, 0)) for k, v in draws.items()}


def create_train_state(params: dict, optimizer) -> TrainState:
    """A state that trains every parameter of `params` {name: module or
    parameter}: each is set to require gradients. `optimizer` builds the
    GradientPipeline from their list (`functools.partial(
    trainer.build_optimizer, cfg)`), as optax's `init` does from the tree."""
    leaves = trainable_parameters(params)
    for p in leaves:
        p.requires_grad_(True)
    return TrainState(params, optimizer(leaves))


def masked_recon_loss(eps_pred: torch.Tensor, eps: torch.Tensor, fg_mask: torch.Tensor | None,
                      aug_mask: torch.Tensor | None, bg_weight: float = 0.1) -> torch.Tensor:
    """calc_recon_loss with the recon iterations' weights: fg 1, bg
    `bg_weight`, aug_mask as the image mask."""
    return calc_recon_loss(eps_pred, eps, aug_mask, fg_mask, fg_pixel_weight=1.0,
                           bg_pixel_weight=bg_weight)


class UNetReconStep:
    """The full-UNet reconstruction step.

    step(state, batch, gen) -> (state, metrics {"loss_recon", "grad_norm"})
    with batch {'z0' [B,h,w,4] scaled latents, 'context' [L,B,S,D] (without
    context_fn), 'unet' the frozen UNet (with context_fn), 'fg_mask' and
    'aug_mask' [B,h,w,1] | None}. The augmentation mask is also the
    self-attention key mask."""

    def __init__(self, unet_cfg=None, sched: DiffusionSchedule = SD15_SCHEDULE,
                 context_fn=None, compute_dtype=torch.bfloat16):
        self.unet_cfg, self.sched = unet_cfg, sched
        self.context_fn, self.compute_dtype = context_fn, compute_dtype

    def draw(self, gen: torch.Generator, z0: torch.Tensor) -> dict:
        """The timesteps and the noise, from `gen` (on z0's device)."""
        b, dev = z0.shape[0], z0.device
        return {"t": torch.randint(0, self.sched.num_timesteps, (b,), generator=gen, device=dev),
                "noise": torch.randn(z0.shape, generator=gen, device=dev)}

    def loss(self, params: dict, batch: dict, draws: dict):
        if self.context_fn is None:
            unet, ctx = params["unet"], batch["context"]
        else:
            unet, ctx = batch["unet"], self.context_fn(params, batch)
        t, noise, dt = draws["t"], draws["noise"], self.compute_dtype
        z_t = q_sample(self.sched, batch["z0"], t, noise)
        eps = unet(z_t.to(dt), t, ctx.to(dt), img_mask=batch.get("aug_mask"), cfg=self.unet_cfg)
        loss = masked_recon_loss(eps.float(), noise, batch.get("fg_mask"), batch.get("aug_mask"))
        return loss, {"loss_recon": loss}

    def __call__(self, state: TrainState, batch: dict, gen: torch.Generator,
                 draws: dict | None = None):
        draws = self.draw(gen, batch["z0"]) if draws is None else draws
        return _train_step(state, lambda: self.loss(state.params, batch, draws))


def make_recon_step(unet_cfg=None, sched: DiffusionSchedule = SD15_SCHEDULE,
                    context_fn=None, compute_dtype=torch.bfloat16) -> UNetReconStep:
    """The JAX package's make_recon_step; the optimizer lives in the state
    (`create_train_state`). `unet_cfg` overrides the UNet's options for the
    step's forward (None: the model's own)."""
    return UNetReconStep(unet_cfg, sched, context_fn, compute_dtype)


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


def grad_norm(state: TrainState) -> torch.Tensor:
    """The norm of the state's gradients, a sharded parameter's over all its shards."""
    params = [p for p in trainable_parameters(state.params) if p.grad is not None]
    return torch.sqrt(state.optimizer.param_sum(params, [(p.grad.float() ** 2).sum()
                                                         for p in params]))


class DistillStep:
    """One compiled-variant's worth of the JAX step: a fixed ND.

    step(state, fp, batch, gen) -> (state, metrics) with batch
    {'z0' [B,h,w,4] scaled latents, 'faceid' [B,512] normalized,
     'fg_mask' [B,h,w,1] | None, 'aug_mask' [B,h,w,1] | None}."""
    DRAW_AXES = {"rels": 1, "next_noises": 1}

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

        gb = mesh_mod.global_rows(b)
        loss_start = max(0, nd - max(7 // gb if gb > 0 else 1, 1))
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
                 draws: dict | None = None, rows=None):
        draws = _draws(self, gen, batch, draws, rows)

        def loss_fn():
            loss = self.loss(state.params["subj_basis"], fp, batch, draws)
            return loss, {"loss_arc2face_distill": loss}
        return _train_step(state, loss_fn, rows)


def make_arc2face_distill_step(frozen: FrozenSD, tokenizer, subj_basis_cfg, **kw) -> DistillStep:
    return DistillStep(frozen, tokenizer, subj_basis_cfg, **kw)


def apply_emb_scale(embs: torch.Tensor, params: dict, batch: dict, index: int) -> torch.Tensor:
    """The learnable per-placeholder global scale sigmoid(score) + 0.5, times
    the batch's host-drawn U(0.8, 1.4) perturbation when it has one."""
    scores = params.get("emb_scales")
    if scores is None:
        return embs
    scale = torch.sigmoid(scores[index]) + 0.5
    pert = batch.get("emb_scale_perturb")
    if pert is not None:
        scale = scale * pert[index]
    return embs * scale.to(embs.dtype)


class ReconStep:
    """The zero-shot reconstruction iteration.

    step(state, fp, batch, gen) -> (state, metrics) with batch
    {'z0' [B,h,w,4] scaled latents, 'faceid' [B,512] normalized,
     'caption_ids' [B,77], 'subj_bi' [B], 'subj_pos' [B], 'fg_mask' and
     'aug_mask' [B,h,w,1] | None, 'skip_weights' [N], 'emb_noise_std'
     scalar (0 = off), 'emb_scale_perturb' [2] | None, and under use_bg
     'clip_features' [B,2S,1280], 'bg_bi' [B], 'bg_pos' [B]}; the state's
     params hold 'bg_basis' under use_bg."""
    DRAW_AXES = {}

    def __init__(self, frozen: FrozenSD, tokenizer, subj_basis_cfg, *, bg_basis_cfg=None,
                 use_bg: bool = False, fgbg_reg: bool = False,
                 num_ca_layers: int = 16, sched: DiffusionSchedule = SD15_SCHEDULE,
                 compute_dtype=torch.bfloat16, fg_bg_complementary_loss_weight: float = 2e-4,
                 fg_bg_xlayer_consist_loss_weight: float = 5e-5, conv_attn_kernel_size: int = 0):
        if use_bg and bg_basis_cfg is None:
            raise ValueError("use_bg needs bg_basis_cfg, the background generator's config")
        self.frozen, self.tokenizer, self.subj_basis_cfg = frozen, tokenizer, subj_basis_cfg
        self.bg_basis_cfg, self.use_bg = bg_basis_cfg, use_bg
        self.fgbg_reg, self.num_ca_layers = fgbg_reg, num_ca_layers
        self.sched, self.compute_dtype = sched, compute_dtype
        self.complementary_weight = fg_bg_complementary_loss_weight
        self.xlayer_weight = fg_bg_xlayer_consist_loss_weight
        self.conv_attn_kernel_size = conv_attn_kernel_size

    def draw(self, gen: torch.Generator, z0: torch.Tensor) -> dict:
        """Every random draw of one step, from `gen` (on z0's device): the
        timesteps, the noise, and the standard-normal embedding noise of the
        subject vectors' shape [B, L, K, D]."""
        b, dev, cfg = z0.shape[0], z0.device, self.subj_basis_cfg
        emb_shape = (b, cfg.num_out_layers, cfg.num_out_embs_per_layer, cfg.output_dim)
        return {
            "t": torch.randint(0, self.sched.num_timesteps, (b,), generator=gen, device=dev),
            "noise": torch.randn(z0.shape, generator=gen, device=dev),
            "emb_noise": torch.randn(emb_shape, generator=gen, device=dev),
        }

    def loss(self, params: dict, fp: dict, batch: dict, draws: dict):
        """-> (loss, {metric: scalar tensor}) with the JAX step's metric names."""
        z0 = batch["z0"]
        b, dt, tok = z0.shape[0], self.compute_dtype, self.tokenizer
        k = self.subj_basis_cfg.num_out_embs_per_layer
        with torch.no_grad():
            _, core_id = arc2face.forward_face_embs(fp["arc2face_text"], tok, batch["faceid"],
                                                    input_max_length=21)
        subj_embs, _ = params["subj_basis"](tok, core_id, is_training=True)
        std = batch.get("emb_noise_std")
        if std is not None:
            subj_embs = add_noise_to_tensor(subj_embs, std, noise=draws["emb_noise"])
        subj_embs = apply_emb_scale(subj_embs, params, batch, 0)
        # the zero-shot subject vectors repeat over the layers: splice L' = 1
        splices = [(subj_embs[:, :1], batch["subj_bi"], batch["subj_pos"], k)]
        bg_rows = None
        if self.use_bg:
            k_bg = self.bg_basis_cfg.num_out_embs_per_layer
            bg_embs, _ = params["bg_basis"](tok, clip_features=batch["clip_features"],
                                            is_training=True)
            bg_embs = apply_emb_scale(bg_embs, params, batch, 1)
            # the background vectors differ by layer: 16 prompts a caption
            splices.append((bg_embs, batch["bg_bi"], batch["bg_pos"], k_bg))
            bg_rows = batch["bg_pos"][:, None] + torch.arange(k_bg, device=z0.device)[None]
        ctx = encode_spliced(fp["text"], batch["caption_ids"], splices, batch["skip_weights"],
                             self.num_ca_layers, layerwise=self.use_bg)
        t, noise = draws["t"], draws["noise"]
        z_t = q_sample(self.sched, z0, t, noise)
        subj_rows = batch["subj_pos"][:, None] + torch.arange(k, device=z0.device)[None]
        conv_attn = None
        if self.conv_attn_kernel_size > 1:
            conv_attn = {"subj_pos": subj_rows, "kernel_size": self.conv_attn_kernel_size,
                         "mix_weight": 1.0}
        # the augmentation mask restricts self-attention keys to the image
        out = fp["unet"](z_t.to(dt), t, ctx.to(dt), img_mask=batch.get("aug_mask"),
                         capture_ca=self.fgbg_reg, conv_attn=conv_attn)
        eps, caps = out if self.fgbg_reg else (out, None)
        loss = calc_recon_loss(eps.float(), noise, batch.get("aug_mask"), batch.get("fg_mask"),
                               fg_pixel_weight=1.0, bg_pixel_weight=0.1)
        metrics = {"loss_recon": loss}
        if self.fgbg_reg:
            scores = {li: v.float() for li, v in caps["attnscore"].items()}
            comple, subj_mb, bg_mf, contrast = fgbg.calc_fg_bg_complementary_loss(
                scores, subj_rows, bg_rows, b, fg_grad_scale=0.1, fg_mask=batch.get("fg_mask"))
            # the complementary term at 0.2 under zero-shot training
            loss_contrast = (comple * 0.2 + subj_mb + bg_mf + contrast) * self.complementary_weight
            fg_x, bg_x = fgbg.calc_fg_bg_xlayer_consist_loss(scores, subj_rows, bg_rows, b)
            loss_xlayer = (fg_x * 0.2 + bg_x * 0.06) * self.xlayer_weight
            loss = loss + loss_contrast + loss_xlayer
            metrics.update({"loss_fg_bg_complementary": comple,
                            "loss_subj_mb_suppress": subj_mb,
                            "loss_bg_mf_suppress": bg_mf,
                            "loss_fg_bg_mask_contrast": contrast,
                            "loss_fg_xlayer_consist": fg_x,
                            "loss_bg_xlayer_consist": bg_x})
        metrics["loss"] = loss
        return loss, metrics

    def __call__(self, state: TrainState, fp: dict, batch: dict, gen: torch.Generator,
                 draws: dict | None = None, rows=None):
        draws = _draws(self, gen, batch, draws, rows)
        return _train_step(state, lambda: self.loss(state.params, fp, batch, draws), rows)


def make_zs_recon_step(frozen: FrozenSD, tokenizer, subj_basis_cfg, **kw) -> ReconStep:
    return ReconStep(frozen, tokenizer, subj_basis_cfg, **kw)


class StaticReconStep(ReconStep):
    """The legacy textual-inversion recon iteration: the trainable
    StaticLayerwiseEmbedding's [L, K, D] embeddings (no face image, no
    SubjBasisGenerator), tiled over the batch and spliced per layer at the
    subject placeholder; the frozen UNet reconstructs the noised latents
    under the augmentation mask, trained on the fg/bg-weighted MSE.

    step(state, fp, batch, gen) -> (state, metrics) with the state's params
    {'static_emb': StaticLayerwiseEmbedding} and batch {'z0', 'caption_ids',
    'subj_bi', 'subj_pos', 'fg_mask', 'aug_mask', 'skip_weights'}."""

    def __init__(self, frozen: FrozenSD, static_cfg, *, num_ca_layers: int = 16,
                 sched: DiffusionSchedule = SD15_SCHEDULE, compute_dtype=torch.bfloat16):
        self.frozen, self.static_cfg, self.num_ca_layers = frozen, static_cfg, num_ca_layers
        self.sched, self.compute_dtype = sched, compute_dtype

    def draw(self, gen: torch.Generator, z0: torch.Tensor) -> dict:
        """The timesteps and the noise, from `gen` (on z0's device)."""
        b, dev = z0.shape[0], z0.device
        return {"t": torch.randint(0, self.sched.num_timesteps, (b,), generator=gen, device=dev),
                "noise": torch.randn(z0.shape, generator=gen, device=dev)}

    def loss(self, params: dict, fp: dict, batch: dict, draws: dict):
        z0 = batch["z0"]
        embs = params["static_emb"]()                                   # [L, K, D]
        subj_embs = embs[None].expand(z0.shape[0], *embs.shape)         # [B, L, K, D]
        ctx = encode_spliced(fp["text"], batch["caption_ids"],
                             [(subj_embs, batch["subj_bi"], batch["subj_pos"],
                               self.static_cfg.num_vectors)],
                             batch["skip_weights"], self.num_ca_layers, layerwise=True)
        t, noise, dt = draws["t"], draws["noise"], self.compute_dtype
        z_t = q_sample(self.sched, z0, t, noise)
        eps = fp["unet"](z_t.to(dt), t, ctx.to(dt), img_mask=batch.get("aug_mask")).float()
        loss = calc_recon_loss(eps, noise, batch.get("aug_mask"), batch.get("fg_mask"),
                               fg_pixel_weight=1.0, bg_pixel_weight=0.1)
        return loss, {"loss_recon": loss, "loss": loss}
