"""Training orchestration: the host loop of Stage-1 and Stage-2 training.

Port of `adaprompt_tpu/train/trainer.py`. Per step the host draws, from
`numpy.random.default_rng(cfg.seed)` and in the JAX package's order: on
every `composition_regs_iter_gap`-th step (step > 0) a compositional
iteration and nothing else; otherwise the iteration type (distillation with
probability `arc2face_distill_iter_prob`, else recon), the face ids, the
Dirichlet clip-skip weights, the embedding-noise coin and, when it comes
up, the noise std from `emb_noise_std_range` (probabilities per iteration
type in `emb_noise_prob`: 0.6 recon, 0 distillation, 0.4 compositional),
the global-scale perturbation, and on distillation iterations ND over (1,
3, 5, 7). ND > 1 keeps the first ceil(B / ND) rows (HALF_BS). The device
draws come from a `torch.Generator` seeded with cfg.seed.

A recon iteration (`steps.ReconStep`) splices the subject vectors into the
caption at its placeholder, trains the SubjBasisGenerator and the global
scales `emb_scales` on the fg/bg-weighted reconstruction loss, under
`fgbg_reg` with the fg/bg attention regularizers, and under
`use_conv_attn_kernel_size` > 1 with subject conv-attention. With a
background generator (`bg_params`, its config `bg_basis_cfg` and the
zero-shot feature extractor `zs_extractor`), a recon iteration takes the
background ("y" token) branch with probability `use_background_token_prob`:
its captions are `caption_bg`, the CLIP features of the masked images come
from the extractor, and the background generator trains beside the subject
one (iteration type "recon_bg").

A compositional iteration (`TrainerConfig.stage2()`) takes the first
sample's 4-type prompts (`subj_prompt_single`, `subj_prompt_comp`,
`cls_prompt_single`, `cls_prompt_comp`; the first composition of each);
the subject-single row gets a 0.9 frozen / 0.1 live blend of the subject
vectors, the frozen copy of the SubjBasisGenerator taken at construction.
A fresh iteration (no cached x_recon for the batch's `subject_name`) draws
`num_candidate_teachers` candidates (the foreground pasted on noise, t in
[800, 1000)); the CLIP teacher filter (`clip_scorer`, an
`eval/clip_scorer.py` CLIPScorer) denoises and decodes them and keeps the
best teachable one, or skips the iteration ("compos_distill_skipped").
A reuse iteration takes the cached x_recon at t in [400, 700) and is
filtered on its second row. The step (`compos_step.ComposStep`) trains on
the mix-prompt distillation, prompt-delta, cross-layer and elastic fg/bg
preservation losses; its q BatchNorm statistics feed the running
`ca_q_bn_stats`, saved in checkpoints. Without a scorer the trainer
refuses compositional iterations unless `no_teacher_filter=True`, which
treats every iteration as teachable and says so in the metrics.

The gradient pipeline is clip_by_global_norm(0.5) -> Prodigy with the
warm-up + linear-decay schedule, or under `optimizer_type="AdamW"` AdamW at
`base_lr` times the warm-up + cosine schedule, behind MultiSteps(grad_accum)
(`prodigy.GradientPipeline`). Under `use_ema` an EMA of every trainable
tensor (`train/ema.py`, decay `ema_decay`) follows each distillation and
recon step, not the compositional ones. Metrics go to metrics.jsonl,
fetched from the device every `metrics_flush_every` steps; checkpoints are
native .npz snapshots of the trainable parameters (and the EMA's subject
generator) in the JAX package's layout. `save_full_state` /
`load_full_state` keep everything a resumed run needs to take the same
steps: parameters, optimizer and accumulator, the frozen generator copy,
the EMA, the host and device random streams, the teachable counters, and,
beyond the JAX package's, `ca_q_bn_stats` and the compositional reuse
cache. `log_samples` writes a PNG strip generated with the current
generator through `PromptConditioner` and the frozen models.
`make_static_recon_step` is the legacy textual-inversion mode's step.

Face ids come from `face_embedder` (ArcFace, `eval/face_eval.py`'s
`FaceSimilarityEvaluator`, or any object with `embed_image`) over each raw
image; a faceless image falls back to a random id from the host stream, as
in the JAX package. Without an embedder, `synthetic_faces=True` opts in to
random ids for every image.

`distribute(mesh, fsdp)` spreads training over the ranks of a (dp, fsdp)
device mesh (`parallel/mesh.py`, one rank a card under torchrun): the
frozen models, the VAE, the generator copy and the trainable parameters
sharded by the FSDP rule, the optimizer's slots and the EMA with them.
Every rank reads the same global host batch and makes the same host and
device draws; recon and distillation steps then compute this rank's rows
(HALF_BS rounded up to a multiple of dp), their losses' shares and
gradients summed over dp, while compositional iterations and the teacher
filter run whole on every rank. Saves gather the shards and rank 0 alone
writes files (metrics, checkpoints, sample grids).

The config carries every field of the JAX package's, with its defaults;
the constructor takes the JAX trainer's arguments in its order.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from adaprompt_tpu_torch.adaface import arc2face
from adaprompt_tpu_torch.adaface import checkpoint as ckpt_mod
from adaprompt_tpu_torch.adaface import conditioner as cond_mod
from adaprompt_tpu_torch.adaface.cls_delta import distribute_embedding_layerwise
from adaprompt_tpu_torch.adaface.subj_basis_generator import SUBJ_CONFIG, SubjBasisGenerator
from adaprompt_tpu_torch.models.clip_text import CLIPTextModel
from adaprompt_tpu_torch.models.unet import SD15_UNET_CONFIG, UNet
from adaprompt_tpu_torch.models.vae import SD_SCALE_FACTOR, VAE, _resize_mask_nearest
from adaprompt_tpu_torch.ops.layers import randomize_zero_init, reset_parameters
from adaprompt_tpu_torch.parallel import mesh as mesh_mod
from adaprompt_tpu_torch.train import compos_step as cs
from adaprompt_tpu_torch.train import ema as ema_mod
from adaprompt_tpu_torch.train import steps as steps_mod
from adaprompt_tpu_torch.train.compos import select_teachable_candidate
from adaprompt_tpu_torch.train.lr_schedules import (lambda_warmup_cosine_schedule,
                                                    prodigy_lr_schedule)
from adaprompt_tpu_torch.train.prodigy import AdamW, GradientPipeline, Prodigy


@dataclasses.dataclass
class TrainerConfig:
    """Defaults = the published Stage-1 run: d_coef 1, warm-up 600,
    Dirichlet clip-skip over alpha (1, 2, 2), Arc2Face distillation every
    iteration, no compositional iterations. `stage2()` is the Stage-2 preset."""
    max_steps: int = 120_000
    grad_accum: int = 2
    grad_clip: float = 0.5
    optimizer_type: str = "Prodigy"
    d_coef: float = 1.0
    prodigy_betas: tuple = (0.9, 0.999)
    warm_up_steps: int = 600
    scheduler_cycles: int = 1
    base_lr: float = 8e-4                    # the AdamW path only
    composition_regs_iter_gap: int = 0
    arc2face_distill_iter_prob: float = 1.0
    # ND candidates (1, 3, 5, 7) cut at max_num_denoising_steps, with probs
    # (0.4, 0.3, 0.2, 0.1) renormalized
    max_num_denoising_steps: int = 5
    num_denoising_steps_probs: tuple = (0.4, 0.3, 0.2, 0.1)
    skip_weights: tuple = (1.0, 2.0, 2.0)
    randomize_clip_skip: bool = True
    num_candidate_teachers: int = 2          # compositional iterations
    fgbg_reg: bool = True                    # fg/bg attention regularizers of recon iterations
    use_conv_attn_kernel_size: int = 0       # subject-token conv attention; 0 or 1 = off
    allow_self_teacher: bool = False
    # compositional iterations without a CLIP teacher filter, opted in
    no_teacher_filter: bool = False
    use_ema: bool = False
    ema_decay: float = 0.9999
    seed: int = 0
    ckpt_every: int = 500
    out_dir: str = "runs/adaprompt"
    compute_dtype: str = "bfloat16"
    metrics_flush_every: int = 16

    @classmethod
    def stage2(cls, **overrides):
        """Stage-2 compositional-distillation preset."""
        kw = dict(max_steps=60_000, d_coef=0.5, warm_up_steps=1000,
                  arc2face_distill_iter_prob=0.2, composition_regs_iter_gap=3,
                  max_num_denoising_steps=3)
        kw.update(overrides)
        return cls(**kw)


def make_static_recon_step(frozen: steps_mod.FrozenSD, static_cfg,
                           **kw) -> steps_mod.StaticReconStep:
    """The legacy textual-inversion recon step over a StaticLayerwiseEmbedding
    (`adaface/static_embedder.py`); its state holds {'static_emb': module}
    under `build_optimizer(cfg, ...)`."""
    return steps_mod.StaticReconStep(frozen, static_cfg, **kw)


def build_optimizer(cfg: TrainerConfig, params: list) -> GradientPipeline:
    """clip_by_global_norm(grad_clip) -> Prodigy (the warm-up + linear-decay
    schedule) or AdamW (base_lr times the warm-up + cosine schedule, b2
    0.993, weight decay 1e-4), behind MultiSteps(grad_accum)."""
    if cfg.optimizer_type == "Prodigy":
        inner = Prodigy(params, lr=prodigy_lr_schedule(cfg.max_steps, cfg.warm_up_steps,
                                                       cfg.scheduler_cycles),
                        betas=cfg.prodigy_betas, d_coef=cfg.d_coef, use_bias_correction=True,
                        safeguard_warmup=cfg.scheduler_cycles > 1)
    elif cfg.optimizer_type == "AdamW":
        sched = lambda_warmup_cosine_schedule(500, 0.01, 1.0, 0.1, cfg.max_steps)
        inner = AdamW(params, lr=lambda count: np.float32(cfg.base_lr) * sched(count),
                      betas=(0.9, 0.993))
    else:
        raise ValueError(cfg.optimizer_type)
    return GradientPipeline(inner, cfg.grad_clip, max(cfg.grad_accum, 1))


# the subject and background placeholders, each followed by K - 1 ", " so
# that their 16 and 4 spliced rows do not overlap
CAPTION_BG = "a photo of a z" + ", " * 15 + "person with background y" + ", " * 3
# the 4-type prompts of the compositional iterations, as the dataset builds
# them: the subject "z" and the class "person" each followed by K - 1 ", ",
# so that the class word sits at the subject's position; compositions
# "|"-joined
SUBJ_STRING, CLS_STRING = "z" + ", " * 15, "person" + ", " * 15
COMPOSITIONS = ("in the park", "smiling in the park")
SUBJECT_NAME = "synthetic_subject"


def synthetic_raw_batches(seed: int, batch_size: int = 4, size: int = 512):
    """Raw batches with the dataset's keys, from a seed: random images, a box
    foreground mask, an augmentation mask that pads ~29% of the width, a
    caption with the subject placeholder, and one with the subject and the
    background placeholders, each followed by K - 1 ", " as the dataset's
    prompts pad them (16 subject vectors, 4 background ones); the 4-type
    prompts of the compositional iterations and one subject name."""
    rng = np.random.default_rng(seed)
    while True:
        img = rng.integers(0, 256, (batch_size, size, size, 3), dtype=np.uint8)
        fg = np.zeros((batch_size, size, size), np.uint8)
        fg[:, size // 4:3 * size // 4, 5 * size // 16:11 * size // 16] = 1
        aug = np.ones((batch_size, size, size), np.uint8)
        aug[:, :, :150 * size // 512] = 0
        single = lambda word: f"a photo of a {word}"
        comp = lambda word: "|".join(f"{single(word)} {c}" for c in COMPOSITIONS)
        yield {"image": img.astype(np.float32) / 127.5 - 1.0, "image_unnorm": img,
               "fg_mask": fg, "aug_mask": aug, "caption": ["a photo of a z person"] * batch_size,
               "caption_bg": [CAPTION_BG] * batch_size,
               "subj_prompt_single": [single(SUBJ_STRING)] * batch_size,
               "subj_prompt_comp": [comp(SUBJ_STRING)] * batch_size,
               "cls_prompt_single": [single(CLS_STRING)] * batch_size,
               "cls_prompt_comp": [comp(CLS_STRING)] * batch_size,
               "subject_name": [SUBJECT_NAME] * batch_size}


class AdaPromptTrainer:
    """Host loop: the iteration-type state machine, batch prep, the steps, logging."""

    @classmethod
    def random_init(cls, seed: int, batch_iterator, cfg: TrainerConfig, *, device=None,
                    tokenizer=None, unet_cfg=None) -> "AdaPromptTrainer":
        """A full-width Stage-1 trainer with random weights from `seed`, made
        on the device (no checkpoint assets): student and a separate teacher
        SD-1.5 UNet (both with `unet_cfg`, e.g. a `flash_variant`; default
        SD-1.5's) and the VAE in the compute dtype, every zero-init layer
        randomized; the SD and Arc2Face CLIP-L encoders and the
        SubjBasisGenerator in float32; synthetic face ids."""
        from adaprompt_tpu_torch.pipeline import resolve_device
        from adaprompt_tpu_torch.utils.tokenizer import CLIPTokenizer
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        dt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        unet, teacher = (randomize_zero_init(reset_parameters(
            UNet(unet_cfg or SD15_UNET_CONFIG, device=device, dtype=dt), gen), gen)
            for _ in range(2))
        text, a2f_text = (reset_parameters(CLIPTextModel(device=device), gen) for _ in range(2))
        vae = reset_parameters(VAE(device=device, dtype=dt), gen)
        sbg = reset_parameters(SubjBasisGenerator(SUBJ_CONFIG, device=device), gen)
        frozen = steps_mod.FrozenSD(unet=unet, text=text, arc2face_text=a2f_text,
                                    teacher_unet=teacher)
        return cls(frozen, vae, tokenizer or CLIPTokenizer.fallback(), SUBJ_CONFIG, sbg,
                   batch_iterator, cfg, synthetic_faces=True)

    def __init__(self, frozen: steps_mod.FrozenSD, vae, tokenizer, subj_basis_cfg, sbg,
                 batch_iterator, cfg: TrainerConfig, face_embedder=None, subject_spec=None,
                 clip_scorer=None, synthetic_faces: bool = False, bg_basis_cfg=None,
                 bg_params=None, zs_extractor=None, bg_spec=None,
                 use_background_token_prob: float = 0.9, emb_noise_prob: dict | None = None,
                 emb_noise_std_range: tuple = (0.02, 0.04)):
        if bg_params is not None and (bg_basis_cfg is None or zs_extractor is None):
            raise ValueError("bg_params (the background SubjBasisGenerator) needs its config "
                             "bg_basis_cfg and a zs_extractor for the CLIP image features")
        if (cfg.composition_regs_iter_gap > 0 and clip_scorer is None
                and not cfg.no_teacher_filter):
            raise ValueError(
                "compositional iterations (composition_regs_iter_gap="
                f"{cfg.composition_regs_iter_gap}) with clip_scorer=None "
                "would treat EVERY fresh compos iter as teachable — the "
                "reference's CLIP teacher filter keeps only ~30-40% "
                "(ddpm.py:3649-3664). Pass a clip_scorer, or opt in "
                "explicitly with TrainerConfig(no_teacher_filter=True).")
        if face_embedder is None and not synthetic_faces:
            raise ValueError(
                "no face_embedder: training would distill against random "
                "identities (gen_arc2face_rand_face is a smoke-test path, "
                "ddpm.py:1788-1880). Pass face_embedder=FaceSimilarityEvaluator"
                "(arcface params) or opt in with synthetic_faces=True.")
        self.face_embedder, self.clip_scorer = face_embedder, clip_scorer
        self.bg_basis_cfg, self.bg_params, self.zs_extractor = bg_basis_cfg, bg_params, zs_extractor
        self.use_background_token_prob = use_background_token_prob
        # per-iteration-type embedding-noise probabilities
        self.emb_noise_prob = emb_noise_prob or {
            "recon_iter": 0.6, "arc2face_distill_iter": 0.0, "compos_distill_iter": 0.4}
        self.emb_noise_std_range = emb_noise_std_range
        self.frozen, self.vae, self.tokenizer = frozen, vae, tokenizer
        self.subj_basis_cfg, self.cfg = subj_basis_cfg, cfg
        self.batch_iterator = batch_iterator
        self.device = frozen.unet.out["conv"].weight.device
        self.dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        self.rng = np.random.default_rng(cfg.seed)
        self.gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self._global_step = 0
        if subject_spec is None or (bg_params is not None and bg_spec is None):
            specs = cond_mod.make_placeholders(
                tokenizer, ("z",), ("y",), num_vectors_subj=subj_basis_cfg.num_out_embs_per_layer,
                num_vectors_bg=bg_basis_cfg.num_out_embs_per_layer if bg_basis_cfg else 4)
            subject_spec, bg_spec = subject_spec or specs[0], bg_spec or specs[1]
        self.subject_spec, self.bg_spec = subject_spec, bg_spec
        params = {"subj_basis": sbg,
                  # learnable per-placeholder global scale scores
                  "emb_scales": nn.Parameter(torch.zeros(2, device=self.device))}
        if bg_params is not None:
            params["bg_basis"] = bg_params
        self.state = steps_mod.TrainState(
            params, build_optimizer(cfg, steps_mod.trainable_parameters(params)))
        # the compositional iterations' frozen snapshot of the generator, for
        # the 0.9 frozen / 0.1 live blend of the subj-single row
        self._frozen_sbg = (copy.deepcopy(sbg).requires_grad_(False)
                            if cfg.composition_regs_iter_gap > 0 else None)
        # the EMA of the trainable parameters, off in the reference configs
        self.ema = ema_mod.ema_init(params) if cfg.use_ema else None
        # teachable-fraction counters of the teacher filter
        self._num_filter_iters = self._num_teachable_iters = 0
        self._num_reuse_filter_iters = self._num_reuse_teachable_iters = 0
        # running statistics of the affine-free q BatchNorms {layer: {mean, var}}
        self.ca_q_bn_stats: dict = {}
        self._compos_phase = self._filter_phase = None
        self._cached_inits = cs.CachedInits(1000)
        self._recon_steps = {}     # keyed by (use_bg, fgbg_reg)
        self._distill_steps = {}
        self._fp = steps_mod.frozen_params(frozen)
        self.mesh, self._writer = None, True      # the rank that writes files
        os.makedirs(cfg.out_dir, exist_ok=True)
        self._metrics_file = open(os.path.join(cfg.out_dir, "metrics.jsonl"), "a")
        self._pending_metrics = []

    # -- multi-card --------------------------------------------------------------

    def distribute(self, mesh=None, fsdp: int = 1):
        """Shard the trainer over a (dp, fsdp) mesh (by default all the
        ranks of the initialised process group): the frozen models, the VAE,
        the generator copy and the trainable modules under the FSDP rule,
        bare trainable tensors replicated, the optimizer's slots and
        accumulator and the EMA's shadows cut to their parameters' shards;
        the cached steps are dropped. Returns the mesh."""
        if self.mesh is not None:
            raise RuntimeError("the trainer is distributed already")
        self.mesh = mesh or mesh_mod.make_mesh(fsdp=fsdp)
        f = self.frozen
        for m in (f.unet, f.text, f.arc2face_text, f.teacher_unet, self.vae, self._frozen_sbg):
            if m is not None:
                mesh_mod.shard_params(m, self.mesh)
        for v in self.state.params.values():
            (mesh_mod.shard_params if isinstance(v, nn.Module) else mesh_mod.replicate)(v, self.mesh)
        opt = self.state.optimizer
        for i, p in enumerate(opt.params):
            opt.acc[i] = mesh_mod.local_rows(mesh_mod.replicate(opt.acc[i], self.mesh), p)
            st = opt.inner.state[p]
            for k in st:
                st[k] = mesh_mod.local_rows(mesh_mod.replicate(st[k], self.mesh), p)
        opt.inner.param_sum = mesh_mod.param_sum(self.mesh)
        if self.ema is not None:
            for n, p in steps_mod.named_trainable(self.state.params):
                self.ema.shadow[n] = mesh_mod.local_rows(self.ema.shadow[n], p)
        self._writer = dist.get_rank() == 0
        self._recon_steps, self._distill_steps = {}, {}
        self._compos_phase = self._filter_phase = None
        return self.mesh

    def _split(self, batch: dict):
        """(this rank's rows of a recon or distillation batch, the step's
        keyword {'rows': the mesh that splits them}); (batch, {}) when the
        batch stays whole (no mesh, one row or rows that dp does not
        divide). The placeholder rows (`subj_bi`, `bg_bi`, one a row in
        order) become local row indices."""
        b = batch["z0"].shape[0]
        if not mesh_mod.splits_rows(b, self.mesh):
            return batch, {}
        out = mesh_mod.shard_batch(batch, self.mesh)
        offset = self.mesh.get_local_rank("dp") * (b // self.mesh["dp"].size())
        for k in ("subj_bi", "bg_bi"):
            if k in out:
                out[k] = out[k] - offset
        return out, {"rows": self.mesh}

    def _build_optimizer(self) -> GradientPipeline:
        opt = build_optimizer(self.cfg, steps_mod.trainable_parameters(self.state.params))
        if self.mesh is not None:
            opt.inner.param_sum = mesh_mod.param_sum(self.mesh)
        return opt

    def _trainables(self) -> list:
        """The trainable modules and the generator copy (what a save gathers)."""
        mods = [v for v in self.state.params.values() if isinstance(v, nn.Module)]
        return mods + ([self._frozen_sbg] if self._frozen_sbg is not None else [])

    # -- batch prep ---------------------------------------------------------

    def _skip_weights(self) -> np.ndarray:
        base = np.asarray(self.cfg.skip_weights, np.float64)
        w = self.rng.dirichlet(base) if self.cfg.randomize_clip_skip else base / base.sum()
        return w.astype(np.float32)

    def _emb_noise_std(self, iter_type: str) -> float:
        """The embedding noise's std: U(emb_noise_std_range) with the
        iteration type's probability, else 0 (off); the std is drawn only
        when the coin comes up."""
        if self.rng.random() >= self.emb_noise_prob.get(iter_type, 0.0):
            return 0.0
        lo, hi = self.emb_noise_std_range
        return float(self.rng.uniform(lo, hi))

    def _emb_scale_perturb(self) -> np.ndarray:
        """U(0.8, 1.4) training perturbation of the two global scales."""
        return self.rng.uniform(0.8, 1.4, size=(2,)).astype(np.float32)

    @property
    def training_percent(self) -> float:
        """Progress in [0, 1]; drives the compositional mix-scale anneal."""
        return min(self._global_step / max(self.cfg.max_steps, 1), 1.0)

    def _sample_num_denoising_steps(self) -> int:
        cand = [s for s in (1, 3, 5, 7) if s <= self.cfg.max_num_denoising_steps]
        p = np.asarray(self.cfg.num_denoising_steps_probs[:len(cand)], np.float64)
        return int(self.rng.choice(cand, p=p / p.sum()))

    def _latent_mask(self, mask_np) -> torch.Tensor:
        m = torch.as_tensor(np.asarray(mask_np, np.float32), device=self.device)[..., None]
        f = 2 ** (self.vae.cfg.num_resolutions - 1)
        return _resize_mask_nearest(m, (m.shape[1] // f, m.shape[2] // f))

    @torch.no_grad()
    def prepare_recon_batch(self, raw: dict, use_bg: bool = False,
                            iter_type: str = "recon_iter") -> dict:
        """Latents, face ids, the tokenized captions with the subject
        placeholder's rows and positions (row i at position 1 where a
        caption lacks it), latent-size masks, and the host draws: clip-skip
        weights, the embedding-noise std of `iter_type` and the global-scale
        perturbation. Each image's id is its first face's embedding, or a
        random one when it shows no face or there is no embedder. Under
        `use_bg` the captions are `caption_bg`, and the batch also holds the
        background placeholder's rows and positions (same fallback) and the
        zero-shot CLIP features of the fg- and bg-masked images."""
        imgs = torch.as_tensor(np.asarray(raw["image"]), device=self.device).to(self.dtype)
        z0 = (self.vae.encode(imgs)[0] * SD_SCALE_FACTOR).float()
        ids = np.asarray(self.tokenizer(list(raw["caption_bg"] if use_bg else raw["caption"])))
        bi, pos = cond_mod.find_placeholder_indices(ids, self.subject_spec)
        b = z0.shape[0]
        if self.face_embedder is not None:
            embs = [self.face_embedder.embed_image(im) for im in raw["image_unnorm"]]
            faceid = np.stack([e[:1].reshape(-1) if len(e) else
                               self.rng.standard_normal(512).astype(np.float32) for e in embs])
        else:
            faceid = self.rng.standard_normal((b, 512)).astype(np.float32)
        faceid = faceid / np.linalg.norm(faceid, axis=-1, keepdims=True)
        dev = self.device
        batch = {"z0": z0, "faceid": torch.as_tensor(faceid, device=dev),
                "caption_ids": torch.as_tensor(ids, device=dev).long(),
                "subj_bi": torch.as_tensor(bi if len(bi) == b else np.arange(b), device=dev).long(),
                "subj_pos": torch.as_tensor(pos if len(pos) == b else np.full(b, 1),
                                            device=dev).long(),
                "fg_mask": self._latent_mask(raw["fg_mask"]),
                "aug_mask": self._latent_mask(raw["aug_mask"]),
                "skip_weights": torch.as_tensor(self._skip_weights(), device=dev),
                "emb_noise_std": torch.tensor(self._emb_noise_std(iter_type), device=dev),
                "emb_scale_perturb": torch.as_tensor(self._emb_scale_perturb(), device=dev)}
        if use_bg:
            bg_bi, bg_pos = cond_mod.find_placeholder_indices(ids, self.bg_spec)
            clip_feats, _, _ = self.zs_extractor(raw["image_unnorm"], fg_masks=raw.get("fg_mask"),
                                                 is_face=True)
            batch.update({
                "clip_features": clip_feats.to(dev),
                "bg_bi": torch.as_tensor(bg_bi if len(bg_bi) == b else np.arange(b),
                                         device=dev).long(),
                "bg_pos": torch.as_tensor(bg_pos if len(bg_pos) == b else np.full(b, 1),
                                          device=dev).long()})
        return batch

    # -- the state machine --------------------------------------------------------

    def _distill_step(self, nd: int) -> steps_mod.DistillStep:
        if nd not in self._distill_steps:
            self._distill_steps[nd] = steps_mod.make_arc2face_distill_step(
                self.frozen, self.tokenizer, self.subj_basis_cfg, num_denoising_steps=nd,
                compute_dtype=self.dtype, skip_weights=self.cfg.skip_weights,
                allow_self_teacher=self.cfg.allow_self_teacher)
        return self._distill_steps[nd]

    def _get_recon_step(self, use_bg: bool, fgbg_reg: bool) -> steps_mod.ReconStep:
        key = (use_bg, fgbg_reg)
        if key not in self._recon_steps:
            self._recon_steps[key] = steps_mod.make_zs_recon_step(
                self.frozen, self.tokenizer, self.subj_basis_cfg, bg_basis_cfg=self.bg_basis_cfg,
                use_bg=use_bg, fgbg_reg=fgbg_reg,
                compute_dtype=self.dtype,
                conv_attn_kernel_size=self.cfg.use_conv_attn_kernel_size)
        return self._recon_steps[key]

    # -- compositional distillation iterations --------------------------------------

    def _mp_compos(self) -> dict:
        """The frozen models of the compositional phases."""
        return {**self._fp, "vae": self.vae, "frozen_sbg": self._frozen_sbg}

    def _compos_context(self, params: dict, mp: dict, batch: dict, draws: dict | None) -> dict:
        """The 4-type contexts: the live subject vectors (with the embedding
        noise when the batch has a std, and the global scale) spliced into
        the subj-comp row, their 0.9 frozen / 0.1 live blend into the
        subj-single row, every layer's prompt encoded, and the class word
        spread over the K aligned slots of the cls rows. Without
        'emb_noise_std' in the batch (the filter) no noise is added."""
        tok, k = self.tokenizer, self.subj_basis_cfg.num_out_embs_per_layer
        with torch.no_grad():
            _, core_id = arc2face.forward_face_embs(mp["arc2face_text"], tok, batch["faceid"],
                                                    input_max_length=21)
            frozen_embs, _ = mp["frozen_sbg"](tok, core_id, is_training=True)
        subj_embs, _ = params["subj_basis"](tok, core_id, is_training=True)
        std = batch.get("emb_noise_std")
        if std is not None:
            subj_embs = cond_mod.add_noise_to_tensor(subj_embs, std, noise=draws["emb_noise"])
        subj_embs = steps_mod.apply_emb_scale(subj_embs, params, batch, 0)
        subj_single = frozen_embs * 0.9 + subj_embs * 0.1
        rows, pos4 = batch["subj_rows"], batch["subj_pos4"]
        ctx4 = cond_mod.encode_spliced(
            mp["text"], batch["ids4"], [(subj_single[:, :1], rows[:1], pos4[:1], k),
                                        (subj_embs[:, :1], rows[1:2], pos4[1:2], k)],
            batch["skip_weights"], 16, layerwise=True)
        ctx4 = distribute_embedding_layerwise(ctx4, [2, 3], batch["cls_pos"], k)
        mask = (batch["ids4"] != tok.eos_id).float()[..., None]
        return {"ctx4": ctx4, "static_embs": ctx4.transpose(0, 1), "prompt_emb_mask": mask,
                "subj_pos": batch.get("subj_pos_host"), "bg_pos": None}

    def _ensure_compos(self):
        if self._compos_phase is None:
            cfg = self.subj_basis_cfg
            self._compos_phase = cs.ComposStep(
                self._compos_context, (1, cfg.num_out_layers, cfg.num_out_embs_per_layer,
                                       cfg.output_dim), compute_dtype=self.dtype)

    @torch.no_grad()
    def prepare_compos_batch(self, raw: dict) -> dict | None:
        """The 4-type prompt batch of the first sample: its latents, face id,
        latent-size fg mask, the tokenized prompts with the subject rows and
        positions, the clip-skip weights; None when the placeholder is not
        in the two subject prompts. The class word is expected at the
        subject's position (aligned templates)."""
        sfx = "_fp" if "subj_prompt_single_fp" in raw else ""
        prompts = [raw[f"subj_prompt_single{sfx}"][0],
                   raw[f"subj_prompt_comp{sfx}"][0].split("|")[0],
                   raw[f"cls_prompt_single{sfx}"][0],
                   raw[f"cls_prompt_comp{sfx}"][0].split("|")[0]]
        ids4 = np.asarray(self.tokenizer(prompts))
        bi, pos = cond_mod.find_placeholder_indices(ids4, self.subject_spec)
        if len(bi) < 2 or list(bi[:2]) != [0, 1]:
            return None
        dev = self.device
        imgs = torch.as_tensor(np.asarray(raw["image"][:1]), device=dev).to(self.dtype)
        z0 = (self.vae.encode(imgs)[0] * SD_SCALE_FACTOR).float()
        if self.face_embedder is not None:
            e = self.face_embedder.embed_image(raw["image_unnorm"][0])
            faceid = e[:1] if len(e) else self.rng.standard_normal((1, 512)).astype(np.float32)
        else:
            faceid = self.rng.standard_normal((1, 512)).astype(np.float32)
        faceid = faceid / np.linalg.norm(faceid, axis=-1, keepdims=True)
        pos2 = torch.as_tensor(pos[:2], device=dev).long()
        return {"z0": z0, "ids4": torch.as_tensor(ids4, device=dev).long(),
                "subj_rows": torch.as_tensor(bi[:2], device=dev).long(), "subj_pos4": pos2,
                "cls_pos": pos2,
                "subj_pos_host": [int(pos[0]) + i for i in range(self.subject_spec.num_vectors)],
                "faceid": torch.as_tensor(faceid, device=dev),
                "fg_mask": self._latent_mask(raw["fg_mask"][:1]),
                "skip_weights": torch.as_tensor(self._skip_weights(), device=dev),
                "subject_name": raw["subject_name"][0], "cls_comp_prompt": prompts[3]}

    def _teacher_filter(self, cbatch: dict, x_start_cand, t_cand, noise_cand):
        """The CLIP teacher filter over N candidates x_start_cand, t_cand,
        noise_cand ([N, h, w, 4], [N], [N, h, w, 4]): the (subj_comp x N,
        cls_comp x N) batch denoised once by one conditional pass (no
        gradient, no unconditional pass), decoded, and scored against the
        class comp prompt; losses 0.5 - similarity. -> (is_teachable, the
        best candidate, filter metrics); without a scorer (the
        no_teacher_filter opt-in) every candidate is teachable."""
        if self.clip_scorer is None:
            return True, 0, {"teacher_filter_disabled": 1.0}
        if self._filter_phase is None:
            self._filter_phase = cs.make_filter_phase(compute_dtype=self.dtype)
        abatch = {k: cbatch[k] for k in ("faceid", "ids4", "subj_rows", "subj_pos4", "cls_pos",
                                         "skip_weights")}
        mp = self._mp_compos()
        with torch.no_grad():
            ctx4 = self._compos_context(self.state.params, mp, abatch, None)["ctx4"]
        n = x_start_cand.shape[0]
        ctx2 = torch.cat([ctx4[:, 1:2].expand(-1, n, -1, -1),
                          ctx4[:, 3:4].expand(-1, n, -1, -1)], dim=1)
        _, imgs = self._filter_phase(mp, ctx2, ctx2, torch.cat([x_start_cand] * 2),
                                     torch.cat([t_cand] * 2), torch.cat([noise_cand] * 2))
        sims = self.clip_scorer.txt_to_img_similarity([cbatch["cls_comp_prompt"]] * (2 * n), imgs,
                                                      reduction="diag")
        losses = 0.5 - sims.float().cpu().numpy().reshape(-1)
        loss_subj, loss_mix = losses[:n], losses[n:]
        teachable, best = select_teachable_candidate(loss_subj, loss_mix)
        return teachable, best, {"loss_clip_subj_comp": float(loss_subj.mean()),
                                 "loss_clip_cls_comp": float(loss_mix.mean())}

    def _log_teachable(self, metrics: dict, teachable: bool, reuse: bool):
        """The teachable-fraction counters, and the colour of the next sample
        grid: 1 fresh teachable, 2 not teachable, 3 reuse teachable."""
        self._last_teach_color = 3 if (teachable and reuse) else 1 if teachable else 2
        self._num_filter_iters += 1
        self._num_teachable_iters += int(teachable)
        metrics["teachable"] = float(teachable)
        metrics["teachable_frac"] = self._num_teachable_iters / max(self._num_filter_iters, 1)
        if reuse:
            self._num_reuse_filter_iters += 1
            self._num_reuse_teachable_iters += int(teachable)
            metrics["reuse_teachable_frac"] = (self._num_reuse_teachable_iters
                                               / max(self._num_reuse_filter_iters, 1))

    def _compos_step(self, cbatch: dict) -> dict:
        self._ensure_compos()
        name, dev = cbatch["subject_name"], self.device
        fresh = not self._cached_inits.has(name)
        if not fresh:
            # reuse: the cached x_recon at a mid-range t, filtered on its second row
            x_np, t_np = self._cached_inits.take(name, self.rng)
            x_start = torch.as_tensor(x_np, device=dev)
            t = torch.as_tensor(t_np, device=dev).long()
            noise = torch.randn(x_start.shape, generator=self.gen, device=dev)
            teachable, _, fmetrics = self._teacher_filter(cbatch, x_start[1:2], t[1:2],
                                                          noise[1:2])
        else:
            # fresh: N candidate (x_start, t, noise) triples; the winner's is tiled 4x
            n_cand = self.cfg.num_candidate_teachers
            fg_np = cbatch["fg_mask"].cpu().numpy()
            cands = []
            for _ in range(n_cand):
                scale = cs.pick_fg_rand_scale(fg_np, self.rng)
                xc, _, _ = cs.init_x_with_fg_from_training_image(
                    cbatch["z0"], cbatch["fg_mask"], cbatch["fg_mask"], scale, gen=self.gen)
                cands.append(xc)
            x_cand = torch.cat(cands)
            t_cand = torch.as_tensor(self.rng.integers(800, 1000, size=(n_cand,)),
                                     device=dev).long()
            noise_cand = torch.randn(x_cand.shape, generator=self.gen, device=dev)
            teachable, best, fmetrics = self._teacher_filter(cbatch, x_cand, t_cand, noise_cand)
            if teachable:
                x_start = x_cand[best:best + 1].repeat(4, 1, 1, 1)
                t = t_cand[best:best + 1].repeat(4)
                noise = noise_cand[best:best + 1].repeat(4, 1, 1, 1)
        if not teachable:
            out = {"iter_type": "compos_distill_skipped", **fmetrics}
            self._log_teachable(out, False, reuse=not fresh)
            return out
        batch = {"x_start": x_start, "t": t, "noise": noise,
                 "training_percent": torch.tensor(self.training_percent, device=dev),
                 "fg_mask": cbatch["fg_mask"], "faceid": cbatch["faceid"], "ids4": cbatch["ids4"],
                 "subj_rows": cbatch["subj_rows"], "subj_pos4": cbatch["subj_pos4"],
                 "cls_pos": cbatch["cls_pos"], "subj_pos_host": tuple(cbatch["subj_pos_host"]),
                 "skip_weights": cbatch["skip_weights"],
                 # the host draws in the JAX trainer's order: the noise coin
                 # (and std), the scale perturbation, the outfeat-LayerNorm coin
                 "emb_noise_std": torch.tensor(self._emb_noise_std("compos_distill_iter"),
                                               device=dev),
                 "emb_scale_perturb": torch.as_tensor(self._emb_scale_perturb(), device=dev),
                 "normalize_outfeat": torch.tensor(float(self.rng.random() < 0.5), device=dev)}
        self.state, metrics, x_recon = self._compos_phase(self.state, self._mp_compos(), batch,
                                                          self.gen)
        # only fresh iterations refill the cache; a reuse iteration consumed its entry
        if fresh:
            self._cached_inits.put(name, x_recon.cpu().numpy(), t.cpu().numpy())
        self._update_q_bn_stats(metrics.pop("q_bn_stats"))
        metrics.update(fmetrics)
        metrics["iter_type"] = "compos_distill"
        if self.clip_scorer is not None:
            self._log_teachable(metrics, True, reuse=not fresh)
        return metrics

    def _update_q_bn_stats(self, batch_stats: dict, momentum: float = 0.1):
        """Fold a step's q BatchNorm batch statistics into the running mean
        and variance with torch's default momentum (the first sets them)."""
        for li, (m, v) in batch_stats.items():
            ent = self.ca_q_bn_stats.get(li)
            if ent is None:
                self.ca_q_bn_stats[li] = {"mean": m, "var": v}
            else:
                ent["mean"] = (1 - momentum) * ent["mean"] + momentum * m
                ent["var"] = (1 - momentum) * ent["var"] + momentum * v

    def train_step(self, step_idx: int) -> dict:
        self._global_step = step_idx
        raw = next(self.batch_iterator)
        gap = self.cfg.composition_regs_iter_gap
        if gap > 0 and step_idx % gap == 0 and step_idx > 0:
            cbatch = self.prepare_compos_batch(raw)
            if cbatch is not None:
                return self._emit_metrics(step_idx, self._compos_step(cbatch))
        do_distill = self.rng.random() < self.cfg.arc2face_distill_iter_prob
        # the background token only on recon iterations, and only with a
        # background generator (no draw is made without one)
        use_bg = (not do_distill and self.bg_params is not None
                  and self.rng.random() < self.use_background_token_prob)
        batch = self.prepare_recon_batch(
            raw, use_bg=use_bg, iter_type="arc2face_distill_iter" if do_distill else "recon_iter")
        if not do_distill:
            # the fg/bg attention regularizers run on recon iterations
            step_fn = self._get_recon_step(use_bg, self.cfg.fgbg_reg)
            batch, rows = self._split(batch)
            self.state, metrics = step_fn(self.state, self._fp, batch, self.gen, **rows)
            metrics["iter_type"] = "recon_bg" if use_bg else "recon"
            self._update_ema()
            return self._emit_metrics(step_idx, metrics, self._host_stats())
        nd = self._sample_num_denoising_steps()
        batch = self._half_batch(batch, nd)
        distill_bs = int(batch["z0"].shape[0])
        batch, rows = self._split(batch)
        self.state, metrics = self._distill_step(nd)(self.state, self._fp, batch, self.gen, **rows)
        metrics.update(iter_type="arc2face_distill", num_denoising_steps=nd,
                       distill_bs=distill_bs)
        self._update_ema()
        return self._emit_metrics(step_idx, metrics, self._host_stats())

    def _half_batch(self, batch: dict, nd: int) -> dict:
        """HALF_BS: multi-step distillation (ND > 1) keeps the first
        ceil(B / ND) rows, rounded up to a multiple of dp over a mesh so that
        every rank keeps a row."""
        b = batch["z0"].shape[0]
        if nd == 1:
            return batch
        half_bs = -(-b // nd)
        if self.mesh is not None:
            dp = self.mesh["dp"].size()
            half_bs = max(dp, -(-half_bs // dp) * dp)
        if half_bs >= b:
            return batch
        return {k: (v[:half_bs] if isinstance(v, torch.Tensor) and v.ndim >= 1
                    and v.shape[0] == b else v) for k, v in batch.items()}

    def _update_ema(self):
        """After every distillation and recon step (micro-steps of an
        accumulation too); the compositional steps leave the EMA alone."""
        if self.ema is not None:
            ema_mod.ema_update(self.ema, self.state.params, decay=self.cfg.ema_decay)

    def _emit_metrics(self, step_idx: int, metrics: dict, host_stats: dict | None = None) -> dict:
        """Queue a metrics row; device scalars reach the host every
        cfg.metrics_flush_every steps, in one copy."""
        dev = {k: v for k, v in metrics.items() if isinstance(v, torch.Tensor)}
        host = {k: v for k, v in metrics.items() if not isinstance(v, torch.Tensor)}
        host["step"] = step_idx
        host.update(host_stats or {})
        self._pending_metrics.append((dev, host))
        if len(self._pending_metrics) >= max(1, self.cfg.metrics_flush_every):
            return self._flush_metrics()
        return {**host, **dev}

    def _flush_metrics(self) -> dict:
        if not self._pending_metrics:
            return {}
        rows, self._pending_metrics = self._pending_metrics, []
        keys = [sorted(dev) for dev, _ in rows]
        flat = [dev[k].float().reshape(()) for (dev, _), ks in zip(rows, keys) for k in ks]
        values = iter(torch.stack(flat).cpu().tolist() if flat else [])
        out = {}
        for (_, host), ks in zip(rows, keys):
            out = {k: next(values) for k in ks}
            out.update(host)
            if self._writer:
                self._metrics_file.write(json.dumps(out) + "\n")
        self._metrics_file.flush()
        return out

    def _host_stats(self) -> dict:
        """Step time, and the device's memory every 50 steps."""
        now = time.time()
        stats = {}
        if getattr(self, "_last_step_t", None) is not None:
            stats["step_time_s"] = round(now - self._last_step_t, 4)
        self._last_step_t = now
        if self._global_step % 50 == 0 and self.device.type == "cuda":
            stats["device_mem_gb"] = round(torch.cuda.memory_allocated(self.device) / 2 ** 30, 3)
            stats["device_peak_mem_gb"] = round(
                torch.cuda.max_memory_allocated(self.device) / 2 ** 30, 3)
        return stats

    def train(self, num_steps: int | None = None) -> float:
        n = num_steps or self.cfg.max_steps
        t0 = time.time()
        for i in range(n):
            self.train_step(i)
            if (i + 1) % self.cfg.ckpt_every == 0 or i == n - 1:
                self.save_checkpoint(i + 1)
        return time.time() - t0

    # -- checkpoints ---------------------------------------------------------------

    def save_checkpoint(self, step: int) -> str:
        """The trainable parameters (whole, gathered over a mesh), the EMA's
        subject generator and ca_q_bn_stats to embeddings_gs-{step}.npz; over
        a mesh every rank gathers and rank 0 alone writes."""
        self._flush_metrics()
        path = os.path.join(self.cfg.out_dir, f"embeddings_gs-{step}.npz")
        params = self.state.params
        shadows = self._whole_ema()
        with mesh_mod.gathered(*self._trainables()):
            trees = {"subj_basis": ckpt_mod.module_tree(params["subj_basis"])}
            if "bg_basis" in params:
                trees["bg_basis"] = ckpt_mod.module_tree(params["bg_basis"])
        trees["emb_scales"] = {"scores": params["emb_scales"].detach().float().cpu().numpy()}
        if self.ema is not None:
            pre = "subj_basis."
            trees["ema_subj_basis"] = ckpt_mod.named_tree(
                (n[len(pre):], v) for n, v in shadows.items() if n.startswith(pre))
        if self.ca_q_bn_stats:
            trees["ca_q_bns"] = {str(li): {k: v.float().cpu().numpy() for k, v in ent.items()}
                                 for li, ent in self.ca_q_bn_stats.items()}
        if self._writer:
            ckpt_mod.save_checkpoint(path, trees,
                                     meta={"step": step, "placeholder": self.subject_spec.string})
        self._barrier()
        return path

    def _whole_ema(self) -> dict:
        """The EMA's shadows, each whole (gathered over a mesh)."""
        if self.ema is None:
            return {}
        return {n: mesh_mod.unshard(self.ema.shadow[n], p)
                for n, p in steps_mod.named_trainable(self.state.params)}

    def _barrier(self):
        """Over a mesh, wait for rank 0's file."""
        if self.mesh is not None:
            dist.barrier()

    def load_checkpoint(self, path: str) -> dict:
        """Load the trainable parameters and the q BatchNorm running
        statistics; the frozen blend copy of the generator becomes the loaded
        weights, and the optimizer starts afresh, as in the JAX package (which
        also leaves the EMA and a saved `ema_subj_basis` alone)."""
        trees, meta = ckpt_mod.load_checkpoint(path)
        params = self.state.params
        with mesh_mod.gathered(*self._trainables(), writeback=True):
            ckpt_mod.load_module_tree(params["subj_basis"], trees["subj_basis"])
            if self._frozen_sbg is not None:
                ckpt_mod.load_module_tree(self._frozen_sbg, trees["subj_basis"])
            if "bg_basis" in trees and "bg_basis" in params:
                ckpt_mod.load_module_tree(params["bg_basis"], trees["bg_basis"])
        if "ca_q_bns" in trees:
            self.ca_q_bn_stats = {int(li): {k: torch.as_tensor(a, device=self.device)
                                            for k, a in ent.items()}
                                  for li, ent in trees["ca_q_bns"].items()}
        if "emb_scales" in trees:
            with torch.no_grad():
                params["emb_scales"].copy_(torch.as_tensor(trees["emb_scales"]["scores"]))
        self.state = steps_mod.TrainState(params, self._build_optimizer())
        return meta

    # -- full-state resume ---------------------------------------------------------

    def save_full_state(self, step: int) -> str:
        """Write trainer_state-{step}.npz to out_dir (the metrics flushed
        first): the parameters ('params.<name>/...' in the JAX layout,
        emb_scales bare), the gradient pipeline's accumulator and micro-step
        and the optimizer's slots and scalars, the frozen generator copy, the
        EMA, the device generator's state, ca_q_bn_stats and the reuse cache,
        and a '__meta__' JSON with the step, the numpy stream's state and the
        teachable counters."""
        self._flush_metrics()
        params, flat = self.state.params, {}
        shadows = self._whole_ema()
        with mesh_mod.gathered(*self._trainables()):
            for name, v in params.items():
                if isinstance(v, nn.Module):
                    flat.update(ckpt_mod._flatten(ckpt_mod.module_tree(v), f"params.{name}/"))
                else:
                    flat[f"params.{name}"] = ckpt_mod._numpy(v)
            if self._frozen_sbg is not None:
                flat.update(ckpt_mod._flatten(ckpt_mod.module_tree(self._frozen_sbg),
                                              "frozen_sbg/"))
        names = [n for n, _ in steps_mod.named_trainable(params)]
        opt_flat, opt_meta = ckpt_mod.optimizer_entries(self.state.optimizer, names,
                                                        whole=mesh_mod.unshard)
        flat.update(opt_flat)
        if self.ema is not None:
            flat.update(ckpt_mod.tensor_entries("emastate/", shadows))
        flat["gen_state"] = self.gen.get_state().numpy()
        for li, ent in self.ca_q_bn_stats.items():
            flat.update(ckpt_mod.tensor_entries(f"ca_q_bns/{li}/", ent))
        cached = list(self._cached_inits.cache.items())
        for i, (_, entry) in enumerate(cached):
            flat.update({f"cached_inits/{i}/{k}": np.asarray(v) for k, v in entry.items()})
        meta = {"step": step, "global_step": self._global_step,
                "rng_state": self.rng.bit_generator.state,
                "counters": [self._num_filter_iters, self._num_teachable_iters,
                             self._num_reuse_filter_iters, self._num_reuse_teachable_iters],
                "state_step": self.state.step, "optimizer": opt_meta,
                "ema_num_updates": None if self.ema is None else self.ema.num_updates,
                "cached_inits": [name for name, _ in cached],
                "last_teach_color": getattr(self, "_last_teach_color", None)}
        flat["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
        path = os.path.join(self.cfg.out_dir, f"trainer_state-{step}.npz")
        if self._writer:
            np.savez(path, **flat)
        self._barrier()
        return path

    def load_full_state(self, path: str) -> dict:
        """Restore what save_full_state wrote onto this trainer's device, in
        place; the trainer must be built as the saving one was (the same
        models, optimizer type, EMA and generator copy). Over a mesh each
        rank reads the file and keeps its shards. Returns the meta."""
        data = np.load(path, allow_pickle=False)
        meta = json.loads(bytes(data["__meta__"]).decode())
        flat = {k: data[k] for k in data.files if k != "__meta__"}
        params = self.state.params
        # first: it refuses a state of another optimizer before anything moves
        named = steps_mod.named_trainable(params)
        ckpt_mod.load_optimizer_entries(self.state.optimizer, [n for n, _ in named], flat,
                                        meta["optimizer"], local=mesh_mod.local_rows)
        with torch.no_grad(), mesh_mod.gathered(*self._trainables(), writeback=True):
            for name, v in params.items():
                if isinstance(v, nn.Module):
                    ckpt_mod.load_module_tree(
                        v, ckpt_mod._unflatten(ckpt_mod.group(flat, f"params.{name}/")))
                else:
                    v.copy_(torch.as_tensor(flat[f"params.{name}"]))
            if self._frozen_sbg is not None:
                ckpt_mod.load_module_tree(
                    self._frozen_sbg, ckpt_mod._unflatten(ckpt_mod.group(flat, "frozen_sbg/")))
        self.state.step = int(meta["state_step"])
        if self.ema is not None:
            with torch.no_grad():
                for n, p in named:
                    self.ema.shadow[n].copy_(
                        mesh_mod.local_rows(torch.as_tensor(flat["emastate/" + n]), p))
            self.ema.num_updates = int(meta["ema_num_updates"])
        self.gen.set_state(torch.from_numpy(flat["gen_state"]))
        self.rng.bit_generator.state = meta["rng_state"]
        self._global_step = int(meta["global_step"])
        (self._num_filter_iters, self._num_teachable_iters,
         self._num_reuse_filter_iters, self._num_reuse_teachable_iters) = meta["counters"]
        bn = ckpt_mod.group(flat, "ca_q_bns/")
        self.ca_q_bn_stats = {}
        for key, a in bn.items():
            li, k = key.split("/")
            self.ca_q_bn_stats.setdefault(int(li), {})[k] = torch.as_tensor(a, device=self.device)
        self._cached_inits.cache = {
            name: {k: flat[f"cached_inits/{i}/{k}"] for k in ("x_start", "t")}
            for i, name in enumerate(meta["cached_inits"])}
        if meta["last_teach_color"] is not None:
            self._last_teach_color = meta["last_teach_color"]
        return meta

    # -- the sample grid ---------------------------------------------------------------

    @torch.no_grad()
    def log_samples(self, step: int, prompt: str = "a photo of a z",
                    faceid: np.ndarray | None = None, num_steps: int = 20, n: int = 2,
                    height: int = 512, width: int = 512) -> str:
        """Generate n images of `prompt` with the current SubjBasisGenerator
        (DDIM with CFG against the default negative prompt, seed `step`) and
        write them side by side to samples_gs-{step}.png in out_dir, boxed in
        the colour of the last teacher-filter decision (green fresh
        teachable, red not teachable, purple reuse teachable; none before
        the first). Without `faceid` [1, 512] a random unit id is drawn from
        the host stream. Over a mesh every rank generates and rank 0 writes. The pipeline is built once over the trainer's own
        frozen UNet, VAE and text encoder."""
        from adaprompt_tpu_torch.pipeline import DEFAULT_NEGATIVE_PROMPT, StableDiffusionPipeline
        from adaprompt_tpu_torch.utils.png import write_png
        if faceid is None:
            faceid = self.rng.standard_normal((1, 512)).astype(np.float32)
            faceid /= np.linalg.norm(faceid, axis=-1, keepdims=True)
        if getattr(self, "_sample_pipe", None) is None:
            self._sample_pipe = StableDiffusionPipeline(self.frozen.unet, self.vae,
                                                        self.frozen.text, self.tokenizer)
            self._sample_pc = cond_mod.PromptConditioner(self.frozen.text, self.tokenizer,
                                                         [self.subject_spec])
        _, core_id = arc2face.forward_face_embs(
            self.frozen.arc2face_text, self.tokenizer,
            torch.as_tensor(np.asarray(faceid, np.float32), device=self.device),
            input_max_length=21)
        subj_embs, _ = self.state.params["subj_basis"](self.tokenizer, core_id,
                                                       is_training=False)
        cond = self._sample_pc([prompt] * n, {self.subject_spec.string: subj_embs})
        uncond = self._sample_pc([DEFAULT_NEGATIVE_PROMPT] * n, {})
        imgs = self._sample_pipe.generate(None, context=cond, context_uncond=uncond,
                                          num_steps=num_steps, height=height, width=width,
                                          seed=step).copy()
        color = {1: (0, 255, 0), 2: (255, 0, 0),
                 3: (160, 32, 240)}.get(getattr(self, "_last_teach_color", 0))
        if color is not None:
            imgs[:, :6], imgs[:, -6:] = color, color
            imgs[:, :, :6], imgs[:, :, -6:] = color, color
        path = os.path.join(self.cfg.out_dir, f"samples_gs-{step}.png")
        if self._writer:
            write_png(path, np.concatenate(list(imgs), axis=1))
        return path
