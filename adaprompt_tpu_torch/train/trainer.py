"""Training orchestration: the host loop of Stage-1 Arc2Face distillation.

Port of `adaprompt_tpu/train/trainer.py` for distillation iterations. Per
step the host draws, from `numpy.random.default_rng(cfg.seed)` and in the
JAX package's order: the iteration type, the synthetic face ids, the
Dirichlet clip-skip weights, the embedding-noise coin and the global-scale
perturbation (both unused by distillation, drawn to keep the stream), and
ND over (1, 3, 5, 7). ND > 1 keeps the first ceil(B / ND) rows (HALF_BS).
The device draws come from a `torch.Generator` seeded with cfg.seed.

The gradient pipeline is clip_by_global_norm(0.5) -> Prodigy with the
warm-up + linear-decay schedule, behind MultiSteps(grad_accum)
(`prodigy.GradientPipeline`). Metrics go to metrics.jsonl, fetched from
the device every `metrics_flush_every` steps; checkpoints are native .npz
snapshots of the trainable parameters in the JAX package's layout.

Not in this slice (NotImplementedError): recon iterations (activation
capture, fg/bg regularizers, conv-attention, the background branch),
compositional iterations, EMA, `distribute`, full-state resume, the AdamW
optimizer and a real ArcFace face embedder (`synthetic_faces=True` is
required).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch
from torch import nn

from adaprompt_tpu_torch.adaface import checkpoint as ckpt_mod
from adaprompt_tpu_torch.adaface import conditioner as cond_mod
from adaprompt_tpu_torch.adaface.subj_basis_generator import SUBJ_CONFIG, SubjBasisGenerator
from adaprompt_tpu_torch.models.clip_text import CLIPTextModel
from adaprompt_tpu_torch.models.unet import UNet
from adaprompt_tpu_torch.models.vae import SD_SCALE_FACTOR, VAE, _resize_mask_nearest
from adaprompt_tpu_torch.ops.layers import randomize_zero_init, reset_parameters
from adaprompt_tpu_torch.train import steps as steps_mod
from adaprompt_tpu_torch.train.lr_schedules import prodigy_lr_schedule
from adaprompt_tpu_torch.train.prodigy import GradientPipeline, Prodigy


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
    composition_regs_iter_gap: int = 0
    arc2face_distill_iter_prob: float = 1.0
    # ND candidates (1, 3, 5, 7) cut at max_num_denoising_steps, with probs
    # (0.4, 0.3, 0.2, 0.1) renormalized
    max_num_denoising_steps: int = 5
    num_denoising_steps_probs: tuple = (0.4, 0.3, 0.2, 0.1)
    skip_weights: tuple = (1.0, 2.0, 2.0)
    randomize_clip_skip: bool = True
    allow_self_teacher: bool = False
    use_ema: bool = False
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


def build_optimizer(cfg: TrainerConfig, params: list) -> GradientPipeline:
    """clip_by_global_norm(grad_clip) -> Prodigy, behind MultiSteps(grad_accum)."""
    if cfg.optimizer_type != "Prodigy":
        raise NotImplementedError(f"optimizer {cfg.optimizer_type!r} is not ported yet")
    inner = Prodigy(params, lr=prodigy_lr_schedule(cfg.max_steps, cfg.warm_up_steps,
                                                   cfg.scheduler_cycles),
                    betas=cfg.prodigy_betas, d_coef=cfg.d_coef, use_bias_correction=True,
                    safeguard_warmup=cfg.scheduler_cycles > 1)
    return GradientPipeline(inner, cfg.grad_clip, max(cfg.grad_accum, 1))


def synthetic_raw_batches(seed: int, batch_size: int = 4, size: int = 512):
    """Raw batches with the dataset's keys, from a seed: random images, a box
    foreground mask, an augmentation mask that pads ~29% of the width, and a
    caption with the subject placeholder."""
    rng = np.random.default_rng(seed)
    while True:
        img = rng.integers(0, 256, (batch_size, size, size, 3), dtype=np.uint8)
        fg = np.zeros((batch_size, size, size), np.uint8)
        fg[:, size // 4:3 * size // 4, 5 * size // 16:11 * size // 16] = 1
        aug = np.ones((batch_size, size, size), np.uint8)
        aug[:, :, :150 * size // 512] = 0
        yield {"image": img.astype(np.float32) / 127.5 - 1.0, "image_unnorm": img,
               "fg_mask": fg, "aug_mask": aug, "caption": ["a photo of a z person"] * batch_size}


class AdaPromptTrainer:
    """Host loop of distillation iterations: batch prep, the step, logging."""

    @classmethod
    def random_init(cls, seed: int, batch_iterator, cfg: TrainerConfig, *, device=None,
                    tokenizer=None) -> "AdaPromptTrainer":
        """A full-width Stage-1 trainer with random weights from `seed`, made
        on the device (no checkpoint assets): student and a separate teacher
        SD-1.5 UNet and the VAE in the compute dtype, every zero-init layer
        randomized; the SD and Arc2Face CLIP-L encoders and the
        SubjBasisGenerator in float32; synthetic face ids."""
        from adaprompt_tpu_torch.pipeline import resolve_device
        from adaprompt_tpu_torch.utils.tokenizer import CLIPTokenizer
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        dt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        unet, teacher = (randomize_zero_init(reset_parameters(UNet(device=device, dtype=dt), gen),
                                             gen) for _ in range(2))
        text, a2f_text = (reset_parameters(CLIPTextModel(device=device), gen) for _ in range(2))
        vae = reset_parameters(VAE(device=device, dtype=dt), gen)
        sbg = reset_parameters(SubjBasisGenerator(SUBJ_CONFIG, device=device), gen)
        frozen = steps_mod.FrozenSD(unet=unet, text=text, arc2face_text=a2f_text,
                                    teacher_unet=teacher)
        return cls(frozen, vae, tokenizer or CLIPTokenizer.fallback(), SUBJ_CONFIG, sbg,
                   batch_iterator, cfg, synthetic_faces=True)

    def __init__(self, frozen: steps_mod.FrozenSD, vae, tokenizer, subj_basis_cfg, sbg,
                 batch_iterator, cfg: TrainerConfig, synthetic_faces: bool = False):
        if cfg.composition_regs_iter_gap > 0:
            raise NotImplementedError("compositional iterations are not ported yet")
        if cfg.use_ema:
            raise NotImplementedError("EMA of the trainable parameters is not ported yet")
        if not synthetic_faces:
            raise ValueError("the ArcFace face embedder is not ported yet: training would "
                             "distill against random identities; opt in with "
                             "synthetic_faces=True")
        self.frozen, self.vae, self.tokenizer = frozen, vae, tokenizer
        self.subj_basis_cfg, self.cfg = subj_basis_cfg, cfg
        self.batch_iterator = batch_iterator
        self.device = frozen.unet.out["conv"].weight.device
        self.dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        self.rng = np.random.default_rng(cfg.seed)
        self.gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self._global_step = 0
        self.subject_spec = cond_mod.make_placeholders(
            tokenizer, ("z",), ("y",), num_vectors_subj=subj_basis_cfg.num_out_embs_per_layer,
            num_vectors_bg=4)[0]
        params = {"subj_basis": sbg,
                  # learnable per-placeholder global scale scores
                  "emb_scales": nn.Parameter(torch.zeros(2, device=self.device))}
        self.state = steps_mod.TrainState(
            params, build_optimizer(cfg, steps_mod.trainable_parameters(params)))
        self._distill_steps = {}
        self._fp = steps_mod.frozen_params(frozen)
        os.makedirs(cfg.out_dir, exist_ok=True)
        self._metrics_file = open(os.path.join(cfg.out_dir, "metrics.jsonl"), "a")
        self._pending_metrics = []

    def distribute(self, *args, **kwargs):
        raise NotImplementedError("multi-card training is not ported yet")

    # -- batch prep ---------------------------------------------------------

    def _skip_weights(self) -> np.ndarray:
        base = np.asarray(self.cfg.skip_weights, np.float64)
        w = self.rng.dirichlet(base) if self.cfg.randomize_clip_skip else base / base.sum()
        return w.astype(np.float32)

    def _sample_num_denoising_steps(self) -> int:
        cand = [s for s in (1, 3, 5, 7) if s <= self.cfg.max_num_denoising_steps]
        p = np.asarray(self.cfg.num_denoising_steps_probs[:len(cand)], np.float64)
        return int(self.rng.choice(cand, p=p / p.sum()))

    def _latent_mask(self, mask_np) -> torch.Tensor:
        m = torch.as_tensor(np.asarray(mask_np, np.float32), device=self.device)[..., None]
        f = 2 ** (self.vae.cfg.num_resolutions - 1)
        return _resize_mask_nearest(m, (m.shape[1] // f, m.shape[2] // f))

    @torch.no_grad()
    def prepare_recon_batch(self, raw: dict) -> dict:
        """Latents, synthetic face ids and latent-size masks of a raw batch.
        The embedding-noise coin and the global-scale perturbation of the
        JAX package's batch are drawn and dropped: distillation uses neither
        (the coin's probability is 0 there), and the draws keep the host
        stream in the JAX package's order."""
        imgs = torch.as_tensor(np.asarray(raw["image"]), device=self.device).to(self.dtype)
        z0 = (self.vae.encode(imgs)[0] * SD_SCALE_FACTOR).float()
        faceid = self.rng.standard_normal((z0.shape[0], 512)).astype(np.float32)
        faceid = faceid / np.linalg.norm(faceid, axis=-1, keepdims=True)
        batch = {"z0": z0, "faceid": torch.as_tensor(faceid, device=self.device),
                 "fg_mask": self._latent_mask(raw["fg_mask"]),
                 "aug_mask": self._latent_mask(raw["aug_mask"]),
                 "skip_weights": torch.as_tensor(self._skip_weights(), device=self.device)}
        self.rng.random()                                # embedding-noise coin
        self.rng.uniform(0.8, 1.4, size=(2,))            # global-scale perturbation
        return batch

    # -- the state machine --------------------------------------------------------

    def _distill_step(self, nd: int) -> steps_mod.DistillStep:
        if nd not in self._distill_steps:
            self._distill_steps[nd] = steps_mod.make_arc2face_distill_step(
                self.frozen, self.tokenizer, self.subj_basis_cfg, num_denoising_steps=nd,
                compute_dtype=self.dtype, skip_weights=self.cfg.skip_weights,
                allow_self_teacher=self.cfg.allow_self_teacher)
        return self._distill_steps[nd]

    def train_step(self, step_idx: int) -> dict:
        self._global_step = step_idx
        raw = next(self.batch_iterator)
        do_distill = self.rng.random() < self.cfg.arc2face_distill_iter_prob
        if not do_distill:
            raise NotImplementedError("recon iterations are not ported yet")
        batch = self.prepare_recon_batch(raw)
        nd = self._sample_num_denoising_steps()
        if nd > 1:
            # HALF_BS: multi-step distillation keeps the first ceil(B / ND) rows
            b = batch["z0"].shape[0]
            half_bs = -(-b // nd)
            if half_bs < b:
                batch = {k: (v[:half_bs] if isinstance(v, torch.Tensor) and v.ndim >= 1
                             and v.shape[0] == b else v) for k, v in batch.items()}
        self.state, metrics = self._distill_step(nd)(self.state, self._fp, batch, self.gen)
        metrics.update(iter_type="arc2face_distill", num_denoising_steps=nd,
                       distill_bs=int(batch["z0"].shape[0]))
        return self._emit_metrics(step_idx, metrics, self._host_stats())

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
        self._flush_metrics()
        path = os.path.join(self.cfg.out_dir, f"embeddings_gs-{step}.npz")
        params = self.state.params
        trees = {"subj_basis": ckpt_mod.module_tree(params["subj_basis"]),
                 "emb_scales": {"scores": params["emb_scales"].detach().float().cpu().numpy()}}
        ckpt_mod.save_checkpoint(path, trees,
                                 meta={"step": step, "placeholder": self.subject_spec.string})
        return path

    def load_checkpoint(self, path: str) -> dict:
        """Load the trainable parameters; the optimizer starts afresh, as in
        the JAX package."""
        trees, meta = ckpt_mod.load_checkpoint(path)
        params = self.state.params
        ckpt_mod.load_module_tree(params["subj_basis"], trees["subj_basis"])
        if "emb_scales" in trees:
            with torch.no_grad():
                params["emb_scales"].copy_(torch.as_tensor(trees["emb_scales"]["scores"]))
        self.state = steps_mod.TrainState(
            params, build_optimizer(self.cfg, steps_mod.trainable_parameters(params)))
        return meta

    def save_full_state(self, step: int):
        raise NotImplementedError("full-state resume is not ported yet")

    def load_full_state(self, path: str):
        raise NotImplementedError("full-state resume is not ported yet")
