"""The behavioural gate of the port's trainer, on the card: it learns.

Port of tests/test_convergence.py's three gates at their tiny configs and
their bounds, in bf16 (the card's training dtype; the UNets and the VAE in
bf16, the text encoders and the trainables in fp32). Each overfits a fixed
finite set of denoising tasks through the port's own steps:

  * the zero-shot recon step (steps.ReconStep) over the SubjBasisGenerator,
    350 steps cycling 2 fixed (t, noise) draws: the last window's mean loss
    below 0.8x the first's, Prodigy's D above 50x its start and at most 5x
    its value at the midpoint;
  * the static textual-inversion step (steps.StaticReconStep) over a
    StaticLayerwiseEmbedding, the same;
  * the full AdaPromptTrainer loop (recon iterations, grad_accum 2, fresh t
    and noise every step) over 150 steps on two fixed 64x64 images with a
    box mask: the last 20 steps' mean loss below 0.85x the first 20's.

The JAX test's third gate reads its images through the dataset module
(random scale and shift augmentation, captions from templates); the port
has no dataset module yet, so its iterator repeats the two images unaugmented
under one caption. Each gate prints its losses, D and the kernels launched.

Needs CUDA; the card's machine has no jax, so run it there without the
conftest: python -m pytest tests/test_torch_convergence.py -m cuda
--noconftest -q -s."""

import numpy as np
import pytest
import torch

from adaprompt_tpu_torch.adaface import conditioner as tcond, static_embedder as tse
from adaprompt_tpu_torch.adaface import subj_basis_generator as tsbg
from adaprompt_tpu_torch.models import clip_text as tclip, unet as tunet, vae as tvae
from adaprompt_tpu_torch.ops import kernel_wrappers
from adaprompt_tpu_torch.ops.layers import reset_parameters
from adaprompt_tpu_torch.train import steps as tsteps, trainer as ttrainer
from adaprompt_tpu_torch.utils.tokenizer import CLIPTokenizer

pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")]

HIDDEN = 576
LAT = 8            # latent side, as the JAX gates
DEV, DT = "cuda", torch.bfloat16


def _tiny_frozen(tok, seed=0):
    """The JAX gates' tiny frozen models on the card: the UNet in bf16 with
    every all-zero weight of rank >= 2 (the zero_module convs and
    projections) re-drawn at 0.3 x N(0, 1), so that the context reaches the
    output; two 2-layer CLIP text encoders in fp32."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    tcfg = tclip.CLIPTextConfig(vocab_size=49408, hidden_size=HIDDEN, intermediate_size=2 * HIDDEN,
                                num_layers=2, num_heads=8, eos_token_id=tok.eos_id)
    ucfg = tunet.UNetConfig(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                            attention_ds=(1, 2), num_heads=4, context_dim=HIDDEN)
    unet = reset_parameters(tunet.UNet(ucfg, device=DEV, dtype=DT), gen)
    with torch.no_grad():
        for p in unet.parameters():
            if p.ndim >= 2 and not p.any():
                p.copy_(0.3 * torch.randn(p.shape, generator=gen, device=DEV))
    text, a2f = (reset_parameters(tclip.CLIPTextModel(tcfg, device=DEV), gen) for _ in range(2))
    return tsteps.FrozenSD(unet.requires_grad_(False), text.requires_grad_(False),
                           a2f.requires_grad_(False), None), tcfg


def _zs_batch(tok, spec, b=2):
    rng = np.random.default_rng(0)
    ids = np.asarray(tok(["a photo of a z person"] * b, max_length=77))
    bi, pos = tcond.find_placeholder_indices(ids, spec)
    faceid = rng.standard_normal((b, 512)).astype(np.float32)
    faceid /= np.linalg.norm(faceid, axis=-1, keepdims=True)
    dev = lambda a: torch.as_tensor(a, device=DEV)
    return {"z0": dev(rng.standard_normal((b, LAT, LAT, 4)).astype(np.float32)),
            "faceid": dev(faceid), "caption_ids": dev(ids).long(), "subj_bi": dev(bi).long(),
            "subj_pos": dev(pos).long(),
            "fg_mask": dev((rng.random((b, LAT, LAT, 1)) > 0.4).astype(np.float32)),
            "aug_mask": None, "skip_weights": dev(np.asarray([0.5, 0.5], np.float32))}


def _launches():
    return {n: w.launches for n, w in kernel_wrappers().items() if w.launches}


def _run_overfit(step, state, fp, batch, n_steps, n_tasks=2):
    """Cycle n_tasks fixed draws: a deterministic finite objective."""
    gen = torch.Generator(device=DEV).manual_seed(7)
    tasks = [step.draw(gen, batch["z0"]) for _ in range(n_tasks)]
    losses, ds = [], []
    for i in range(n_steps):
        state, metrics = step(state, fp, batch, None, draws=tasks[i % n_tasks])
        losses.append(metrics["loss_recon"])
        ds.append(state.optimizer.inner.d)
    return (torch.stack(losses).float().cpu().numpy(),
            torch.stack(ds).float().cpu().numpy(), state)


def _assert_learned(name, losses, ds, drop=0.8):
    """The JAX gates' bounds: the last window's mean below `drop` x the
    first's (window max(n // 10, 8)); D above 50x its start and at most 5x
    its midpoint value at the end."""
    n = len(losses)
    w = max(n // 10, 8)
    first, last = losses[:w].mean(), losses[-w:].mean()
    print(f"convergence {name}: {n} steps, loss first-window {first:.6f} last-window "
          f"{last:.6f} ratio {last / first:.4f} (bound {drop}); D start {ds[0]:.4e} mid "
          f"{ds[n // 2]:.4e} end {ds[-1]:.4e} (end/start {ds[-1] / ds[0]:.1f}, end/mid "
          f"{ds[-1] / ds[n // 2]:.3f}); launches {_launches()}")
    assert np.isfinite(losses).all(), "loss went non-finite"
    assert last < drop * first, f"no material loss decrease: {first:.4f} -> {last:.4f}"
    assert ds[-1] > ds[0] * 50, f"Prodigy D never took off: {ds[0]:.2e} -> {ds[-1]:.2e}"
    assert ds[-1] <= ds[n // 2] * 5, f"D still growing fast: {ds[n // 2]:.2e} -> {ds[-1]:.2e}"


def _zero_launches():
    for w in kernel_wrappers().values():
        w.launches = 0


def _cfg(**kw):
    return ttrainer.TrainerConfig(max_steps=400, grad_accum=1, warm_up_steps=20,
                                  compute_dtype="bfloat16", **kw)


def test_zs_recon_overfit():
    tok = CLIPTokenizer.fallback()
    frozen, tcfg = _tiny_frozen(tok)
    spec = tcond.make_placeholders(tok, ("z",), (), num_vectors_subj=16)[0]
    scfg = tsbg.SubjBasisConfig(placeholder_is_bg=False, output_dim=HIDDEN, text_cfg=tcfg)
    sbg = reset_parameters(tsbg.SubjBasisGenerator(scfg, device=DEV),
                           torch.Generator(device=DEV).manual_seed(5)).train()
    params = {"subj_basis": sbg}
    state = tsteps.TrainState(params, ttrainer.build_optimizer(
        _cfg(), tsteps.trainable_parameters(params)))
    step = tsteps.make_zs_recon_step(frozen, tok, scfg, fgbg_reg=False, compute_dtype=DT)
    _zero_launches()
    losses, ds, _ = _run_overfit(step, state, tsteps.frozen_params(frozen), _zs_batch(tok, spec),
                                 350)
    _assert_learned("zs_recon", losses, ds)


def test_static_embedder_overfit():
    tok = CLIPTokenizer.fallback()
    frozen, _ = _tiny_frozen(tok)
    spec = tcond.make_placeholders(tok, ("z",), (), num_vectors_subj=9)[0]
    scfg = tse.StaticEmbedderConfig(num_vectors=9, out_emb_dim=HIDDEN, num_layers=16)
    params = {"static_emb": tse.StaticLayerwiseEmbedding(
        scfg, torch.Generator(device=DEV).manual_seed(5), device=DEV)}
    state = tsteps.TrainState(params, ttrainer.build_optimizer(
        _cfg(), tsteps.trainable_parameters(params)))
    step = ttrainer.make_static_recon_step(frozen, scfg, compute_dtype=DT)
    batch = _zs_batch(tok, spec)
    batch.pop("faceid")
    _zero_launches()
    losses, ds, _ = _run_overfit(step, state, tsteps.frozen_params(frozen), batch, 350)
    _assert_learned("static", losses, ds)


def _two_images(size, caption):
    """Raw batches of the same two seeded images (both in every batch) with a
    box foreground mask 8 pixels inside the border and no augmentation."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (2, size, size, 3), dtype=np.uint8)
    fg = np.zeros((2, size, size), np.uint8)
    fg[:, 8:size - 8, 8:size - 8] = 1
    raw = {"image": img.astype(np.float32) / 127.5 - 1.0, "image_unnorm": img, "fg_mask": fg,
           "aug_mask": np.ones((2, size, size), np.uint8), "caption": [caption] * 2}
    while True:
        yield raw


def trainer_loop_losses(out_dir, seed=0, steps=150):
    """The full AdaPromptTrainer loop of the third gate over `steps` recon
    steps (the tiny models drawn from `seed`; 0 is the gate's): the
    losses and Prodigy's D at the end."""
    tok = CLIPTokenizer.fallback()
    frozen, tcfg = _tiny_frozen(tok, seed)
    vae = reset_parameters(tvae.VAE(tvae.VAEConfig(ch=32, ch_mult=(1, 2, 4), num_res_blocks=1),
                                    device=DEV, dtype=DT),
                           torch.Generator(device=DEV).manual_seed(9 + seed)).requires_grad_(False)
    scfg = tsbg.SubjBasisConfig(placeholder_is_bg=False, output_dim=HIDDEN, text_cfg=tcfg)
    sbg = reset_parameters(tsbg.SubjBasisGenerator(scfg, device=DEV),
                           torch.Generator(device=DEV).manual_seed(5 + seed)).train()
    cfg = ttrainer.TrainerConfig(
        max_steps=200, grad_accum=2, warm_up_steps=10, arc2face_distill_iter_prob=0.0,
        fgbg_reg=False, ckpt_every=10 ** 9, metrics_flush_every=1, out_dir=str(out_dir),
        compute_dtype="bfloat16" if DT == torch.bfloat16 else "float32", seed=0)
    tr = ttrainer.AdaPromptTrainer(frozen, vae, tok, scfg, sbg,
                                   _two_images(LAT * 8, "a photo of a z person"), cfg,
                                   synthetic_faces=True)
    losses = np.asarray([tr.train_step(i)["loss_recon"] for i in range(steps)])
    return losses, float(tr.state.optimizer.inner.d)


def test_trainer_loop_converges(tmp_path):
    _zero_launches()
    losses, d = trainer_loop_losses(tmp_path)
    first, last = losses[:20].mean(), losses[-20:].mean()
    print(f"convergence trainer_loop: 150 steps, loss first-20 {first:.6f} last-20 {last:.6f} "
          f"ratio {last / first:.4f} (bound 0.85); D end {d:.4e}; launches {_launches()}")
    assert np.isfinite(losses).all()
    assert last < 0.85 * first, f"trainer loop did not optimize: {first:.4f} -> {last:.4f}"
    assert d > 0
