"""The port's flash-variant slice as a whole vs the JAX package (tiny
configs, CPU, float32): the tiny UNet, the tiny `_generate` and one tiny
Stage-1 distillation step under `UNetConfig.flash_variant`, against the JAX
package with the matching module switch patched and its models reaching the
Pallas flash kernels in interpret mode (`jax_flash` of
tests/test_torch_flash_variants.py); and the entry points carrying the
variant down to every self-attention call."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaprompt_tpu import pipeline as jpipe
from adaprompt_tpu.models import unet as junet
from adaprompt_tpu.train import steps as jsteps
from adaprompt_tpu_torch import pipeline as tpipe
from adaprompt_tpu_torch.adaface import subj_basis_generator as tsbg
from adaprompt_tpu_torch.models.unet import UNetConfig
from adaprompt_tpu_torch.ops import attention as tattn
from adaprompt_tpu_torch.ops.attention import FlashVariant
from adaprompt_tpu_torch.train import steps as tsteps
from test_torch_flash_variants import VARIANTS, jax_flash
from torch_port_helpers import (JAX_UNET, JAX_VAE, TORCH_UNET, assert_close, keeping_grads,
                                port_module, t, tiny_models, train_env)

MIN_TOKENS = 16      # the tiny UNet's 64- and 16-token levels take the flash path


@pytest.fixture(scope="module")
def models():
    return tiny_models(2)


@pytest.fixture
def port_flash_rule(monkeypatch):
    monkeypatch.setattr(tattn, "_FLASH_MIN_Q", MIN_TOKENS)
    monkeypatch.setattr(tattn, "_FLASH_MIN_K", MIN_TOKENS)


def _count_flash(monkeypatch):
    """Record the variant of every self-attention flash call the port makes
    (under the lowered rule the tiny cross-attention takes the flash path
    too, always in its default form)."""
    seen = []
    real = tattn.flash_attention

    def recording(q, k, *rest):
        if q.shape[1] == k.shape[1]:
            seen.append(rest[3])
        else:
            assert rest[3] == FlashVariant()
        return real(q, k, *rest)

    monkeypatch.setattr(tattn, "flash_attention", recording)
    return seen


@pytest.mark.parametrize("name", ["ilv", "nomax", "exp2"])
def test_unet_under_variant_matches_jax(models, port_flash_rule, monkeypatch, name):
    """The tiny UNet (masked, layerwise context) with flash_variant set,
    against the JAX UNet reaching the Pallas flash kernel under the matching
    switch: eps to 1e-4. Self-attention at 64 and 16 tokens takes the flash
    path with the variant; cross-attention never does."""
    (ju, _, _), (tu, _, _) = models
    variant = VARIANTS[name]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = (rng.standard_normal((16, 2, 77, 64)) * 0.5).astype(np.float32)
    mask = (rng.random((2, 8, 8, 1)) > 0.3).astype(np.float32)
    ts = np.array([981, 401])
    with jax_flash(variant, MIN_TOKENS):
        eps_j = junet.forward(ju, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
                              img_mask=jnp.asarray(mask), cfg=JAX_UNET)
    seen = _count_flash(monkeypatch)
    cfg = dataclasses.replace(TORCH_UNET, flash_variant=variant)
    with torch.no_grad():
        eps_t = tu(t(x), torch.from_numpy(ts), t(ctx), img_mask=t(mask), cfg=cfg)
        eps_default = tu(t(x), torch.from_numpy(ts), t(ctx), img_mask=t(mask))
    assert_close(eps_t, eps_j, atol=1e-4, rtol=1e-4)
    n = len(seen) // 2                 # the variant's forward, then the default's
    assert n >= 6 and seen == [variant] * n + [FlashVariant()] * n
    assert_close(eps_t, eps_default, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["ilv", "nomax", "exp2"])
def test_generate_under_variant_matches_jax(models, port_flash_rule, name):
    """The tiny `_generate` (DDIM, 3 steps, CFG) with
    `UNetConfig(flash_variant=...)` against the JAX pipeline's under the
    matching switch: latents to 1e-4, as tests/test_torch_pipeline.py."""
    (ju, jv, _), (tu, tv, _) = models
    rng = np.random.default_rng(6)
    cond, uncond = ((rng.standard_normal((1, 2, 77, 64)) * 0.5).astype(np.float32)
                    for _ in range(2))
    x_T = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    with jax_flash(VARIANTS[name], MIN_TOKENS):
        z_j = jpipe._generate_jit(ju, jv, jnp.asarray(cond), jnp.asarray(uncond),
                                  jnp.asarray(x_T), 3, (4.0, 1.0), True, JAX_UNET, JAX_VAE,
                                  jpipe.SD15_SCHEDULE, jnp.float32)
    cfg = dataclasses.replace(TORCH_UNET, flash_variant=VARIANTS[name])
    z_t = tpipe._generate(tu, tv, t(cond), t(uncond), t(x_T), 3, (4.0, 1.0), True,
                          tpipe.SD15_SCHEDULE, torch.float32, "ddim", cfg)
    assert_close(z_t, z_j, atol=1e-4, rtol=1e-5)


def test_pipeline_and_trainer_carry_the_variant(port_flash_rule, monkeypatch, tmp_path):
    """`UNetConfig(flash_variant=...)` given to the entry points reaches
    every self-attention call of generate and of a training step."""
    from adaprompt_tpu_torch.train import trainer as ttrainer
    from adaprompt_tpu_torch.train.trainer import (AdaPromptTrainer, TrainerConfig,
                                                   synthetic_raw_batches)
    from torch_port_helpers import TORCH_TEXT, TORCH_VAE
    variant = FlashVariant(nomax=True, exp2=True)
    cfg = dataclasses.replace(TORCH_UNET, flash_variant=variant)
    seen = _count_flash(monkeypatch)
    pipe = tpipe.StableDiffusionPipeline.random_init(0, device="cpu", dtype=torch.float32,
                                                     unet_cfg=cfg, vae_cfg=TORCH_VAE,
                                                     text_cfg=TORCH_TEXT)
    pipe.generate(["a photo"], num_steps=2, height=64, width=64)
    assert len(seen) >= 2 * 6 and set(seen) == {variant}
    # the trainer's random_init builds both UNets with the config (the other,
    # full-width models are stood in for: only the UNets matter here)
    for heavy in ("CLIPTextModel", "VAE", "SubjBasisGenerator"):
        monkeypatch.setattr(ttrainer, heavy, lambda *a, **kw: torch.nn.Identity())
    monkeypatch.setattr(AdaPromptTrainer, "__init__",
                        lambda self, frozen, *a, **kw: setattr(self, "frozen", frozen))
    tr = AdaPromptTrainer.random_init(0, synthetic_raw_batches(0), TrainerConfig(
        seed=0, out_dir=str(tmp_path)), device="cpu", unet_cfg=cfg)
    assert tr.frozen.unet.cfg.flash_variant == variant
    assert tr.frozen.teacher_unet.cfg.flash_variant == variant
    assert UNetConfig().flash_variant == FlashVariant()


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return train_env(tmp_path_factory.mktemp("vocab"))


def test_distill_step_under_exp2_matches_jax(env, port_flash_rule, monkeypatch):
    """One tiny Stage-1 distillation step (ND 1) with the student and
    teacher UNets under FlashVariant(exp2=True), against the JAX step with
    `_EXP2` set and its UNets reaching the Pallas flash forward and backward:
    the loss to 1e-5 relative and every SubjBasisGenerator gradient to 1e-4
    of the leaf's largest (plus 1e-6 of the tree's)."""
    from test_torch_train import _batch, _jax_draws
    from adaprompt_tpu.train import trainer as jtrainer
    from adaprompt_tpu_torch.train import trainer as ttrainer
    from torch_port_helpers import named
    batch_np, key = _batch(1), jax.random.PRNGKey(11)
    trainable = {"subj_basis": env["jsp"], "emb_scales": jnp.zeros((2,), jnp.float32)}
    jopt = keeping_grads(jtrainer.build_optimizer(
        jtrainer.TrainerConfig(grad_accum=1, max_steps=10, warm_up_steps=2)))
    with jax_flash(FlashVariant(exp2=True), MIN_TOKENS):
        step_j = jax.jit(jsteps.make_arc2face_distill_step(
            jopt, env["jfrozen"], env["jtok"], env["jscfg"], num_denoising_steps=1,
            compute_dtype=jnp.float32, skip_weights=(1.0, 2.0, 2.0)))
        jstate, metrics = step_j(jsteps.create_train_state(trainable, jopt),
                                 jsteps.frozen_params(env["jfrozen"]),
                                 {k: jnp.asarray(v) for k, v in batch_np.items()}, key)
    jgrads = named(jstate.opt_state[1]["subj_basis"])

    frozen = env["tfrozen"]
    exp2_cfg = dataclasses.replace(frozen.unet.cfg, flash_variant=FlashVariant(exp2=True))
    for u in {id(frozen.unet): frozen.unet, id(frozen.teacher_unet): frozen.teacher_unet}.values():
        monkeypatch.setattr(u, "cfg", exp2_cfg)
    seen = _count_flash(monkeypatch)
    sbg = port_module(tsbg.SubjBasisGenerator(env["tscfg"]), env["jsp"]).train()
    params = {"subj_basis": sbg, "emb_scales": torch.nn.Parameter(torch.zeros(2))}
    tstate = tsteps.TrainState(params, ttrainer.build_optimizer(
        ttrainer.TrainerConfig(grad_accum=1, max_steps=10, warm_up_steps=2),
        tsteps.trainable_parameters(params)))
    grads = {}
    for n, p in sbg.named_parameters():
        p.register_hook(lambda g, n=n: grads.__setitem__(n, g.clone()))
    step = tsteps.make_arc2face_distill_step(frozen, env["ttok"], env["tscfg"],
                                             num_denoising_steps=1, compute_dtype=torch.float32,
                                             skip_weights=(1.0, 2.0, 2.0))
    _, tm = step(tstate, tsteps.frozen_params(frozen), {k: t(v) for k, v in batch_np.items()},
                 None, draws=_jax_draws(key, batch_np["z0"].shape, 1))
    assert seen and set(seen) == {FlashVariant(exp2=True)}
    loss_j = float(metrics["loss_arc2face_distill"])
    np.testing.assert_allclose(float(tm["loss_arc2face_distill"]), loss_j, rtol=1e-5)
    g_max = max(np.abs(np.asarray(g)).max() for g in jgrads.values())
    for name, p in sbg.named_parameters():
        g_j = np.asarray(jgrads[name])
        g_t = grads.get(name, torch.zeros_like(p)).numpy()
        assert np.abs(g_t - g_j).max() <= 1e-4 * np.abs(g_j).max() + 1e-6 * g_max, name
