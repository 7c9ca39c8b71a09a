"""The port's txt2img slice as a whole vs the JAX pipeline, on shared weights
(tiny configs, 64x64, float32, CPU): the prompt encoding, then both
`_generate` functions from the same x_T (DDIM and DPM-Solver++), and both
`_generate_fast` functions under DDIM."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from adaprompt_tpu import pipeline as jpipe
from adaprompt_tpu_torch import pipeline as tpipe
from adaprompt_tpu_torch.utils.tokenizer import CLIPTokenizer
from torch_port_helpers import (JAX_TEXT, JAX_UNET, JAX_VAE, TORCH_TEXT, TORCH_UNET, TORCH_VAE,
                                assert_close, t, tiny_models)
from torch_port_helpers import torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def pipes():
    (ju, jv, jt), (tu, tv, tt) = tiny_models(1)
    jp = jpipe.StableDiffusionPipeline(jpipe.SDParams(unet=ju, vae=jv, text=jt),
                                       unet_cfg=JAX_UNET, vae_cfg=JAX_VAE, text_cfg=JAX_TEXT,
                                       compute_dtype=jnp.float32)
    tp = tpipe.StableDiffusionPipeline(tu, tv, tt, CLIPTokenizer.fallback())
    return jp, tp


def test_encode_prompt_matches(pipes):
    jp, tp = pipes
    prompts = ["a photo of a cat", jpipe.DEFAULT_NEGATIVE_PROMPT]
    np.testing.assert_array_equal(tp.tokenize(prompts), jp.tokenize(prompts))
    assert_close(tp.encode_prompt(prompts), jp.encode_prompt(prompts), atol=2e-5)


@pytest.mark.parametrize("layerwise", [False, True])
def test_generate_matches_jax(pipes, layerwise):
    """Latents agree to ~1e-4 (the first DDIM step divides by
    sqrt(alpha_981) ~ 0.068, which scales the UNet's fp32 differences) and
    the uint8 images to within one level."""
    jp, tp = pipes
    cond = np.asarray(jp.encode_prompt(["a photo of a cat", "a red car"]))[None]
    uncond = np.asarray(jp.encode_prompt([jpipe.DEFAULT_NEGATIVE_PROMPT] * 2))[None]
    if layerwise:
        rng = np.random.default_rng(9)
        cond = cond + 0.1 * rng.standard_normal((16,) + cond.shape[1:]).astype(np.float32)
        uncond = np.broadcast_to(uncond, cond.shape)
    x_T = np.random.default_rng(0).standard_normal((2, 8, 8, 4)).astype(np.float32)
    args_j = (jnp.asarray(cond), jnp.asarray(uncond), jnp.asarray(x_T), 3, (4.0, 1.0))
    args_t = (t(cond), t(uncond), t(x_T), 3, (4.0, 1.0))
    z_j = jpipe._generate_jit(jp.params.unet, jp.params.vae, *args_j, True, JAX_UNET, JAX_VAE,
                              jp.sched, jnp.float32)
    z_t = tpipe._generate(tp.unet, tp.vae, *args_t, True, tp.sched, torch.float32)
    assert_close(z_t, z_j, atol=1e-4, rtol=1e-5)
    img_j = np.asarray(jpipe._generate_jit(jp.params.unet, jp.params.vae, *args_j, False,
                                           JAX_UNET, JAX_VAE, jp.sched, jnp.float32))
    img_t = tpipe._generate(tp.unet, tp.vae, *args_t, False, tp.sched, torch.float32).numpy()
    assert img_t.dtype == np.uint8 and img_t.shape == (2, 64, 64, 3)
    assert img_t.std() > 0
    assert np.abs(img_t.astype(np.int32) - img_j.astype(np.int32)).max() <= 1


def test_generate_deterministic_per_seed(pipes):
    _, tp = pipes
    a = tp.generate(["x"], num_steps=2, height=64, width=64, seed=3)
    b = tp.generate(["x"], num_steps=2, height=64, width=64, seed=3)
    c = tp.generate(["x"], num_steps=2, height=64, width=64, seed=4)
    assert a.shape == (1, 64, 64, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()


def test_generate_options(pipes):
    _, tp = pipes
    z = tp.generate(["x"], num_steps=2, height=64, width=64, return_latents=True,
                    negative_prompt="blurry", guidance_scale=3.0)
    assert z.shape == (1, 8, 8, 4) and z.dtype == np.float32 and np.isfinite(z).all()
    z = tp.generate(["x"], num_steps=4, height=64, width=64, return_latents=True,
                    sampler="dpmpp", fast=tpipe.FastConfig())
    assert z.shape == (1, 8, 8, 4) and np.isfinite(z).all()
    with pytest.raises(ValueError, match="unknown sampler"):
        tp.generate(["x"], num_steps=2, sampler="euler")


def test_generate_dpmpp_and_fast_ddim_match_jax(pipes):
    """`sampler="dpmpp"` without `fast` (`_generate`), and `fast` (DeepCache
    3/3, CFG tail 0.3; no ToMe, which needs a 4096-token level) under DDIM,
    against the JAX pipeline's jitted functions."""
    jp, tp = pipes
    ju, jv, tu, tv = jp.params.unet, jp.params.vae, tp.unet, tp.vae
    rng = np.random.default_rng(3)
    cond, uncond = ((rng.standard_normal((1, 1, 77, 64)) * 0.5).astype(np.float32)
                    for _ in range(2))
    x_T = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    args_j = (jnp.asarray(cond), jnp.asarray(uncond), jnp.asarray(x_T), 6, (4.0, 1.0), True)
    args_t = (t(cond), t(uncond), t(x_T), 6, (4.0, 1.0), True)
    z_j = jpipe._generate_jit(ju, jv, *args_j, JAX_UNET, None, jpipe.SD15_SCHEDULE, jnp.float32,
                              "dpmpp")
    z_t = tpipe._generate(tu, tv, *args_t, tpipe.SD15_SCHEDULE, torch.float32, "dpmpp")
    assert_close(z_t, z_j, atol=1e-4, rtol=1e-5)
    fast = jpipe.FastConfig(tome_ratio=0.0)
    z_j = jpipe._generate_fast_jit(ju, jv, *args_j, fast, JAX_UNET, None, jpipe.SD15_SCHEDULE,
                                   jnp.float32, "ddim")
    z_t = tpipe._generate_fast(tu, tv, *args_t, tpipe.FastConfig(tome_ratio=0.0), TORCH_UNET,
                               tpipe.SD15_SCHEDULE, torch.float32, "ddim")
    assert_close(z_t, z_j, atol=1e-4, rtol=1e-5)


def test_encode_decode_shapes(pipes):
    jp, tp = pipes
    imgs = np.random.default_rng(2).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    z_t = tp.encode_image(imgs)
    assert z_t.shape == (2, 8, 8, 4)
    assert_close(z_t, jp.encode_image(jnp.asarray(imgs)), atol=1e-4, rtol=1e-4)
    out_t = tp.decode_latents(z_t)
    out_j = jp.decode_latents(jnp.asarray(z_t.numpy()))
    assert out_t.shape == (2, 64, 64, 3) and out_t.dtype == np.uint8
    assert np.abs(out_t.astype(np.int32) - out_j.astype(np.int32)).max() <= 1
    z_s = tp.encode_image(imgs, generator=torch.Generator().manual_seed(0))
    assert z_s.shape == (2, 8, 8, 4) and not torch.equal(z_s, z_t)


def test_random_init_shapes_on_cpu():
    p = tpipe.StableDiffusionPipeline.random_init(0, device="cpu", dtype=torch.float32,
                                                  unet_cfg=TORCH_UNET, vae_cfg=TORCH_VAE,
                                                  text_cfg=TORCH_TEXT)
    assert p.device.type == "cpu" and p.compute_dtype == torch.float32
    img = p.generate(["a photo"], num_steps=2, height=64, width=64)
    assert img.shape == (1, 64, 64, 3) and img.std() > 0
