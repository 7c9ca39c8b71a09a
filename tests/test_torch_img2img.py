"""The port's img2img sampling against the JAX package (CPU, float32):
`ddim_sample` with eta, the inpainting mask, use_cfg and an explicit
timestep grid, `stochastic_encode`, `ddim_decode`, and the translate CLI.

Random draws: the JAX loop draws one normal a step from
`jax.random.split(noise_key, num_steps)` and uses it twice (the mask's
re-noising and the eta noise); the port draws one a step from a
torch.Generator, so the tests hand JAX's draws to the port (`noise=`).

The translate CLI runs in both packages over tests/test_torch_cli.py's tiny
models and files (`load_pipeline` monkeypatched, `--device cpu`). Both CLIs
resize every photo to 512x512; here both resize to 64x64 instead (the
port's `translate.IMAGE_SIZE` and PIL's `Image.resize` in the JAX CLI are
overridden), which keeps the tiny VAE and UNet inside the file's time
budget and changes no other step."""

import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from adaprompt_tpu import pipeline as jpipe
from adaprompt_tpu.adaface import wrapper as jwrap
from adaprompt_tpu.cli import translate as jtranslate
from adaprompt_tpu.models import unet as junet
from adaprompt_tpu.sampling import ddim as jddim
from adaprompt_tpu_torch import pipeline as tpipe
from adaprompt_tpu_torch.adaface import wrapper as twrap
from adaprompt_tpu_torch.cli import translate as ttranslate
from adaprompt_tpu_torch.sampling import ddim as tddim
from adaprompt_tpu_torch.utils.png import read_png, write_png
from test_torch_cli import CTX_TOL, _record, clis, env  # noqa: F401
from adaprompt_tpu_torch.adaface.checkpoint import module_tree
from adaprompt_tpu_torch.models import unet as tunet
from adaprompt_tpu_torch.ops.layers import reset_parameters
from torch_port_helpers import (JAX_UNET, TORCH_UNET, assert_close, port_module, randomized, t)
from torch_port_helpers import torch_threads  # noqa: F401

TOY_TOL = 1e-5          # atol = rtol on the toy eps model, as tests/test_torch_sampling.py
UNET_TOL = 1e-4         # latents through the tiny UNet (atol; rtol 1e-5), as test_torch_pipeline
Z_TOL = 2e-6            # translate's z_t: the tiny VAE's fp32 encode, then the noising
GRID = np.asarray([1, 101, 301, 501, 701, 981])      # explicit ascending timesteps
SHAPE = (2, 4, 4, 4)
W = np.asarray([0.5, 0.5, -0.8, -0.8], np.float32)[:, None, None, None]


def _toy(x_doubled: bool):
    """eps = tanh(w * x) + t/1000 in both frameworks, with a cond/uncond
    difference on the doubled batch (w's first half against its second)."""
    w = W if x_doubled else W[:2]
    model_j = lambda x, s: jnp.tanh(jnp.asarray(w) * x) + (s.astype(jnp.float32) / 1000.0)[
        :, None, None, None]
    model_t = lambda x, s: torch.tanh(torch.from_numpy(w) * x) + (s.float() / 1000.0)[
        :, None, None, None]
    return model_j, model_t


def jax_draws(seed: int, steps: int, shape) -> np.ndarray:
    """The per-step normals of JAX's ddim_sample under PRNGKey(seed)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), steps)
    return np.stack([np.asarray(jax.random.normal(k, shape, jnp.float32)) for k in keys])


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x_T = rng.standard_normal(SHAPE).astype(np.float32)
    x0 = rng.standard_normal(SHAPE).astype(np.float32)
    mask = np.zeros(SHAPE, np.float32)
    mask[:, :, :2] = 1.0                                 # the left half is known
    return x_T, x0, mask


@pytest.mark.parametrize("use_cfg", [True, False])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_sample_options_match_jax_on_toy_model(eta, with_mask, use_cfg):
    x_T, x0, mask = _inputs()
    model_j, model_t = _toy(use_cfg)
    kw = dict(guidance_scale=(4.0, 1.0), eta=eta, use_cfg=use_cfg, timesteps=GRID)
    mj = dict(mask=jnp.asarray(mask), x0=jnp.asarray(x0)) if with_mask else {}
    mt = dict(mask=t(mask), x0=t(x0)) if with_mask else {}
    z_j = jddim.ddim_sample(model_j, jnp.asarray(x_T), noise_key=jax.random.PRNGKey(7),
                            **kw, **mj)
    z_t = tddim.ddim_sample(model_t, t(x_T), noise=t(jax_draws(7, len(GRID), SHAPE)), **kw, **mt)
    assert_close(z_t, z_j, atol=TOY_TOL, rtol=TOY_TOL)
    if eta or with_mask:       # the draws matter: a different key moves JAX's result
        z_other = jddim.ddim_sample(model_j, jnp.asarray(x_T), noise_key=jax.random.PRNGKey(8),
                                    **kw, **mj)
        assert float(jnp.abs(z_other - z_j).max()) > 1e-3


def test_ddim_sample_draws_once_a_step_for_both_uses():
    """One generator draw a step serves the mask and the eta noise: the
    generator's run equals the run given the same generator's draws."""
    x_T, x0, mask = _inputs(1)
    _, model_t = _toy(True)
    kw = dict(num_steps=5, eta=0.5, mask=t(mask), x0=t(x0))
    z_gen = tddim.ddim_sample(model_t, t(x_T), generator=torch.Generator().manual_seed(3), **kw)
    g = torch.Generator().manual_seed(3)
    draws = torch.stack([torch.randn(SHAPE, generator=g) for _ in range(5)])
    assert torch.equal(z_gen, tddim.ddim_sample(model_t, t(x_T), noise=draws, **kw))
    assert torch.equal(tddim.ddim_sample(model_t, t(x_T), **kw),       # default: seed 0
                       tddim.ddim_sample(model_t, t(x_T),
                                         generator=torch.Generator().manual_seed(0), **kw))


@pytest.fixture(scope="module")
def unets():
    # random weights made by the port (JAX's init would compile a kernel per leaf shape)
    tree = randomized(module_tree(reset_parameters(tunet.UNet(TORCH_UNET),
                                                   torch.Generator().manual_seed(3))), 4)
    tu, ju = port_module(tunet.UNet(TORCH_UNET), tree), jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(5)
    ctx = rng.standard_normal((1, 4, 77, 64)).astype(np.float32)    # [L, 2B, 77, D]
    jctx = jnp.asarray(ctx)

    def model_j(x, s):
        c = jctx if x.shape[0] == 4 else jctx[:, :2]
        return junet.forward(ju, x, s, c, cfg=JAX_UNET)

    def model_t(x, s):
        c = t(ctx) if x.shape[0] == 4 else t(ctx)[:, :2]
        with torch.no_grad():
            return tu(x, s, c)
    return model_j, model_t


@pytest.mark.parametrize("eta,with_mask,use_cfg", [(0.5, True, True), (0.0, False, False)])
def test_ddim_sample_options_match_jax_on_tiny_unet(unets, eta, with_mask, use_cfg):
    model_j, model_t = unets
    rng = np.random.default_rng(6)
    shape = (2, 8, 8, 4)
    x_T = rng.standard_normal(shape).astype(np.float32)
    x0 = rng.standard_normal(shape).astype(np.float32)
    mask = np.zeros(shape, np.float32)
    mask[:, 2:6, 2:6] = 1.0
    grid = np.asarray([1, 301, 601, 901])
    kw = dict(guidance_scale=(4.0, 1.0), eta=eta, use_cfg=use_cfg, timesteps=grid)
    mj = dict(mask=jnp.asarray(mask), x0=jnp.asarray(x0)) if with_mask else {}
    mt = dict(mask=t(mask), x0=t(x0)) if with_mask else {}
    z_j = jddim.ddim_sample(model_j, jnp.asarray(x_T), noise_key=jax.random.PRNGKey(2), **kw, **mj)
    z_t = tddim.ddim_sample(model_t, t(x_T), noise=t(jax_draws(2, len(grid), shape)), **kw, **mt)
    assert float(np.abs(np.asarray(z_j)).max()) > 0.1
    assert_close(z_t, z_j, atol=UNET_TOL, rtol=1e-5)


@pytest.mark.parametrize("index", [0, 7, 19])
def test_stochastic_encode_matches_jax(index):
    x0 = np.random.default_rng(index).standard_normal(SHAPE).astype(np.float32)
    noise = np.random.default_rng(100 + index).standard_normal(SHAPE).astype(np.float32)
    z_j = jddim.stochastic_encode(jnp.asarray(x0), jnp.asarray(index), None, num_steps=20,
                                  noise=jnp.asarray(noise))
    z_t = tddim.stochastic_encode(t(x0), index, num_steps=20, noise=t(noise))
    assert_close(z_t, z_j, atol=TOY_TOL, rtol=TOY_TOL)
    # drawn: the generator's normal, seeded 0 by default
    drawn = torch.randn(SHAPE, generator=torch.Generator().manual_seed(0))
    assert torch.equal(tddim.stochastic_encode(t(x0), index, num_steps=20),
                       tddim.stochastic_encode(t(x0), index, num_steps=20, noise=drawn))


@pytest.mark.parametrize("use_cfg", [True, False])
@pytest.mark.parametrize("t_start", [1, 3, 8])
def test_ddim_decode_matches_jax(t_start, use_cfg):
    x, _, _ = _inputs(2)
    model_j, model_t = _toy(use_cfg)
    z_j = jddim.ddim_decode(model_j, jnp.asarray(x), t_start, num_steps=8, guidance_scale=5.0,
                            use_cfg=use_cfg)
    z_t = tddim.ddim_decode(model_t, t(x), t_start, num_steps=8, guidance_scale=5.0,
                            use_cfg=use_cfg)
    assert_close(z_t, z_j, atol=TOY_TOL, rtol=TOY_TOL)


def test_ddim_decode_from_the_top_is_ddim_sample():
    """t_start = num_steps: the same steps, coefficients and guidance as
    ddim_sample at eta 0 (explicit or default), bit for bit."""
    x, _, _ = _inputs(3)
    _, model_t = _toy(True)
    z_dec = tddim.ddim_decode(model_t, t(x), 9, num_steps=9, guidance_scale=6.0)
    assert torch.equal(z_dec, tddim.ddim_sample(model_t, t(x), num_steps=9, guidance_scale=6.0))
    assert torch.equal(z_dec, tddim.ddim_sample(model_t, t(x), num_steps=9, guidance_scale=6.0,
                                                eta=0.0))
    zeros = torch.zeros(SHAPE)
    assert torch.equal(z_dec, tddim.ddim_sample(model_t, t(x), num_steps=9, guidance_scale=6.0,
                                                mask=zeros, x0=t(x)))


# -- the translate CLI -----------------------------------------------------------

TRANSLATE_SIZE = 64


@pytest.fixture()
def small_photos(monkeypatch):
    """Both CLIs resize to TRANSLATE_SIZE: the port's constant, and PIL's
    resize wherever the JAX CLI asks it for 512x512."""
    monkeypatch.setattr(ttranslate, "IMAGE_SIZE", TRANSLATE_SIZE)
    resize = Image.Image.resize

    def small(self, size, *a, **k):
        return resize(self, (TRANSLATE_SIZE, TRANSLATE_SIZE) if tuple(size) == (512, 512)
                      else size, *a, **k)
    monkeypatch.setattr(Image.Image, "resize", small)


def test_translate_cli_matches_jax(env, clis, small_photos, tmp_path, monkeypatch):
    """The subject's contexts within CTX_TOL, each photo's z_t within Z_TOL
    (JAX's PRNGKey(seed + i) normal handed to the port), the decoded uint8
    images within one level; each output under the photo's name: a PNG
    through the port's writer, decoding to the image decoded, and a `.jpg`
    photo written back as a JPEG (PIL's encoding of the image decoded), as
    the JAX CLI writes it."""
    photos = tmp_path / "photos"
    photos.mkdir()
    rng = np.random.default_rng(1)
    write_png(str(photos / "a.png"), rng.integers(0, 256, (96, 80, 3), np.uint8))
    write_png(str(photos / "b.png"), rng.integers(0, 256, (70, 90, 3), np.uint8))
    Image.fromarray(rng.integers(0, 256, (80, 80, 3), np.uint8)).save(str(photos / "c.jpg"))
    rec = {k: [] for k in ("jprompt", "tprompt", "jenc", "tenc", "jdec", "tdec")}
    for key, owner, name in (("jprompt", jwrap.AdaFacePipeline, "encode_prompt"),
                             ("tprompt", twrap.AdaFacePipeline, "encode_prompt"),
                             ("jdec", jpipe.StableDiffusionPipeline, "decode_latents"),
                             ("tdec", tpipe.StableDiffusionPipeline, "decode_latents")):
        monkeypatch.setattr(owner, name, _record(rec[key], getattr(owner, name)))
    jkeys = []

    def j_encode(x0, index, key, **k):
        jkeys.append(key)
        out = jddim_encode(x0, index, key, **k)
        rec["jenc"].append(out)
        return out

    def t_encode(x0, index, gen, **k):
        noise = jax.random.normal(jkeys[len(rec["tenc"])], tuple(x0.shape), jnp.float32)
        out = tddim_encode(x0, index, gen, noise=t(noise), **k)
        rec["tenc"].append(out)
        return out
    jddim_encode, tddim_encode = jddim.stochastic_encode, tddim.stochastic_encode
    monkeypatch.setattr(jddim, "stochastic_encode", j_encode)
    monkeypatch.setattr(tddim, "stochastic_encode", t_encode)
    argv = ["--in_folder", str(photos), "--subject", env["photos"], "--prompt", "portrait of a z",
            "--num_steps", "5", "--ref_img_strength", "0.4", "--adaface_ckpt", env["files"]["pt"],
            "--arcface_ckpt", env["files"]["arcface"]]
    out_j, out_t = tmp_path / "jax", tmp_path / "port"
    jtranslate.main(argv + ["--outdir", str(out_j)])
    paths = ttranslate.main(argv + ["--outdir", str(out_t), "--device", "cpu"])

    assert [os.path.basename(p) for p in paths] == ["a.png", "b.png", "c.jpg"]
    (_, (cj, uj)), (_, (ct, ut)) = rec["jprompt"][0], rec["tprompt"][0]
    assert tuple(ct.shape) == (1, 77, 576) and float(np.abs(np.asarray(cj)).max()) > 0.1
    assert_close(ct, cj, atol=CTX_TOL)
    assert_close(ut, uj, atol=CTX_TOL)
    assert len(rec["tenc"]) == len(rec["jenc"]) == 3
    for zt, zj in zip(rec["tenc"], rec["jenc"]):
        assert tuple(zt.shape) == (1, TRANSLATE_SIZE // 8, TRANSLATE_SIZE // 8, 4)
        assert_close(zt, zj, atol=Z_TOL)
    images = {}
    for path, (_, img_j), (_, img_t) in zip(paths, rec["jdec"], rec["tdec"]):
        got, want = img_t[0], np.asarray(img_j)[0]
        assert got.shape == (TRANSLATE_SIZE, TRANSLATE_SIZE, 3) and got.std() > 0
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
        images[os.path.basename(path)] = got
    for name in ("a.png", "b.png"):
        assert np.array_equal(read_png(str(out_t / name)), images[name])
    jpeg = io.BytesIO()
    Image.fromarray(images["c.jpg"]).save(jpeg, format="JPEG")
    with open(out_t / "c.jpg", "rb") as f:
        assert f.read() == jpeg.getvalue()
    with Image.open(out_j / "c.jpg") as im:             # JAX's output is a JPEG too
        assert im.format == "JPEG" and im.size == (TRANSLATE_SIZE, TRANSLATE_SIZE)
