"""The port's diffusers-format loaders and the arc2face_gen CLI against the
JAX package's (CPU, float32, tiny models).

`tools/reference_layouts.py` writes a port UNet / VAE in the diffusers
layout, in both forms of each naming that differs between diffusers
versions (the transformers' proj_in / proj_out as 1x1 convs or Linear; the
VAE mid-block attention under `group_norm` / `to_q` ... `to_out.0` with
Linear weights, or `norm` / `query` ... `proj_attn` with 1x1 convs). The
written keys are held against the JAX package's own ldm -> diffusers
renames (tests/test_diffusers_port.py), JAX's `unet_from_diffusers` /
`vae_from_diffusers` and the port's must both give back the weights
written, bit for bit, and the loaded models' forwards must agree.

The arc2face_gen CLI runs in both packages over tests/test_torch_cli.py's
tiny models (`load_pipeline` monkeypatched, `--device cpu`, generate at
32x32), with `--arc2face_ckpt` an LDM checkpoint or a diffusers UNet state
dict and with `--ref_images` or without (numpy's seeded random face)."""

import functools
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaprompt_tpu.cli import arc2face_gen as jarc2face
from adaprompt_tpu.models import clip_text as jclip, unet as junet, vae as jvae
from adaprompt_tpu.utils import diffusers_port as jdp
from adaprompt_tpu_torch import convert
from adaprompt_tpu_torch.cli import arc2face_gen as tarc2face
from adaprompt_tpu_torch.models import unet as tunet, vae as tvae
from adaprompt_tpu_torch.utils import diffusers_port as tdp
from test_diffusers_port import ldm_to_diffusers_unet, ldm_to_diffusers_vae
from test_torch_checkpoint_loaders import _arrays, _assert_bit_equal, seeded
from test_torch_cli import _check_outputs, _record, clis, env, rl  # noqa: F401
from torch_port_helpers import (JAX_UNET, JAX_VAE, TORCH_UNET, TORCH_VAE, assert_close, t)
from torch_port_helpers import torch_threads  # noqa: F401

FORMS = {"unet": {"conv_proj": {}, "linear_proj": {"linear_proj": True}},
         "vae": {"attn_names": {}, "legacy_attn_names": {"legacy_attn_names": True}}}


@pytest.fixture(scope="module")
def models():
    return {"unet": seeded(tunet.UNet(TORCH_UNET), 21), "vae": seeded(tvae.VAE(TORCH_VAE), 22)}


def _written(models, kind, form):
    """(the written diffusers state dict, JAX's loader, the port's loader)."""
    if kind == "unet":
        return (rl.unet_diffusers(models["unet"], **FORMS["unet"][form]),
                lambda s: jdp.unet_from_diffusers(s, JAX_UNET),
                lambda s: tdp.unet_from_diffusers(s, TORCH_UNET))
    return (rl.vae_diffusers(models["vae"], **FORMS["vae"][form]),
            lambda s: jdp.vae_from_diffusers(s, JAX_VAE),
            lambda s: tdp.vae_from_diffusers(s, TORCH_VAE))


CASES = [(kind, form) for kind in FORMS for form in FORMS[kind]]


@pytest.mark.parametrize("kind,form", CASES)
def test_diffusers_layout_loads_back_bit_exact(models, kind, form):
    """JAX's loader (compared under the port's names through
    convert.from_jax_params) and the port's give back the module's weights."""
    sd, jax_load, port_load = _written(models, kind, form)
    want = _arrays(models[kind].state_dict())
    _assert_bit_equal(_arrays(convert.from_jax_params(jax.tree.map(np.asarray, jax_load(sd)))),
                      want)
    _assert_bit_equal(_arrays(port_load(sd)), want)


@pytest.mark.parametrize("kind,form", CASES)
def test_diffusers_writer_matches_the_ldm_renames(models, kind, form):
    """The written keys are those of the JAX package's ldm -> diffusers
    renames of the LDM layout (its conv-form proj and Linear to_q names),
    each other form differing only where the form says."""
    m = models[kind]
    sd, _, _ = _written(models, kind, form)
    if kind == "unet":
        ref = ldm_to_diffusers_unet(rl.unet_ldm(m), TORCH_UNET)
        # that rename also files the upsample conv of a level without
        # attention ('output_blocks.N.1.conv') under 'attentions.2.conv', a
        # key no loader reads, beside its right name
        stray = [k for k in ref if re.search(r"\.attentions\.\d+\.conv\.", k)]
        assert len(stray) == 2
        ref = {k: v for k, v in ref.items() if k not in stray}
        other = [k for k in ref if ".proj_in.weight" in k or ".proj_out.weight" in k]
        assert len(other) == 2 * 16                    # the tiny UNet's 16 transformers
    else:
        ref = ldm_to_diffusers_vae(rl.vae_ldm(m), TORCH_VAE)
        renames = {".group_norm.": ".norm.", ".to_q.": ".query.", ".to_k.": ".key.",
                   ".to_v.": ".value.", ".to_out.0.": ".proj_attn."}
        if form == "legacy_attn_names":
            for a, b in renames.items():
                ref = {k.replace(a, b): v for k, v in ref.items()}
        other = [k for k in ref if "attentions" in k and k.endswith(".weight")
                 and ".norm." not in k and ".group_norm." not in k]
        assert len(other) == 2 * 4                     # q, k, v, out in each tower
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        w = sd[k]
        if k in other and form in ("linear_proj", "legacy_attn_names"):
            v = v.reshape(w.shape)                     # the other rank of the same weight
            assert w.ndim == (2 if form == "linear_proj" else 4), k
        assert torch.equal(w, v), k


@pytest.fixture(scope="module")
def loaded(models):
    """JAX trees and fresh port modules read from the Linear-proj UNet and
    the legacy-named VAE."""
    out = {}
    for kind, form in (("unet", "linear_proj"), ("vae", "legacy_attn_names")):
        sd, jax_load, port_load = _written(models, kind, form)
        module = tunet.UNet(TORCH_UNET) if kind == "unet" else tvae.VAE(TORCH_VAE)
        module.load_state_dict(port_load(sd), strict=True)
        out[kind] = (jax_load(sd), module.eval())
    return out


def test_diffusers_unet_forward_matches_jax(loaded):
    ju, tu = loaded["unet"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ts = np.asarray([981, 21], np.int32)
    ctx = (rng.standard_normal((2, 77, 64)) * 0.5).astype(np.float32)
    eps_j = jax.jit(lambda p, *a: junet.forward(p, *a, cfg=JAX_UNET))(ju, x, ts, ctx)
    with torch.no_grad():
        eps_t = tu(t(x), torch.from_numpy(ts), t(ctx))
    assert float(np.abs(np.asarray(eps_j)).max()) > 1e-2
    assert_close(eps_t, eps_j, atol=2e-4, rtol=1e-4)


def test_diffusers_vae_encode_and_decode_match_jax(loaded):
    jv, tv = loaded["vae"]
    rng = np.random.default_rng(5)
    z = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    mean_j, logvar_j = jvae.encode(jv, jnp.asarray(x), cfg=JAX_VAE)
    with torch.no_grad():
        img_t = tv.decode(t(z))
        mean_t, logvar_t = tv.encode(t(x))
    assert_close(img_t, jvae.decode(jv, jnp.asarray(z), cfg=JAX_VAE), atol=2e-4, rtol=1e-4)
    assert_close(mean_t, mean_j, atol=2e-4, rtol=1e-4)
    assert_close(logvar_t, logvar_j, atol=2e-4, rtol=1e-4)


# -- the arc2face_gen CLI -----------------------------------------------------------

@pytest.fixture(scope="module")
def teacher_files(env, tmp_path_factory):
    """The teacher as an LDM checkpoint (the tiny teacher UNet, VAE and the
    Arc2Face text encoder) and as a diffusers UNet state dict (.bin)."""
    d = tmp_path_factory.mktemp("arc2face")
    tf = env["tfrozen"]
    files = {"ldm": str(d / "arc2face.ckpt"), "diffusers": str(d / "unet.bin")}
    torch.save(rl.sd_checkpoint(types.SimpleNamespace(unet=tf.teacher_unet, vae=env["tv"],
                                                      text=tf.arc2face_text)), files["ldm"])
    torch.save(rl.unet_diffusers(tf.teacher_unet), files["diffusers"])
    return files


@pytest.mark.parametrize("ckpt,ref_images", [("ldm", True), ("diffusers", True),
                                             ("diffusers", False)])
def test_arc2face_gen_cli_matches_jax(env, clis, teacher_files, tmp_path, monkeypatch, ckpt,
                                      ref_images):
    """The contexts passed to generate agree within CTX_TOL (the LDM file's
    Arc2Face text encoder, or the pipeline's own), the PNGs decode to the
    images generate returned, and the teacher UNet that replaced the
    pipeline's holds the file's weights."""
    for mod, name, cfg in ((junet, "from_torch", env["ju"]), (jclip, "from_torch", env["jt"]),
                           (jdp, "unet_from_diffusers", env["ju"])):
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), cfg=cfg))
    teachers, load_teacher = [], tarc2face.load_teacher

    def recording(path, pipe):
        text = load_teacher(path, pipe)
        teachers.append((pipe, text))
        return text
    monkeypatch.setattr(tarc2face, "load_teacher", recording)
    argv = ["--arc2face_ckpt", teacher_files[ckpt], "--n_samples", "2", "--ddim_steps", "2",
            "--guidance_scale", "3.5"]
    if ref_images:
        argv += ["--ref_images", env["photos"], "--arcface_ckpt", env["files"]["arcface"]]
    paths_j = jarc2face.main(argv + ["--outdir", str(tmp_path / "jax")])
    paths_t = tarc2face.main(argv + ["--outdir", str(tmp_path / "port"), "--device", "cpu"])
    _check_outputs(clis, paths_j, paths_t)
    assert [os.path.basename(p) for p in paths_t] == ["arc2face-00000.png", "arc2face-00001.png"]
    assert tuple(clis["port"][0][0]["context"].shape) == (1, 2, 21, 576)
    (pipe, text), = teachers
    tf = env["tfrozen"]
    _assert_bit_equal(_arrays(pipe.unet.state_dict()), _arrays(tf.teacher_unet.state_dict()))
    if ckpt == "ldm":
        _assert_bit_equal(_arrays(text.state_dict()), _arrays(tf.arc2face_text.state_dict()))
    else:
        assert text is pipe.text
