"""The port's txt2img and infer CLIs against the JAX package's (CPU,
`--device cpu`, tiny models; `load_pipeline` monkeypatched as
tests/test_cli.py does it): both packages read the same checkpoint files
(an AdaFace `embeddings_gs-*.pt` whose generator has K/V-widened layers, or
a native .npz; a tiny IResNet in the insightface layout) and the same PNG
photos; the contexts each CLI passes to `generate` (and infer's subject
vectors) must agree, and the PNGs on disk must decode to the images
`generate` returned. The images themselves differ: the initial noise of
the two packages comes from different generators. `generate` runs at
32x32 in both packages: the infer CLI asks for 512x512, which takes the
tiny models most of a minute on the CPU, and no context depends on it."""

import copy
import functools
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaprompt_tpu import pipeline as jpipe
from adaprompt_tpu.adaface import wrapper as jwrap
from adaprompt_tpu.cli import common as jcommon, infer as jinfer, txt2img as jtxt2img
from adaprompt_tpu.models import arcface as jarcface
from adaprompt_tpu_torch import pipeline as tpipe
from adaprompt_tpu_torch.adaface import checkpoint as tckpt, subj_basis_generator as tsbg
from adaprompt_tpu_torch.adaface import wrapper as twrap
from adaprompt_tpu_torch.adaface.checkpoint import load_module_tree, module_tree
from adaprompt_tpu_torch.cli import common as tcommon, infer as tinfer, txt2img as ttxt2img
from adaprompt_tpu_torch.models import arcface as tarcface, vae as tvae
from adaprompt_tpu_torch.ops.layers import reset_parameters
from adaprompt_tpu_torch.utils.png import read_png, write_png
from torch_port_helpers import (JAX_VAE, TORCH_VAE, arcface_pair, assert_close, port_module,
                                randomized, train_env)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import reference_layouts as rl  # noqa: E402

ARCFACE_CLI = dict(layers=(1, 1, 1, 1), planes=(8, 8, 16, 16), num_features=512,
                   input_size=112)   # the CLIs' centre crop is 112 pixels
CTX_TOL = 2e-4                        # fp32 contexts: ArcFace -> Arc2Face -> generator -> CLIP


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite's parallel workers share a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Tiny shared weights and the files both packages read."""
    d = tmp_path_factory.mktemp("cli")
    e = train_env(d)
    vae = reset_parameters(tvae.VAE(TORCH_VAE), torch.Generator().manual_seed(7))
    jv = randomized(module_tree(vae), 8)
    e["tv"], e["jv"] = port_module(tvae.VAE(TORCH_VAE), jv), jax.tree.map(jnp.asarray, jv)
    # the CLIs' generator config (output_dim 768); K/V widened x2 on the second layer
    scfg = tsbg.SubjBasisConfig(placeholder_is_bg=False, text_cfg=e["tfrozen"].text.cfg)
    sbg = reset_parameters(tsbg.SubjBasisGenerator(scfg), torch.Generator().manual_seed(9))
    sbg = load_module_tree(sbg, randomized(module_tree(sbg), 10))
    tsbg.extend_prompt2token_proj_attention(sbg, 2, begin_layer=1,
                                            generator=torch.Generator().manual_seed(11))
    files = {"pt": rl.write_adaface_pt(str(d / "embeddings_gs-100.pt"), {"z": sbg}),
             "npz": str(d / "adaface.npz"), "arcface": str(d / "arcface.pth")}
    tckpt.save_checkpoint(files["npz"], {"subj_basis": module_tree(sbg)}, {"step": 100})
    _, e["jacfg"], arc = arcface_pair(12, **ARCFACE_CLI)
    torch.save(rl.arcface_insightface(arc), files["arcface"])
    photos = d / "photos"
    photos.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        write_png(str(photos / f"p{i}.png"), rng.integers(0, 256, (96, 80, 3), np.uint8))
    e.update(files=files, photos=str(photos), sbg=sbg)
    return e


def _record(calls, fn, **override):
    """`fn`, recording each call's keyword arguments (as the caller gave
    them) and result; `override` replaces some of the arguments."""
    def wrapped(*a, **k):
        out = fn(*a, **{**k, **override})
        calls.append((k, out))
        return out
    return wrapped


@pytest.fixture()
def clis(env, monkeypatch):
    """Fresh pipelines over the shared weights in both packages (the CLIs
    grow the tokenizers and the port's token table), wired in as
    `load_pipeline`; their generate calls recorded; the tiny ArcFace as
    the CLIs' IResNet-100."""
    jf, tf = env["jfrozen"], env["tfrozen"]
    jp = jpipe.StableDiffusionPipeline(
        jpipe.SDParams(unet=jf.unet, vae=env["jv"], text=dict(jf.text)),
        tokenizer=copy.deepcopy(env["jtok"]), unet_cfg=env["ju"], vae_cfg=JAX_VAE,
        text_cfg=env["jt"], compute_dtype=jnp.float32)
    tp = tpipe.StableDiffusionPipeline(tf.unet, env["tv"], copy.deepcopy(tf.text),
                                       copy.deepcopy(env["ttok"]))
    calls = {"jax": [], "port": []}
    jp.generate = _record(calls["jax"], jp.generate, height=32, width=32)
    tp.generate = _record(calls["port"], tp.generate, height=32, width=32)
    monkeypatch.setattr(jcommon, "load_pipeline", lambda args: jp)
    monkeypatch.setattr(tcommon, "load_pipeline", lambda args: tp)
    monkeypatch.setattr(jarcface, "from_torch",
                        functools.partial(jarcface.from_torch, cfg=env["jacfg"]))
    monkeypatch.setattr(jarcface, "IRESNET100", env["jacfg"])
    monkeypatch.setattr(tarcface, "IRESNET100", tarcface.IResNetConfig(**ARCFACE_CLI))
    return calls


def _check_outputs(calls, paths_j, paths_t):
    """Equal contexts in every generate call; each port PNG decodes to the
    image that generate returned."""
    assert len(calls["jax"]) == len(calls["port"]) > 0 and len(paths_j) == len(paths_t)
    for (kj, _), (kt, _) in zip(calls["jax"], calls["port"]):
        for name in ("context", "context_uncond"):
            cj, ct = np.asarray(kj[name]), kt[name]
            assert ct.shape == cj.shape, name
            assert float(np.abs(cj).max()) > 0.1
            assert_close(ct, cj, atol=CTX_TOL)
    images = np.concatenate([out for _, out in calls["port"]])
    assert len(images) == len(paths_t)
    for path, img in zip(paths_t, images):
        assert np.array_equal(read_png(path), img)


@pytest.mark.parametrize("adaface,ref_images,compel", [("pt", True, 1.5), ("pt", False, 0.0),
                                                       ("npz", False, 0.0)])
def test_txt2img_cli_matches_jax(env, clis, tmp_path, adaface, ref_images, compel):
    """Reference .pt (its generator's K/V-widened layers) or native .npz;
    the face of the photos or, without them, the seeded random face; the
    compel weighting on the cond contexts."""
    argv = ["--prompt", "photo of a z in the park", "--n_samples", "2", "--ddim_steps", "2",
            "--H", "32", "--W", "32", "--neg_prompt", "photo of the cat",
            "--adaface_ckpt", env["files"][adaface], "--compel_cfg_weight_level", str(compel)]
    if ref_images:
        argv += ["--ref_images", env["photos"], "--arcface_ckpt", env["files"]["arcface"]]
    paths_j = jtxt2img.main(argv + ["--outdir", str(tmp_path / "jax")])
    paths_t = ttxt2img.main(argv + ["--outdir", str(tmp_path / "port"), "--device", "cpu"])
    _check_outputs(clis, paths_j, paths_t)
    assert [os.path.basename(p) for p in paths_t] == ["p000-00000.png", "p000-00001.png"]


def test_txt2img_cli_refuses_compare_with(env, clis, tmp_path):
    with pytest.raises(NotImplementedError, match="A7"):
        ttxt2img.main(["--compare_with", str(tmp_path), "--device", "cpu"])
    assert not clis["port"]


def test_infer_cli_matches_jax(env, clis, tmp_path, monkeypatch):
    """Photos -> the same 16 subject vectors and contexts through both
    packages' AdaFacePipeline, whose Arc2Face encoder is the SD text model:
    JAX's a snapshot taken before the token table grows, the port's the
    grown module itself."""
    subj = {"jax": [], "port": []}
    for pkg, cls in (("jax", jwrap.AdaFacePipeline), ("port", twrap.AdaFacePipeline)):
        monkeypatch.setattr(cls, "generate_adaface_embeddings",
                            _record(subj[pkg], cls.generate_adaface_embeddings))
    argv = ["--subject", env["photos"], "--prompt", "portrait of z", "--out_image_count", "2",
            "--num_steps", "2", "--adaface_ckpt", env["files"]["pt"],
            "--arcface_ckpt", env["files"]["arcface"]]
    paths_j = jinfer.main(argv + ["--outdir", str(tmp_path / "jax")])
    paths_t = tinfer.main(argv + ["--outdir", str(tmp_path / "port"), "--device", "cpu"])
    (_, vj), (_, vt) = subj["jax"][0], subj["port"][0]
    assert tuple(vt.shape) == (16, 576) and float(np.abs(np.asarray(vj)).max()) > 0.1
    assert_close(vt, vj, atol=CTX_TOL)
    _check_outputs(clis, paths_j, paths_t)


@pytest.mark.parametrize("cmd", ["replace-vae", "replace-text", "average", "inspect"])
def test_ckpt_tools_match_jax(env, tmp_path, capsys, cmd):
    """Each ckpt_tools subcommand of the port writes (or prints) what JAX's
    does, on an SD checkpoint in the LDM layout (a .ckpt base, a bare .npz
    donor) and on native .npz AdaFace checkpoints."""
    from adaprompt_tpu.cli import ckpt_tools as jtools
    from adaprompt_tpu_torch.cli import ckpt_tools as ttools
    base = rl.sd_checkpoint(types.SimpleNamespace(unet=env["tfrozen"].unet, vae=env["tv"],
                                                  text=env["tfrozen"].text))
    paths = {"base": str(tmp_path / "base.ckpt"), "a": str(tmp_path / "a.npz"),
             "b": str(tmp_path / "b.npz")}
    torch.save(base, paths["base"])
    donor = {"vae": rl.vae_ldm(env["tv"]), "text": {"transformer." + k: v for k, v in
                                                    rl.clip_hf(env["tfrozen"].arc2face_text).items()}}
    for name, sd in donor.items():
        paths[name] = str(tmp_path / f"donor_{name}.npz")
        np.savez(paths[name], **{k: (v * 0.5).numpy() for k, v in sd.items()
                                 if v.is_floating_point()})
    tckpt.save_checkpoint(paths["a"], {"subj_basis": module_tree(env["sbg"])}, {"step": 1})
    tckpt.save_checkpoint(paths["b"], {"subj_basis": jax.tree.map(
        lambda x: x * 3.0, module_tree(env["sbg"]))}, {"step": 2})
    outs = {}
    for pkg, tool in (("jax", jtools), ("port", ttools)):
        out = str(tmp_path / f"{pkg}.npz")
        if cmd == "inspect":
            tool.main(["inspect", paths["base"]])
            outs[pkg] = capsys.readouterr().out
            continue
        if cmd == "average":
            tool.main(["average", paths["a"], paths["b"], "--out", out])
        else:
            tool.main([cmd, "--base", paths["base"], "--donor",
                       paths["vae" if cmd == "replace-vae" else "text"], "--out", out])
        outs[pkg] = dict(np.load(out))
        outs[pkg + "_log"] = capsys.readouterr().out.replace(out, "<out>")
    if cmd == "inspect":
        n = sum(hasattr(v, "shape") for v in base["state_dict"].values())
        assert outs["port"] == outs["jax"] and outs["port"].startswith(f"{n} tensors\n")
        return
    assert outs["port_log"] == outs["jax_log"] and "replaced 0 " not in outs["port_log"]
    assert sorted(outs["port"]) == sorted(outs["jax"])
    for k, v in outs["jax"].items():
        assert np.array_equal(outs["port"][k], v), k
