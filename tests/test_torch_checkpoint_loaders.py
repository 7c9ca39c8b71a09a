"""The port's checkpoint loaders against the JAX package's (CPU, tiny
models, zero-initialized layers re-randomized first).

The reference layouts are written by `tools/reference_layouts.py` from the
port's modules: JAX's `from_torch` of each written state dict must give
back the weights it came from, bit for bit, and so must the port's
`from_torch`; then the loaded models' forwards against JAX's in fp32,
`load_state_dict` / `split_sd_checkpoint` on .ckpt, .npz and .safetensors,
`from_checkpoint`, the K/V multiplier surgery and compel CFG with JAX's
noise, `load_reference_checkpoint` on a pickled reference module, and the
zlib PNG reader against PIL."""

import os
import struct
import sys
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaprompt_tpu.adaface import checkpoint as jckpt, compel_cfg as jcompel
from adaprompt_tpu.adaface import subj_basis_generator as jsbg
from adaprompt_tpu.eval import face_eval as jfe
from adaprompt_tpu.models import arcface as jarcface
from adaprompt_tpu.models import clip_text as jclip, unet as junet, vae as jvae
from adaprompt_tpu.utils import torch_port as jtp
from adaprompt_tpu_torch import convert, pipeline as tpipe
from adaprompt_tpu_torch.adaface import checkpoint as tckpt, compel_cfg as tcompel
from adaprompt_tpu_torch.adaface import subj_basis_generator as tsbg
from adaprompt_tpu_torch.adaface.checkpoint import load_module_tree, module_tree
from adaprompt_tpu_torch.eval import face_eval as tfe
from adaprompt_tpu_torch.models import arcface as tarcface
from adaprompt_tpu_torch.models import clip_text as tclip, unet as tunet, vae as tvae
from adaprompt_tpu_torch.ops.layers import reset_parameters
from adaprompt_tpu_torch.utils import png as tpng, torch_port as ttp
from torch_port_helpers import (ARCFACE_TINY, JAX_TEXT, JAX_UNET, JAX_VAE, TORCH_TEXT,
                                TORCH_UNET, TORCH_VAE, arcface_pair, assert_close, randomized, t)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import reference_layouts as rl  # noqa: E402

SBG_FACE = dict(output_dim=64, dino_embedding_dim=32)
SBG_BG = dict(placeholder_is_bg=True, num_out_embs_per_layer=4, num_id_vecs_bg=10,
              image_embedding_dim=48, output_dim=64, num_heads=4)
MKV_LAYERS = dict(multiplier=2, begin_layer=1)      # K/V widened on the second layer only


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite's parallel workers share a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded(module, seed):
    """`module` with random weights from `seed`, its all-zero leaves
    re-randomized (the UNet's zero_module convs among them)."""
    reset_parameters(module, torch.Generator().manual_seed(seed))
    return load_module_tree(module, randomized(module_tree(module), seed + 100)).eval()


@pytest.fixture(scope="module")
def models():
    sbg_face = seeded(tsbg.SubjBasisGenerator(
        tsbg.SubjBasisConfig(text_cfg=TORCH_TEXT, **SBG_FACE)), 4)
    tsbg.extend_prompt2token_proj_attention(sbg_face, **MKV_LAYERS,
                                            generator=torch.Generator().manual_seed(5))
    text_mkv = tclip.extend_attention_mkv(seeded(tclip.CLIPTextModel(TORCH_TEXT), 6),
                                          **MKV_LAYERS, generator=torch.Generator().manual_seed(7))
    _, jacfg, arc = arcface_pair(9, **ARCFACE_TINY)
    return {"unet": seeded(tunet.UNet(TORCH_UNET), 1), "vae": seeded(tvae.VAE(TORCH_VAE), 2),
            "text": seeded(tclip.CLIPTextModel(TORCH_TEXT), 3), "text_mkv": text_mkv,
            "sbg_face": sbg_face,
            "sbg_bg": seeded(tsbg.SubjBasisGenerator(tsbg.SubjBasisConfig(**SBG_BG)), 8),
            "arcface": arc, "jacfg": jacfg}


def _loaders(name, models):
    """(written reference state dict, JAX from_torch, port from_torch)."""
    m = models[name]
    if name == "unet":
        sd = {"model.diffusion_model." + k: v for k, v in rl.unet_ldm(m).items()}
        return sd, lambda s: junet.from_torch(s, JAX_UNET), lambda s: tunet.from_torch(s, TORCH_UNET)
    if name == "vae":
        sd = {"first_stage_model." + k: v for k, v in rl.vae_ldm(m).items()}
        return sd, lambda s: jvae.from_torch(s, JAX_VAE), lambda s: tvae.from_torch(s, TORCH_VAE)
    if name.startswith("text"):
        return (rl.clip_hf(m), lambda s: jclip.from_torch(s, JAX_TEXT),
                lambda s: tclip.from_torch(s, TORCH_TEXT))
    if name.startswith("sbg"):
        jcfg = jsbg.SubjBasisConfig(**(SBG_BG if name == "sbg_bg" else
                                       dict(text_cfg=JAX_TEXT, **SBG_FACE)))
        return (rl.subj_basis_reference(m), lambda s: jsbg.from_torch(s, jcfg),
                lambda s: tsbg.from_torch(s, m.cfg))
    cfg = tarcface.IResNetConfig(**ARCFACE_TINY)
    return (rl.arcface_insightface(m), lambda s: jarcface.from_torch(s, models["jacfg"]),
            lambda s: tarcface.from_torch(s, cfg))


def _arrays(state):
    return {k: np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in state.items()}


def _assert_bit_equal(got, want):
    assert sorted(got) == sorted(want)
    bad = [k for k in want if got[k].shape != want[k].shape or not np.array_equal(got[k], want[k])]
    assert not bad, bad[:10]


@pytest.mark.parametrize("name", ["unet", "vae", "text", "text_mkv", "sbg_face", "sbg_bg",
                                  "arcface"])
def test_written_layout_loads_back_bit_exact(models, name):
    """JAX's from_torch of the written reference state dict is the tree the
    weights came from (compared under the port's names through
    convert.from_jax_params), and the port's from_torch gives the same
    state dict: both bit for bit, the K/V-widened layers at their width."""
    m = models[name]
    sd, jax_load, port_load = _loaders(name, models)
    want = _arrays(m.state_dict())
    jtree = jax.tree.map(np.asarray, jax_load(sd))
    _assert_bit_equal(_arrays(convert.from_jax_params(jtree)), want)
    _assert_bit_equal(_arrays(port_load(sd)), want)
    if name in ("text_mkv", "sbg_face"):
        proj = jtree["prompt2token_proj"] if name == "sbg_face" else jtree
        assert [lp["attn"]["k"]["kernel"].shape[1] for lp in proj["layers"]] == [64, 128]


@pytest.fixture(scope="module")
def loaded(models):
    """Fresh port modules and JAX trees, both from the written layouts."""
    out = {}
    for name in ("unet", "vae", "text", "text_mkv"):
        sd, jax_load, port_load = _loaders(name, models)
        state = port_load(sd)
        module = {"unet": lambda: tunet.UNet(TORCH_UNET), "vae": lambda: tvae.VAE(TORCH_VAE)}.get(
            name, lambda: tclip.CLIPTextModel(TORCH_TEXT).match_kv_widths(state))()
        module.load_state_dict(state, strict=True)
        out[name] = (jax_load(sd), module.eval())
    return out


def test_loaded_unet_eps_matches_jax(loaded):
    ju, tu = loaded["unet"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ts = np.asarray([981, 21], np.int32)
    ctx = (rng.standard_normal((2, 77, 64)) * 0.5).astype(np.float32)
    # one compiled call: op by op, the JAX UNet takes three times as long here
    eps_j = jax.jit(lambda p, *a: junet.forward(p, *a, cfg=JAX_UNET))(ju, x, ts, ctx)
    with torch.no_grad():
        eps_t = tu(t(x), torch.from_numpy(ts), t(ctx))
    assert float(np.abs(np.asarray(eps_j)).max()) > 1e-2     # no vacuous zero eps
    assert_close(eps_t, eps_j, atol=2e-4, rtol=1e-4)


def test_loaded_vae_decode_and_encode_match_jax(loaded):
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


@pytest.mark.parametrize("name", ["text", "text_mkv"])
def test_loaded_clip_hidden_states_match_jax(loaded, name):
    """Last hidden states and pooled of the loaded CLIP text models, the
    K/V-widened one (a key sequence of 2 x 77 on its second layer) too,
    with clip-skip weights over the last two hidden states."""
    jt, tt = loaded[name]
    ids = np.random.default_rng(6).integers(1, 49000, (2, 77)).astype(np.int32)
    ids[:, 9] = 49407
    out_j, pooled_j = jclip.encode(jt, jnp.asarray(ids), cfg=JAX_TEXT, return_pooled=True,
                                   hidden_state_layer_weights=jnp.asarray([1.0, 2.0]))
    with torch.no_grad():
        out_t, pooled_t = tt.encode(torch.from_numpy(ids).long(), return_pooled=True,
                                    hidden_state_layer_weights=torch.tensor([1.0, 2.0]))
    assert_close(out_t, out_j, atol=2e-5)
    assert_close(pooled_t, pooled_j, atol=2e-5)


# -- files ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sd_files(models, tmp_path_factory):
    """The tiny models as a full SD checkpoint: .ckpt, .npz and (where the
    package is installed) .safetensors, plus a bare .pt with a non-tensor entry."""
    d = tmp_path_factory.mktemp("sd")
    pipe = types.SimpleNamespace(unet=models["unet"], vae=models["vae"], text=models["text"])
    ckpt = rl.sd_checkpoint(pipe)
    paths = {"ckpt": str(d / "model.ckpt"), "npz": str(d / "model.npz"),
             "pt": str(d / "bare.pt")}
    torch.save(ckpt, paths["ckpt"])
    np.savez(paths["npz"], **{k: v.numpy() for k, v in ckpt["state_dict"].items()})
    torch.save({"w": torch.arange(6.0).reshape(2, 3).half(), "step": 7, "name": "x"}, paths["pt"])
    try:
        from safetensors.torch import save_file
    except ImportError:
        pass
    else:
        paths["safetensors"] = str(d / "model.safetensors")
        save_file(ckpt["state_dict"], paths["safetensors"])
    return paths


@pytest.mark.parametrize("fmt", ["ckpt", "npz", "safetensors", "pt"])
def test_load_and_split_match_jax(sd_files, fmt):
    if fmt not in sd_files:
        pytest.skip("the safetensors package is not installed")
    got, want = ttp.load_state_dict(sd_files[fmt]), jtp.load_state_dict(sd_files[fmt])
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
        else:
            assert got[k] == v, k
    if fmt == "pt":
        assert got["step"] == 7 and got["w"].dtype == np.float32
        return
    parts_t, parts_j = ttp.split_sd_checkpoint(got), jtp.split_sd_checkpoint(want)
    assert {n: sorted(p) for n, p in parts_t.items()} == {n: sorted(p) for n, p in parts_j.items()}
    assert "alphas_cumprod" not in str(parts_t) and len(parts_t["text"]) > 0


def test_from_checkpoint_holds_the_written_weights(models, sd_files):
    """StableDiffusionPipeline.from_checkpoint on the CPU in fp32: every
    parameter bit-equal to the model it was written from."""
    pipe = tpipe.StableDiffusionPipeline.from_checkpoint(
        sd_files["ckpt"], device="cpu", dtype=torch.float32, unet_cfg=TORCH_UNET,
        vae_cfg=TORCH_VAE, text_cfg=TORCH_TEXT)
    for name in ("unet", "vae", "text"):
        _assert_bit_equal(_arrays(getattr(pipe, name).state_dict()),
                          _arrays(models[name].state_dict()))
    assert pipe.device.type == "cpu" and pipe.compute_dtype == torch.float32


# -- the K/V multiplier surgery, compel CFG -----------------------------------------------

@pytest.mark.parametrize("multiplier,begin,end", [(2, -1, -1), (3, 1, -1), (2, 0, 1)])
def test_extend_attention_mkv_matches_jax(models, multiplier, begin, end):
    """JAX's surgery on the model's tree against the port's on the model,
    given JAX's standard-normal draws (its key schedule replayed)."""
    tt = seeded(tclip.CLIPTextModel(TORCH_TEXT), 3)
    tree = jax.tree.map(jnp.asarray, module_tree(tt))
    key = jax.random.PRNGKey(11)
    got_j = jclip.extend_attention_mkv(tree, key, multiplier, 0.1, begin, end)
    draws, k = {}, key
    for i, lp in enumerate(tree["layers"]):
        if (begin >= 0 and i < begin) or (end >= 0 and i >= end):
            continue
        k, k1, k2 = jax.random.split(k, 3)
        for name, sub in (("k", k1), ("v", k2)):
            kern = lp["attn"][name]["kernel"]
            for r in range(multiplier - 1):
                z = jax.random.normal(jax.random.fold_in(sub, r), kern.shape, kern.dtype)
                draws[i, name, r] = torch.from_numpy(np.asarray(z).T.copy())
    tclip.extend_attention_mkv(tt, multiplier, 0.1, begin, end,
                               noise=lambda i, name, r: draws[i, name, r])
    want = _arrays(convert.from_jax_params(jax.tree.map(np.asarray, got_j)))
    got = _arrays(tt.state_dict())
    assert sorted(got) == sorted(want)
    for k_ in want:
        assert got[k_].shape == want[k_].shape, k_
        np.testing.assert_allclose(got[k_], want[k_], atol=1e-6, rtol=0, err_msg=k_)
    widths = [lp["attn"]["k"].weight.shape[0] for lp in tt.layers]
    assert widths == [64 * (multiplier if (begin < 0 or i >= begin) and (end < 0 or i < end)
                            else 1) for i in range(2)]


@pytest.mark.parametrize("masked,skipped", [(False, None), (True, None), (True, [0, 5])])
def test_compel_cfg_matches_jax(masked, skipped):
    rng = np.random.default_rng(0)
    ctx = rng.standard_normal((16, 4, 11, 8)).astype(np.float32)
    empty = rng.standard_normal((1, 1, 11, 8)).astype(np.float32)
    bmask = np.array([1.0, 0.0, 1.0, 1.0], np.float32) if masked else None
    got = tcompel.apply_compel_cfg(t(ctx), t(empty), 2.0, skipped_token_pos=skipped,
                                   batch_mask=None if bmask is None else t(bmask))
    want = jcompel.apply_compel_cfg(jnp.asarray(ctx), jnp.asarray(empty), 2.0,
                                    skipped_token_pos=skipped,
                                    batch_mask=None if bmask is None else jnp.asarray(bmask))
    assert_close(got, want, atol=1e-6)


def test_load_reference_checkpoint_matches_jax(models, tmp_path):
    """A reference .pt (the generator pickled as a module of the class
    `adaface.subj_basis_generator.SubjBasisGenerator`, registered only
    while it is saved) read by both packages without the reference's code;
    the port's generator built from it holds the source's weights."""
    path = str(tmp_path / "embeddings_gs-100.pt")
    before = {n: sys.modules.get(n) for n in ("adaface", "adaface.subj_basis_generator")}
    rl.write_adaface_pt(path, {"z": models["sbg_face"], "y": models["sbg_bg"]}, {"z": 49408})
    assert {n: sys.modules.get(n) for n in before} == before
    got, want = tckpt.load_reference_checkpoint(path), jckpt.load_reference_checkpoint(path)
    assert sorted(got) == sorted(want) and got["string_to_token"] == {"z": 49408}
    assert sorted(got["raw"]) == sorted(want["raw"])
    for ph in ("z", "y"):
        _assert_bit_equal(got["subj_basis_generators"][ph], want["subj_basis_generators"][ph])
    assert "prompt2token_proj.text_model.embeddings.position_ids" in got["subj_basis_generators"]["z"]
    for ph, name in (("z", "sbg_face"), ("y", "sbg_bg")):
        cfg = models[name].cfg
        sbg = tsbg.from_state(tsbg.from_torch(got["subj_basis_generators"][ph], cfg), cfg)
        _assert_bit_equal(_arrays(sbg.state_dict()), _arrays(models[name].state_dict()))


# -- the PNG reader, photos on disk ------------------------------------------------------

def _filtered_png(img, filters):
    """An RGB PNG whose row y is written with filter filters[y % 5]: the
    filters applied here, the decoding left to the codec under test."""
    h, w, _ = img.shape
    a = img.reshape(h, w * 3).astype(np.int32)
    rows = []
    for y in range(h):
        f = filters[y % len(filters)]
        x, up = a[y], a[y - 1] if y else np.zeros_like(a[0])
        left = np.concatenate([np.zeros(3, np.int32), x[:-3]])
        ul = np.concatenate([np.zeros(3, np.int32), up[:-3]])
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        rows.append(bytes([f]) + ((x - pred) % 256).astype(np.uint8).tobytes())
    chunk = lambda tag, data: (struct.pack(">I", len(data)) + tag + data
                               + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    return (tpng.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "P", "L", "LA", "filters"])
def test_png_reader_matches_pil(mode, tmp_path):
    """The zlib decoder against PIL's decode and `convert("RGB")`: files PIL
    wrote (adaptive filters) in every 8-bit colour type, and one whose rows
    take filters 0-4 in turn."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (23, 37, 3), dtype=np.uint8)
    img[5:15] = img[5:15] // 64 * 64                 # flat runs, so every filter pays somewhere
    path = str(tmp_path / "x.png")
    if mode == "filters":
        with open(path, "wb") as f:
            f.write(_filtered_png(img, [0, 1, 2, 3, 4]))
    else:
        im = Image.fromarray(img)
        if mode == "RGBA":
            im = Image.fromarray(np.concatenate([img, img[..., :1]], axis=2), "RGBA")
        elif mode == "P":
            im = im.quantize(colors=50)
        elif mode in ("L", "LA"):
            im = im.convert(mode)
        im.save(path)
    want = np.asarray(Image.open(path).convert("RGB"))
    got = tpng.read_image(path)
    assert got.dtype == np.uint8 and got.shape == (23, 37, 3)
    assert np.array_equal(got, want)
    data = bytearray(open(path, "rb").read())
    data[-20] ^= 1                                    # inside the last IDAT chunk's body
    with pytest.raises(ValueError, match="CRC|IEND|image data|IDAT|chunk"):
        tpng.decode_png(bytes(data), path)


def test_embed_folder_without_pil_matches_jax(tmp_path, monkeypatch):
    """FaceSimilarityEvaluator.embed_folder on PNGs with PIL hidden, against
    JAX's (which reads through PIL) on the same tiny ArcFace; `list_images`
    lists the folder as JAX's does; without PIL a .jpg raises, naming it."""
    ja, jacfg, ta = arcface_pair(9, **ARCFACE_TINY)
    rng = np.random.default_rng(2)
    for i in range(3):
        tpng.write_png(str(tmp_path / f"p{i}.png"), rng.integers(0, 256, (48, 40, 3), np.uint8))
    (tmp_path / "notes.txt").write_text("x")
    paths = jfe.list_images(str(tmp_path))
    assert tfe.list_images(str(tmp_path)) == paths and len(paths) == 3
    crop = lambda im: jfe.center_crop_detector(im, ARCFACE_TINY["input_size"])
    want = jfe.FaceSimilarityEvaluator(ja, jacfg, detector=crop).embed_folder(paths)
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = tfe.FaceSimilarityEvaluator(ta).embed_folder(paths)
    for g, w in zip(got, want):
        assert_close(g, w, atol=2e-5)
    (tmp_path / "a.jpg").write_bytes(b"\xff\xd8\xff")
    with pytest.raises(RuntimeError, match=r"\.jpg images needs PIL"):
        tpng.read_image(str(tmp_path / "a.jpg"))
    np.save(tmp_path / "b.npy", rng.integers(0, 256, (8, 8, 3), np.uint8))
    assert tpng.read_image(str(tmp_path / "b.npy")).shape == (8, 8, 3)
