"""The port's DINO ViT against the JAX package's (tiny ViT on shared weights,
CPU, float32): encode, preprocess (shrinking and growing), from_torch on a
transformers ViTModel layout, the DINO evaluator, jax's triangle resize
weights; the object (DINO) branch of the SubjBasisGenerator and the DINO
features of ZeroShotFeatureExtractor."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaprompt_tpu.adaface import subj_basis_generator as jsbg, zs_features as jzs
from adaprompt_tpu.eval import dino_eval as jdev
from adaprompt_tpu.models import clip_vision as jcv, dino as jdino
from adaprompt_tpu_torch.adaface import subj_basis_generator as tsbg, zs_features as tzs
from adaprompt_tpu_torch.adaface.checkpoint import module_tree
from adaprompt_tpu_torch.eval import dino_eval as tdev
from adaprompt_tpu_torch.models import clip_vision as tcv, dino as tdino
from adaprompt_tpu_torch.ops.layers import reset_parameters
from adaprompt_tpu_torch.utils import resize as tresize
from adaprompt_tpu_torch.utils.tokenizer import CLIPTokenizer as TorchTokenizer
from adaface_fixtures import build_word_vocab
from torch_port_helpers import (EVAL_CLIP_VISION, EVAL_VIT, _train_cfgs, dino_pair, named,
                                port_module, randomized, t)
from torch_port_helpers import torch_threads  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import reference_layouts as rl  # noqa: E402

ENC_TOL = 1e-4       # fp32, another summation order: of the largest entry of JAX's
PIXEL_TOL = 1e-5     # preprocess, absolute, in normalized units
FEAT_TOL = 1e-5      # extractor features and object-branch vectors: of the largest entry


@pytest.fixture(scope="module")
def vit():
    return dino_pair(0)


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def test_encode_matches_jax(vit):
    jp, jcfg, tm = vit
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = jdino.encode(jp, jnp.asarray(x), jcfg)
    with torch.no_grad():
        got = tm.encode(t(x))
    assert tuple(got.shape) == want.shape == (2, 64)
    _close(got, want, ENC_TOL)


@pytest.mark.parametrize("hw", [(256, 256), (100, 77)], ids=["shrink", "grow"])
def test_preprocess_matches_jax(hw):
    imgs = np.random.default_rng(3).integers(0, 256, (2, *hw, 3), np.uint8)
    want = jdino.preprocess(imgs, 224)
    got = tdino.preprocess(imgs, 224)
    assert tuple(got.shape) == want.shape == (2, 224, 224, 3)
    assert np.abs(got.numpy() - want).max() <= PIXEL_TOL


def test_from_torch_matches_jax(vit):
    """The ViTModel layout that tools/reference_layouts.py writes (its keys
    those of a transformers ViTModel) through both packages' from_torch:
    equal leaf for leaf, and the loaded model encodes as the one written."""
    from transformers import ViTConfig as HFViTConfig, ViTModel
    jp, jcfg, tm = vit
    sd = rl.vit_hf(tm)
    hf = ViTModel(HFViTConfig(image_size=32, patch_size=8, hidden_size=64, intermediate_size=128,
                              num_hidden_layers=2, num_attention_heads=4),
                  add_pooling_layer=False)
    assert sorted(k.removeprefix("vit.") for k in sd) == sorted(hf.state_dict())
    want = named(jdino.from_torch(sd, jcfg))
    got = tdino.from_torch(sd, tdino.ViTConfig(**EVAL_VIT))
    assert sorted(got) == sorted(want) == sorted(tm.state_dict())
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), v), k
    loaded = tdino.DINO(tdino.ViTConfig(**EVAL_VIT), device="cpu")
    loaded.load_state_dict(got, strict=True)
    x = t(np.random.default_rng(4).standard_normal((1, 32, 32, 3)))
    with torch.no_grad():
        assert torch.equal(loaded.encode(x), tm.encode(x))


def test_parameter_tree_round_trip(vit):
    """module_tree gives the JAX tree back leaf for leaf, and a fresh
    model's random init has the JAX init's layout: normal(0, 0.02) weights
    and embeddings, zero biases, unit norms."""
    jp, _, tm = vit
    assert sorted(named(module_tree(tm))) == sorted(named(jp))
    fresh = tdino.DINO.random_init(0, tdino.ViTConfig(**EVAL_VIT), device="cpu")
    assert sorted(named(module_tree(fresh))) == sorted(named(jp))
    assert abs(float(fresh.layers[0]["mlp"]["fc1"].weight.std()) - 0.02) < 2e-3
    assert abs(float(fresh.patch_embedding.weight.std()) - 0.02) < 2e-3
    assert not fresh.patch_embedding.bias.any() and bool((fresh.final_ln.weight == 1).all())


@pytest.mark.parametrize("norm", [True, False])
def test_evaluator_features_match_jax(vit, norm):
    jp, jcfg, tm = vit
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, (48, 40, 3), np.uint8) for _ in range(3)]
    want = jdev.DINOEvaluator(jp, jcfg).get_image_features(imgs, norm=norm)
    got = tdev.DINOEvaluator(tm).get_image_features(imgs, norm=norm)
    _close(got, want, ENC_TOL)
    if norm:
        np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("reduction", ["mean", "none"])
def test_evaluator_similarity_matches_jax(vit, reduction):
    jp, jcfg, tm = vit
    rng = np.random.default_rng(6)
    a = [rng.integers(0, 256, (48, 48, 3), np.uint8) for _ in range(2)]
    b = [rng.integers(0, 256, (48, 48, 3), np.uint8) for _ in range(3)]
    want = jdev.DINOEvaluator(jp, jcfg).image_pairwise_similarity(a, b, reduction)
    got = tdev.DINOEvaluator(tm).image_pairwise_similarity(a, b, reduction)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ENC_TOL)
    if reduction == "none":
        np.testing.assert_allclose(torch.diagonal(tdev.DINOEvaluator(tm).image_pairwise_similarity(
            a, a, "none")).numpy(), 1.0, atol=1e-5)


def test_evaluator_refuses_other_reductions(vit):
    img = [np.zeros((32, 32, 3), np.uint8)]
    with pytest.raises(NotImplementedError):
        jdev.DINOEvaluator(vit[0], vit[1]).image_pairwise_similarity(img, img, "diag")
    with pytest.raises(NotImplementedError):
        tdev.DINOEvaluator(vit[2]).image_pairwise_similarity(img, img, "diag")


def test_triangle_weights_match_jax():
    """jax.image.resize's "bilinear" weights a axis, shrinking (antialiased)
    and growing."""
    from jax._src.image import scale as jscale
    for n_in, n_out in ((512, 112), (600, 112), (77, 112), (112, 112), (48, 32)):
        want = jscale.compute_weight_mat(n_in, n_out, jnp.float32(n_out / n_in), jnp.float32(0),
                                         jscale._fill_triangle_kernel, True)
        np.testing.assert_allclose(tresize.triangle_weights(n_in, n_out), np.asarray(want),
                                   atol=1e-6, err_msg=f"{n_in}->{n_out}")


# -- the object branch and the extractor's DINO features ------------------------------

@pytest.fixture(scope="module")
def generators(tmp_path_factory):
    """The face-branch SubjBasisGenerator (tiny CLIP text trunk, output 576,
    DINO width 384) in both packages on the same weights, and one word
    vocabulary for both tokenizers."""
    d = tmp_path_factory.mktemp("vocab")
    jtok = build_word_vocab(d)
    ttok = TorchTokenizer.from_files(str(d / "vocab.json"), str(d / "merges.txt"))
    jt, tt, _, _ = _train_cfgs(jtok.eos_id)
    tcfg = tsbg.SubjBasisConfig(output_dim=tt.hidden_size, text_cfg=tt)
    jcfg = jsbg.SubjBasisConfig(output_dim=jt.hidden_size, text_cfg=jt)
    sbg = reset_parameters(tsbg.SubjBasisGenerator(tcfg), torch.Generator().manual_seed(0))
    tree = randomized(module_tree(sbg), 1)
    return jtok, ttok, jcfg, jax.tree.map(jnp.asarray, tree), port_module(
        tsbg.SubjBasisGenerator(tcfg), tree)


@pytest.mark.parametrize("scale", [1.0, 0.8])
def test_object_branch_matches_jax(generators, scale):
    """DINO embeddings [B, 384] -> [B, 16, 16, D] repeated over the layers; at
    out_id_embs_scale 0.8 blended with the pad embeddings that each package
    computes itself; no prompt embeddings."""
    jtok, ttok, jcfg, jp, sbg = generators
    raw = np.random.default_rng(7).standard_normal((2, 384)).astype(np.float32)
    want, jprompt = jsbg.forward(jp, jcfg, jtok, raw_id_embs=jnp.asarray(raw),
                                 out_id_embs_scale=scale, is_face=False)
    with torch.no_grad():
        got, prompt = sbg(ttok, raw_id_embs=t(raw), out_id_embs_scale=scale, is_face=False)
    assert jprompt is None and prompt is None
    assert tuple(got.shape) == want.shape == (2, 16, 16, 576)
    _close(got, want, FEAT_TOL)
    assert torch.equal(got[:, 0], got[:, 15])


def test_object_branch_needs_an_input(generators):
    jtok, ttok, jcfg, jp, sbg = generators
    with pytest.raises(ValueError, match="raw_id_embs"):
        jsbg.forward(jp, jcfg, jtok, is_face=False)
    with pytest.raises(ValueError, match="raw_id_embs"):
        sbg(ttok, is_face=False)


@pytest.fixture(scope="module")
def extractors(vit):
    """Both packages' ZeroShotFeatureExtractor over the tiny CLIP tower and
    the tiny ViT, on shared weights."""
    jdp, jdcfg, tdm = vit
    jvcfg = jcv.CLIPVisionConfig(**EVAL_CLIP_VISION)
    jv = randomized(jcv.init_params(jax.random.PRNGKey(8), jvcfg), 9)
    tv = port_module(tcv.CLIPVisionModel(tcv.CLIPVisionConfig(**EVAL_CLIP_VISION), device="cpu"),
                     jv)
    jx = jzs.ZeroShotFeatureExtractor(jax.tree.map(jnp.asarray, jv), jvcfg, dino_params=jdp,
                                      dino_cfg=jdcfg)
    return jx, tzs.ZeroShotFeatureExtractor(tv, dino=tdm)


@pytest.mark.parametrize("calc_avg", [False, True], ids=["per-image", "calc_avg"])
def test_extractor_dino_features_match_jax(extractors, calc_avg):
    """is_face=False over 48-pixel photos with fg masks: the CLIP features
    (the masks reach only them) and the DINO CLS embeddings, per image and
    averaged with the mean re-normalized."""
    jx, tx = extractors
    rng = np.random.default_rng(10)
    photos = [rng.integers(0, 256, (48, 48, 3), np.uint8) for _ in range(3)]
    masks = [np.zeros((48, 48), np.float32) for _ in range(3)]
    for i, m in enumerate(masks):
        m[8 + i:32, 4:28 + i] = 1.0
    fj, ij, nj = jx(photos, fg_masks=masks, is_face=False, calc_avg=calc_avg)
    with torch.no_grad():
        ft, it, nt = tx(photos, fg_masks=masks, is_face=False, calc_avg=calc_avg)
    assert nt == nj == 0
    assert tuple(it.shape) == ij.shape == ((1, 64) if calc_avg else (3, 64))
    _close(ft, fj, FEAT_TOL)
    _close(it, ij, FEAT_TOL)
    if calc_avg:
        np.testing.assert_allclose(it.norm(dim=-1).numpy(), 1.0, rtol=1e-6)
    else:       # the masks do not reach DINO
        _close(it, jdino.encode(jx.dino_params, jnp.asarray(jdino.preprocess(
            np.stack(photos), 32)), jx.dino_cfg), FEAT_TOL)
