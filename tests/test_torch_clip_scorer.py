"""The port's CLIPScorer vs the JAX package's (tiny text and vision towers on
shared weights, CPU, float32, one word vocabulary): text and image features
(normalized and not), the [-1, 1] -> [0, 1] antialiased bicubic resize of
images whose size differs from the tower's, image-image and text-image
similarities under every reduction, and evaluate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaprompt_tpu.eval import clip_scorer as jscorer
from adaprompt_tpu.models import clip_text as jclip, clip_vision as jcv
from adaprompt_tpu_torch.eval import clip_scorer as tscorer
from adaprompt_tpu_torch.models import clip_text as tclip, clip_vision as tcv
from adaprompt_tpu_torch.utils.tokenizer import CLIPTokenizer as TorchTokenizer
from adaface_fixtures import build_word_vocab
from torch_port_helpers import VOCAB, port_module, randomized

VISION = dict(image_size=32, patch_size=8, hidden_size=64, intermediate_size=128,
              num_layers=2, num_heads=4, projection_dim=32)
TEXT = dict(vocab_size=VOCAB, hidden_size=48, intermediate_size=96, num_layers=2, num_heads=4)
FEAT_TOL = 1e-5      # fp32, another summation order: of the largest entry
PIXEL_TOL = 1e-4     # the preprocessed pixels, in CLIP-normalized units
TEXTS = ["a photo of a person", "a cat in the park", "a face portrait of a person smiling"]


@pytest.fixture(scope="module")
def scorers(tmp_path_factory):
    d = tmp_path_factory.mktemp("vocab")
    jtok = build_word_vocab(d)
    ttok = TorchTokenizer.from_files(str(d / "vocab.json"), str(d / "merges.txt"))
    jtcfg = jclip.CLIPTextConfig(**TEXT, eos_token_id=jtok.eos_id)
    jvcfg = jcv.CLIPVisionConfig(**VISION)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    tree = {"text": randomized(jclip.init_params(k1, jtcfg), 1),
            "text_projection": np.asarray(jax.random.normal(k3, (48, 32)) * 0.02, np.float32),
            "vision": randomized(jcv.init_params(k2, jvcfg), 2)}
    jp = jscorer.CLIPScorerParams(text=jax.tree.map(jnp.asarray, tree["text"]),
                                  text_projection=jnp.asarray(tree["text_projection"]),
                                  vision=jax.tree.map(jnp.asarray, tree["vision"]))
    js = jscorer.CLIPScorer(jp, jtok, jtcfg, jvcfg)
    ts = port_module(tscorer.CLIPScorer(
        ttok, tclip.CLIPTextConfig(**TEXT, eos_token_id=ttok.eos_id),
        tcv.CLIPVisionConfig(**VISION), device="cpu"), tree)
    return js, ts


def _images(b, h, w, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, (b, h, w, 3)).astype(np.float32)


def _close(got, want, tol=FEAT_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("norm", [True, False])
def test_text_features_match_jax(scorers, norm):
    js, ts = scorers
    got = ts.get_text_features(TEXTS, norm=norm)
    want = js.get_text_features(TEXTS, norm=norm)
    assert tuple(got.shape) == want.shape == (3, 32)
    _close(got, want)


@pytest.mark.parametrize("hw", [(32, 32), (48, 48), (40, 56), (64, 24)],
                         ids=["same", "48", "40x56", "64x24-up"])
def test_image_features_match_jax(scorers, hw):
    """Images at the tower's size, and larger, non-square and upsampled ones
    through the antialiased resize: the preprocessed pixels and the
    features, normalized and not."""
    js, ts = scorers
    imgs = _images(2, *hw, seed=hw[0])
    _close(ts._preprocess(torch.from_numpy(imgs)), js._preprocess(jnp.asarray(imgs)),
           tol=PIXEL_TOL)
    for norm in (True, False):
        _close(ts.get_image_features(torch.from_numpy(imgs), norm=norm),
               js.get_image_features(jnp.asarray(imgs), norm=norm))


@pytest.mark.parametrize("reduction", ["mean", "diag", "diagmean", "none"])
def test_similarities_match_jax(scorers, reduction):
    """txt_to_img_similarity (one text and a list) and
    image_pairwise_similarity under each reduction."""
    js, ts = scorers
    a, b = _images(3, 48, 48, 1), _images(3, 32, 32, 2)
    _close(ts.txt_to_img_similarity(TEXTS, torch.from_numpy(a), reduction),
           js.txt_to_img_similarity(TEXTS, jnp.asarray(a), reduction))
    _close(ts.image_pairwise_similarity(torch.from_numpy(a), torch.from_numpy(b), reduction),
           js.image_pairwise_similarity(jnp.asarray(a), jnp.asarray(b), reduction))
    if reduction != "diag":
        _close(ts.txt_to_img_similarity(TEXTS[1], torch.from_numpy(a), reduction),
               js.txt_to_img_similarity(TEXTS[1], jnp.asarray(a), reduction))


def test_evaluate_matches_jax(scorers):
    js, ts = scorers
    gen, gt = _images(2, 48, 48, 3), _images(2, 48, 48, 4)
    got = ts.evaluate(torch.from_numpy(gen), torch.from_numpy(gt), "a photo of a * person")
    want = js.evaluate(jnp.asarray(gen), jnp.asarray(gt), "a photo of a * person")
    np.testing.assert_allclose(got, want, rtol=0, atol=FEAT_TOL)
    with pytest.raises(NotImplementedError):
        ts.txt_to_img_similarity(TEXTS, torch.from_numpy(gen), "max")


def test_random_init_on_the_cpu():
    """ViT-B/32's published widths by default; random_init seeds every
    weight (two scorers from one seed are equal) and makes it float32 on the
    device asked for, with no parameter needing a gradient."""
    cfg = (tclip.CLIPTextConfig(**TEXT), tcv.CLIPVisionConfig(**VISION))
    a = tscorer.CLIPScorer.random_init(3, None, *cfg, device="cpu")
    b = tscorer.CLIPScorer.random_init(3, None, *cfg, device="cpu")
    for (n, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert p.dtype == torch.float32 and torch.equal(p, q), n
    assert float(a.text_projection.std()) > 0.01
    assert not any(p.requires_grad for p in a.parameters())
    assert tscorer.CLIP_B32_TEXT == tclip.CLIPTextConfig(
        **{k: getattr(jscorer.CLIP_B32_TEXT, k) for k in ("vocab_size", "hidden_size",
                                                            "intermediate_size", "num_layers",
                                                            "num_heads", "max_positions")})
    assert tcv.CLIP_VIT_B32_VISION.patch_size == jcv.CLIP_VIT_B32_VISION.patch_size == 32
    feats = a.get_image_features(torch.zeros(1, 40, 40, 3))
    assert feats.shape == (1, 32) and torch.isfinite(feats).all()
