"""The port's CLIP vision tower and zero-shot features vs the JAX package
(tiny ViT, CPU, float32, same numpy-seeded inputs and weights): `encode`
with and without the fg mask (every hidden state, pooled, image_embeds),
`preprocess`'s antialiased bicubic resize, `extract_zs_clip_features` and
the ZeroShotFeatureExtractor (the zero image's features cached and reused,
calc_avg, face ids), and the parameter trees both ways."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaprompt_tpu.adaface import zs_features as jzs
from adaprompt_tpu.models import clip_vision as jcv
from adaprompt_tpu_torch import convert
from adaprompt_tpu_torch.adaface import zs_features as tzs
from adaprompt_tpu_torch.adaface.checkpoint import module_tree
from adaprompt_tpu_torch.models import clip_vision as tcv
from adaprompt_tpu_torch.utils import resize as tresize
from torch_port_helpers import named, port_module, randomized, t
from torch_port_helpers import torch_threads  # noqa: F401

VISION = dict(image_size=32, patch_size=8, hidden_size=64, intermediate_size=128,
              num_layers=2, num_heads=4, projection_dim=32)
VALUE_TOL = 1e-5     # fp32, another summation order: of the array's largest entry
PIXEL_TOL = 1e-4     # preprocess, in normalized units (bound stated for the resize)


@pytest.fixture(scope="module")
def vision():
    """The tiny tower in both packages, holding the same weights (zero
    biases re-randomized)."""
    jcfg = jcv.CLIPVisionConfig(**VISION)
    jp = randomized(jcv.init_params(jax.random.PRNGKey(1), jcfg), 2)
    tm = port_module(tcv.CLIPVisionModel(tcv.CLIPVisionConfig(**VISION), device="cpu"), jp)
    return jax.tree.map(jnp.asarray, jp), jcfg, tm


def _close(got, want, tol=VALUE_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _box_masks(b, size, seed):
    """[B, size, size, 1] float32: a random box each, in {0, 1}."""
    rng = np.random.default_rng(seed)
    m = np.zeros((b, size, size, 1), np.float32)
    for i in range(b):
        y0, x0 = rng.integers(0, size // 2, 2)
        m[i, y0:y0 + size // 2, x0:x0 + size // 3] = 1.0
    return m


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "fg-mask"])
def test_encode_matches_jax(vision, masked):
    """Every hidden state (the input of each layer, then the output), the
    last hidden state, pooled and image_embeds."""
    jp, jcfg, tm = vision
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    mask = _box_masks(2, 32, 4) if masked else None
    want = jcv.encode(jp, jnp.asarray(x), cfg=jcfg, output_hidden_states=True,
                      attn_mask=None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        got = tm.encode(t(x), attn_mask=None if mask is None else t(mask),
                        output_hidden_states=True)
    assert len(got["hidden_states"]) == len(want["hidden_states"]) == VISION["num_layers"] + 1
    for a, b in zip(got["hidden_states"], want["hidden_states"]):
        _close(a, b)
    for k in ("last_hidden_state", "pooled", "image_embeds"):
        assert tuple(got[k].shape) == want[k].shape, k
        _close(got[k], want[k])
    if masked:          # the soft +1 bias changes what the tower returns
        plain = jcv.encode(jp, jnp.asarray(x), cfg=jcfg)
        assert np.abs(np.asarray(plain["pooled"]) - np.asarray(want["pooled"])).max() > 1e-3


@pytest.mark.parametrize("hw,size", [((48, 48), 32), ((512, 512), 224), ((40, 56), 32)],
                         ids=["48to32", "512to224", "40x56to32"])
def test_preprocess_matches_jax(hw, size):
    """The antialiased Keys-cubic resize and the CLIP normalization, against
    jax.image.resize(..., "bicubic") through the JAX package's preprocess."""
    rng = np.random.default_rng(hw[0] + size)
    imgs = rng.integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    want = jcv.preprocess(imgs, size)
    got = tcv.preprocess(imgs, size)
    assert tuple(got.shape) == want.shape == (2, size, size, 3)
    assert np.abs(got.numpy() - want).max() <= PIXEL_TOL


def test_bicubic_weights_match_jax():
    """Each axis's weight matrix against jax's own, at the sizes above."""
    from jax._src.image import scale as jscale
    for n_in, n_out in ((48, 32), (512, 224), (56, 32), (32, 32), (16, 40)):
        want = jscale.compute_weight_mat(n_in, n_out, jnp.float32(n_out / n_in), jnp.float32(0),
                                         jscale._fill_keys_cubic_kernel, True)
        np.testing.assert_allclose(tresize.bicubic_weights(n_in, n_out), np.asarray(want),
                                   atol=1e-6, err_msg=f"{n_in}->{n_out}")


@pytest.mark.parametrize("masked", [True, False], ids=["fg-mask", "no-mask"])
def test_extract_zs_clip_features_matches_jax(vision, masked):
    """[B, 2S, D]: the fg pass and the bg pass, each minus the zero image's
    features and scaled by the patch mask; the zero image's features, and
    the result when they are given back (reused, not recomputed)."""
    jp, jcfg, tm = vision
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    # a mask at another resolution: bilinear to the pixel grid first
    mask = _box_masks(2, 48, 6) if masked else None
    feats_j, neg_j = jzs.extract_zs_clip_features(
        jp, jnp.asarray(x), None if mask is None else jnp.asarray(mask), jcfg)
    with torch.no_grad():
        feats_t, neg_t = tzs.extract_zs_clip_features(tm, t(x), None if mask is None else t(mask))
    s = jcv.CLIPVisionConfig(**VISION).seq_len
    assert tuple(feats_t.shape) == feats_j.shape == (2, 2 * s, VISION["hidden_size"])
    _close(feats_t, feats_j)
    _close(neg_t, neg_j)
    if masked:
        # the bg pass's CLS row is kept, its masked-out patches are zero
        assert np.abs(np.asarray(feats_j)[:, s]).max() > 0
        assert (np.abs(feats_t[:, s + 1:].numpy()).max(axis=-1) == 0).any()
    calls = []
    real = tm.encode
    tm.encode = lambda *a, **k: calls.append(a[0].shape) or real(*a, **k)
    try:
        with torch.no_grad():
            again, neg2 = tzs.extract_zs_clip_features(tm, t(x), None if mask is None else t(mask),
                                                       neg_features=neg_t)
    finally:
        tm.encode = real
    assert neg2 is neg_t and [c[0] for c in calls] == [2, 2]      # no zero-image pass
    np.testing.assert_array_equal(again.numpy(), feats_t.numpy())


class _StubEmbedder:
    """Face embedder stand-in: one face a photo, its embedding drawn from a
    seed made of the photo's pixels; no face in the photos listed."""

    def __init__(self, faceless=()):
        self.faceless, self.calls = set(faceless), 0

    def embed_image(self, image_np):
        self.calls += 1
        if self.calls - 1 in self.faceless:
            return np.zeros((0, 512), np.float32)
        rng = np.random.default_rng(int(np.asarray(image_np, np.int64).sum()))
        return rng.standard_normal((1, 512)).astype(np.float32)


@pytest.mark.parametrize("calc_avg", [False, True], ids=["per-image", "calc_avg"])
def test_extractor_matches_jax(vision, calc_avg):
    """uint8 photos (48 px, resized to the tower's 32) with fg masks through
    both extractors, twice (the zero image's features cached on the first
    call): the CLIP features and the face ids, per image and averaged with
    the id re-normalized."""
    jp, jcfg, tm = vision
    rng = np.random.default_rng(7)
    photos = [rng.integers(0, 256, (48, 48, 3), dtype=np.uint8) for _ in range(3)]
    masks = [m[..., 0] for m in _box_masks(3, 48, 8)]
    jx = jzs.ZeroShotFeatureExtractor(jp, jcfg, face_embedder=_StubEmbedder())
    tx = tzs.ZeroShotFeatureExtractor(tm, face_embedder=_StubEmbedder())
    for _ in range(2):
        fj, ij, nj = jx(photos, fg_masks=masks, calc_avg=calc_avg)
        with torch.no_grad():
            ft, it, nt = tx(photos, fg_masks=masks, calc_avg=calc_avg)
        assert nt == nj == 0
        assert tuple(ft.shape) == fj.shape and tuple(it.shape) == ij.shape
        _close(ft, fj)
        np.testing.assert_allclose(it.numpy(), np.asarray(ij), rtol=1e-6, atol=1e-6)
    assert tx._neg_features is not None
    if calc_avg:
        np.testing.assert_allclose(it.norm(dim=-1).numpy(), 1.0, rtol=1e-6)


def test_extractor_faceless_and_object_images(vision):
    """A faceless photo gets a random id (drawn from a torch.Generator,
    where the JAX package draws from a jax.random key: only the faced rows
    equal JAX's); with is_face=False and no DINO model both give the CLIP
    features and no ids (the DINO ids: tests/test_torch_dino.py)."""
    jp, jcfg, tm = vision
    rng = np.random.default_rng(9)
    photos = [rng.integers(0, 256, (32, 32, 3), dtype=np.uint8) for _ in range(3)]
    _, ij, nj = jzs.ZeroShotFeatureExtractor(jp, jcfg, face_embedder=_StubEmbedder({1}))(photos)
    with torch.no_grad():
        _, it, nt = tzs.ZeroShotFeatureExtractor(tm, face_embedder=_StubEmbedder({1}))(
            photos, gen=torch.Generator().manual_seed(3))
    assert nt == nj == 1
    np.testing.assert_allclose(it.numpy()[[0, 2]], np.asarray(ij)[[0, 2]], rtol=1e-6)
    assert np.isfinite(it.numpy()[1]).all() and it.numpy()[1].std() > 0.5
    fj, ij, _ = jzs.ZeroShotFeatureExtractor(jp, jcfg)(photos, is_face=False)
    with torch.no_grad():
        ft, it, _ = tzs.ZeroShotFeatureExtractor(tm)(photos, is_face=False)
    assert ij is None and it is None
    _close(ft, fj)


def test_vision_parameter_trees(vision):
    """from_jax_params maps the JAX tree onto the port's tower (strict, every
    parameter), module_tree gives it back leaf for leaf, and a fresh tower's
    random init has the JAX init's layout and scales."""
    jp, jcfg, tm = vision
    want = named(jp)
    got = {k: v.numpy() for k, v in tm.state_dict().items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    back = convert.from_jax_params(module_tree(tm))
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k].numpy(), want[k])
    fresh = tcv.CLIPVisionModel.random_init(0, tcv.CLIPVisionConfig(**VISION), device="cpu")
    init = named(jcv.init_params(jax.random.PRNGKey(0), jcfg))
    for k, v in fresh.state_dict().items():
        assert v.shape == init[k].shape, k
        if v.ndim >= 2 or k.endswith("embedding"):
            assert abs(v.std().item() - 0.02) < 0.005, k
        else:
            np.testing.assert_array_equal(v.numpy(), init[k])    # unit norms, zero biases
