"""The port's ArcFace trunk and face embedder against the JAX package on
shared weights (a reduced IResNet-18, CPU, float32): the forward, the
checkpoint key maps (arcface_torch state dicts and .onnx initializers),
preprocessing and cosine similarity, `FaceSimilarityEvaluator` with the
centre-crop detector, and `calc_faces_mean_similarity`."""

import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaprompt_tpu.eval import face_eval as jfe
from adaprompt_tpu.models import arcface as jaf
from adaprompt_tpu_torch import convert
from adaprompt_tpu_torch.eval import face_eval as tfe
from adaprompt_tpu_torch.models import arcface as taf
from adaprompt_tpu_torch.models import bisenet as tbisenet
from adaprompt_tpu_torch.utils.onnx_port import read_onnx_initializers
from test_onnx_port import _model as onnx_model
from torch_port_helpers import arcface_pair, assert_close
from torch_port_helpers import torch_threads  # noqa: F401

SMALL = dict(layers=(2, 2, 2, 2), planes=(8, 16, 32, 64), num_features=64, input_size=32)


@pytest.fixture(scope="module")
def trunks():
    return arcface_pair(0, **SMALL)


def test_configs_match():
    for name in ("IRESNET100", "IRESNET50", "IRESNET18"):
        j, t = getattr(jaf, name), getattr(taf, name)
        assert (j.layers, j.planes, j.num_features, j.input_size, j.bn_eps) == \
            (t.layers, t.planes, t.num_features, t.input_size, t.bn_eps)


def test_forward_matches_jax(trunks):
    """Every BatchNorm carries non-trivial running statistics and every
    PReLU its own slopes; strides 2 and 1, with and without the downsample
    branch. <= 1e-4 of the largest embedding value."""
    jp, jcfg, model = trunks
    x = np.random.default_rng(1).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jaf.forward(jp, jnp.asarray(x), jcfg))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (3, 64) and np.abs(want).max() > 0.1
    assert_close(got, want, atol=1e-4 * np.abs(want).max())


def test_preprocess_and_cosine_similarity():
    img = np.random.default_rng(2).integers(0, 256, (2, 32, 32, 3)).astype(np.uint8)
    np.testing.assert_array_equal(taf.preprocess(img), jaf.preprocess(img))
    a = np.asarray([[3.0, 0.0], [0.0, 2.0], [1.0, 1.0]], np.float32)
    b = np.asarray([[1.0, 0.0], [0.0, -5.0], [2.0, 0.5]], np.float32)
    np.testing.assert_array_equal(
        taf.cosine_similarity(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jaf.cosine_similarity(jnp.asarray(a), jnp.asarray(b))))


def _arcface_torch_state_dict(cfg, seed):
    """A synthetic state dict in the public arcface_torch iresnet layout."""
    rng = np.random.default_rng(seed)
    sd = {}
    rn = lambda *s: rng.standard_normal(s).astype(np.float32)

    def bn(p, c):
        sd[p + ".weight"], sd[p + ".bias"] = 1 + 0.1 * rn(c), 0.1 * rn(c)
        sd[p + ".running_mean"], sd[p + ".running_var"] = 0.5 * rn(c), 0.5 + np.abs(rn(c))
        sd[p + ".num_batches_tracked"] = np.asarray(7, np.int64)

    sd["conv1.weight"] = 0.2 * rn(64, 3, 3, 3)
    bn("bn1", 64)
    sd["prelu.weight"] = 0.25 + 0.05 * rn(64)
    cin = 64
    for si, (n, cout) in enumerate(zip(cfg.layers, cfg.planes), start=1):
        for bi in range(n):
            p = f"layer{si}.{bi}"
            bn(p + ".bn1", cin)
            sd[p + ".conv1.weight"] = 0.1 * rn(cout, cin, 3, 3)
            bn(p + ".bn2", cout)
            sd[p + ".prelu.weight"] = 0.25 + 0.05 * rn(cout)
            sd[p + ".conv2.weight"] = 0.1 * rn(cout, cout, 3, 3)
            bn(p + ".bn3", cout)
            if bi == 0:
                sd[p + ".downsample.0.weight"] = 0.2 * rn(cout, cin, 1, 1)
                bn(p + ".downsample.1", cout)
            cin = cout
    bn("bn2", cin)
    sp = cfg.input_size // 16
    sd["fc.weight"], sd["fc.bias"] = 0.05 * rn(cfg.num_features, cin * sp * sp), 0.1 * rn(cfg.num_features)
    bn("features", cfg.num_features)
    return sd


def test_from_torch_and_from_onnx_match_the_jax_maps(tmp_path):
    """The port's key maps give the state dict that the JAX maps give after
    `convert.from_jax_params`, value for value, from a synthetic
    arcface_torch checkpoint and from an .onnx file holding it; it loads
    strictly, and the loaded model agrees with the JAX forward."""
    jcfg, tcfg = jaf.IResNetConfig(**SMALL), taf.IResNetConfig(**SMALL)
    sd = _arcface_torch_state_dict(tcfg, 5)
    jp = jaf.from_torch(sd, jcfg)
    want = convert.from_jax_params(jax.tree.map(np.asarray, jp))
    got = taf.from_torch({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, tcfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    path = tmp_path / "glintr.onnx"
    path.write_bytes(onnx_model({k: v for k, v in sd.items() if v.ndim}))
    assert set(read_onnx_initializers(str(path))) == {k for k, v in sd.items() if v.ndim}
    from_onnx = taf.from_onnx(str(path), tcfg)
    jp_onnx = convert.from_jax_params(jax.tree.map(np.asarray, jaf.from_onnx(str(path), jcfg)))
    for k in want:
        np.testing.assert_array_equal(from_onnx[k].numpy(), jp_onnx[k].numpy(), err_msg=k)
    model = taf.ArcFace(tcfg, device="cpu")
    model.load_state_dict(from_onnx, strict=True)
    x = np.random.default_rng(6).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jaf.forward(jp, jnp.asarray(x), jcfg))
    with torch.no_grad():
        assert_close(model(torch.from_numpy(x)), ref, atol=1e-4 * np.abs(ref).max())
    renamed = tmp_path / "renamed.onnx"
    renamed.write_bytes(onnx_model({"683": sd["conv1.weight"]}))
    with pytest.raises(ValueError, match="arcface_torch module names"):
        taf.from_onnx(str(renamed), tcfg)


def test_random_init_is_seeded_and_defaults_to_cuda():
    cfg = taf.IResNetConfig(**SMALL)
    a, b, c = (taf.ArcFace.random_init(s, cfg, device="cpu") for s in (3, 3, 4))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["conv1.weight"], sc["conv1.weight"])
    assert torch.equal(sa["bn1.running_var"], torch.ones(64)) and float(sa["prelu.alpha"][0]) == 0.25
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        emb = a(x)
    assert emb.shape == (1, 64) and torch.isfinite(emb).all() and emb.std() > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            taf.ArcFace.random_init(0, cfg)


def _photos(seed, n, h=48, w=40):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h + 4 * i, w + 6 * i, 3)).astype(np.uint8) for i in range(n)]


def test_face_similarity_evaluator_matches_jax(trunks):
    jp, jcfg, model = trunks
    photos = _photos(0, 3)
    for im in photos:
        (cj,), (ct,) = jfe.center_crop_detector(im, 32), tfe.center_crop_detector(im, 32)
        np.testing.assert_array_equal(ct, cj)
    crop32 = lambda im: jfe.center_crop_detector(im, 32)
    jev = jfe.FaceSimilarityEvaluator(jp, jcfg, detector=crop32)
    tev = tfe.FaceSimilarityEvaluator(model)            # the default detector, at the trunk's size
    for im in photos:
        ej, et = jev.embed_image(im), tev.embed_image(im)
        assert et.shape == (1, 64) and et.dtype == np.float32
        np.testing.assert_allclose(et, ej, atol=1e-4)
        np.testing.assert_allclose(np.linalg.norm(et, axis=-1), 1.0, atol=1e-6)
    np.testing.assert_allclose(tev(images_np=photos), jev(images_np=photos), atol=1e-4)
    none = tfe.FaceSimilarityEvaluator(model, detector=lambda im: [])
    assert none.embed_image(photos[0]).shape == (0, 64) and none(images_np=photos) is None


def test_make_detector(monkeypatch, tmp_path):
    monkeypatch.delenv("ADAPROMPT_RETINAFACE_CKPT", raising=False)
    monkeypatch.delenv("ADAPROMPT_BISENET_CKPT", raising=False)
    im = _photos(1, 1)[0]
    for spec in (None, "center_crop"):
        np.testing.assert_array_equal(tfe.make_detector(spec)(im)[0],
                                      jfe.center_crop_detector(im)[0])
    # the RetinaFace and BiSeNet specs load their model onto CUDA unless told
    # otherwise, and read the file named; a cascade file cv2 cannot load raises
    for spec in ("retinaface:x.pth", "bisenet:y.pth"):
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                tfe.make_detector(spec)
        with pytest.raises(FileNotFoundError):
            tfe.make_detector(spec, device="cpu")
    if importlib.util.find_spec("cv2") is not None:
        import cv2
        with pytest.raises(ValueError if hasattr(cv2, "CascadeClassifier") else RuntimeError,
                           match="could not load cascade|no CascadeClassifier"):
            tfe.make_detector("cascade:z.xml")
    with pytest.raises(ValueError, match="unknown detector"):
        tfe.make_detector("mtcnn")
    ckpt = tmp_path / "79999_iter.pth"
    ckpt.write_bytes(b"")
    monkeypatch.setenv("ADAPROMPT_BISENET_CKPT", str(ckpt))
    loads = []
    monkeypatch.setattr(tbisenet, "load", lambda path, **kw: loads.append((path, kw)) or 1 / 0)
    with pytest.raises(ZeroDivisionError):
        tfe.make_detector(None, device="cpu")
    assert loads == [(str(ckpt), {"device": "cpu"})]


def test_calc_faces_mean_similarity_matches_jax():
    rng = np.random.default_rng(4)

    def embs(n):
        e = rng.standard_normal((n, 16)).astype(np.float32)
        return e / np.linalg.norm(e, axis=-1, keepdims=True) if n else e

    src = [embs(1), embs(0), embs(2)]
    dst = [embs(2), embs(1), embs(0), embs(0)]
    assert tfe.calc_faces_mean_similarity(src, dst) == jfe.calc_faces_mean_similarity(src, dst)
    assert tfe.calc_faces_mean_similarity([embs(0)], dst) == (0.0, 1, 2)
