"""The port's face detectors against the JAX package's on shared weights
(CPU, float32, full widths): BiSeNet (`models/bisenet.py`) from the
independent torch construction of `tests/test_bisenet.py` and from the
`79999_iter.pth` layout that `tools/reference_layouts.py` writes, RetinaFace
(`models/retinaface.py`) from the `Resnet50_Final.pth` layout and from a
hand-encoded ONNX file, both through `convert.from_jax_params` on JAX's
`init_params` trees; anchors, decoding, NMS and `detect_faces`; the
detectors behind `make_detector`'s specs. Every written BatchNorm carries
random running statistics, so folding and applying them is no identity.
The card-only tests of the detectors (the card's fp32 against the CPU at
ragged photo sizes) are in `tests/test_torch_port_rules.py`, which the
card's machine can import without jax."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaprompt_tpu.eval import face_detect as jfd
from adaprompt_tpu.eval import face_eval as jfe
from adaprompt_tpu.models import bisenet as jbis
from adaprompt_tpu.models import retinaface as jrf
from adaprompt_tpu_torch import convert
from adaprompt_tpu_torch.eval import face_detect as tfd
from adaprompt_tpu_torch.eval import face_eval as tfe
from adaprompt_tpu_torch.models import bisenet as tbis
from adaprompt_tpu_torch.models import retinaface as trf
from test_onnx_port import _model as onnx_model
from torch_port_helpers import numpy_random_normal
from torch_port_helpers import torch_threads  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import reference_layouts as rl  # noqa: E402

DET = 128          # JAX's own RetinaFace tests' canvas
SMALL_RF = dict(stage_planes=(32, 64, 128, 256), fpn_out=32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _numpy(sd):
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in sd.items()}


def _load(module, state):
    module.load_state_dict(state, strict=True)
    return module.eval()


# -- BiSeNet -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def bisenet_ref():
    """(torch reference net with random BN statistics, its state dict, JAX
    params, the port's model) from test_bisenet's independent construction."""
    import test_bisenet as tb
    torch.manual_seed(0)
    net = tb.BiSeNet().eval()
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.05)
                m.running_var.uniform_(0.6, 1.4)
    sd = net.state_dict()
    return net, sd, jbis.from_torch(sd), _load(tbis.BiSeNet(device="cpu"), tbis.from_torch(sd))


def test_bisenet_config_matches():
    assert (tbis.BISENET_FACE.n_classes, tbis.BISENET_FACE.input_size) == \
        (jbis.BISENET_FACE.n_classes, jbis.BISENET_FACE.input_size)


def test_bisenet_forward_matches_torch_and_jax(bisenet_ref):
    """At full widths on 64x64 inputs: against the torch construction and
    JAX's forward of its `from_torch`, 2e-4 abs / 1e-3 rel (JAX's own test's
    bound)."""
    net, _, jp, model = bisenet_ref
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        ref = net(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy().transpose(0, 2, 3, 1)
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(jbis.forward(jp, jnp.asarray(x)))
    assert got.shape == (2, 64, 64, 19) and np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_bisenet_preprocess_and_labels_match_jax(bisenet_ref):
    """`preprocess` bit-equal; `parse_faces` labels equal to JAX's wherever
    JAX's top-two logits differ by more than 1e-4 (the near-ties counted)."""
    _, _, jp, model = bisenet_ref
    imgs = np.random.default_rng(1).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tbis.preprocess(imgs), jbis.preprocess(imgs))
    got = tbis.parse_faces(model, list(imgs))
    want = jbis.parse_faces(jp, list(imgs))
    logits = np.sort(np.asarray(jbis.forward(jp, jnp.asarray(jbis.preprocess(imgs)))), axis=-1)
    clear = logits[..., -1] - logits[..., -2] > 1e-4
    assert got.shape == want.shape == (2, 64, 64) and clear.mean() > 0.99
    np.testing.assert_array_equal(got[clear], want[clear])
    assert len(np.unique(want)) > 1


@pytest.fixture(scope="module")
def bisenet_written():
    """A random port BiSeNet written as a `79999_iter.pth` state dict with
    random BN statistics (and the auxiliary heads), read back by both
    `from_torch`s."""
    model = tbis.BiSeNet.random_init(4, device="cpu")
    sd = rl.bisenet_face_parsing(model, seed=5)
    return model, sd, jbis.from_torch(sd), _load(tbis.BiSeNet(device="cpu"), tbis.from_torch(sd))


def test_bisenet_layout_matches_jax(bisenet_written):
    """The published layout (no 1x1 biases, `num_batches_tracked`, the
    auxiliary heads) through both loaders; the written file computes what the
    model written computes."""
    model, sd, jp, loaded = bisenet_written
    assert "conv_out16.conv_out.weight" in sd and "ffm.conv1.bias" not in sd
    assert not torch.allclose(sd["cp.resnet.bn1.running_var"], torch.ones(64))
    x = np.random.default_rng(2).standard_normal((2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        got = loaded(torch.from_numpy(x)).numpy()
        mem = model(torch.from_numpy(x)).numpy()
    want = np.asarray(jbis.forward(jp, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    assert _rel(got, mem) < 1e-4


@pytest.fixture()
def numpy_normal():
    with numpy_random_normal():
        yield


def test_bisenet_from_jax_params(numpy_normal):
    """JAX's `init_params` tree (BN scale/bias/mean/var) -> from_jax_params
    -> the port's module, strict; the forwards agree."""
    jp = jax.tree.map(np.asarray, jbis.init_params(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(3)
    jp = jax.tree.map(lambda a: a + rng.uniform(0.0, 0.2, a.shape).astype(np.float32)
                      if a.ndim == 1 else a, jp)          # non-trivial BN and biases
    model = _load(tbis.BiSeNet(device="cpu"), convert.from_jax_params(jp))
    x = np.random.default_rng(4).standard_normal((2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(jbis.forward(jax.tree.map(jnp.asarray, jp), jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


# -- RetinaFace --------------------------------------------------------------------

@pytest.fixture(scope="module")
def retinaface_pair():
    """(JAX params, the port's model, the state dict) of one random port
    RetinaFace written as `Resnet50_Final.pth` keys (under 'module.') with
    random BN statistics, read back by both `from_torch`s; and the model
    written."""
    mem = trf.RetinaFace.random_init(6, device="cpu")
    sd = rl.retinaface_pytorch(mem, seed=7)
    return jrf.from_torch(_numpy(sd)), _load(trf.RetinaFace(device="cpu"), trf.from_torch(sd)), \
        sd, mem


def test_retinaface_config_matches():
    for f in ("stage_blocks", "stage_planes", "fpn_out", "strides", "min_sizes", "variances",
              "num_anchors"):
        assert getattr(trf.RETINAFACE_R50, f) == getattr(jrf.RETINAFACE_R50, f)


def test_retinaface_heads_match_jax(retinaface_pair):
    """At full widths on a 128 canvas: class logits, boxes and landmarks
    within 1e-4 relative L2 of JAX's; the loaded file computes what the
    model written computes (the folding of random statistics undone)."""
    jp, model, _, mem = retinaface_pair
    x = np.random.default_rng(0).normal(0.0, 60.0, (1, DET, DET, 3)).astype(np.float32)
    want = jrf.forward(jp, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        ref = mem(torch.from_numpy(x))
    n = sum(((DET + s - 1) // s) ** 2 * 2 for s in (8, 16, 32))
    for g, w, r, ch in zip(got, want, ref, (2, 4, 10)):
        assert tuple(g.shape) == (1, n, ch)
        assert _rel(g.numpy(), w) <= 1e-4
        assert _rel(r.numpy(), w) <= 1e-4


def test_retinaface_key_spellings(retinaface_pair):
    """Without the 'module.' prefix and with `conv7X7_3` spelled so, both
    loaders give the same weights."""
    _, _, sd, _ = retinaface_pair
    plain = {k[len("module."):].replace("conv7x7_3", "conv7X7_3"): v for k, v in sd.items()}
    a, b = trf.from_torch(sd), trf.from_torch(plain)
    assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)
    ja, jb = jrf.from_torch(_numpy(sd)), jrf.from_torch(_numpy(plain))
    np.testing.assert_array_equal(ja["ssh"][2]["conv7x7_3"]["scale"],
                                  jb["ssh"][2]["conv7x7_3"]["scale"])
    np.testing.assert_array_equal(a["ssh.2.conv7x7_3.scale"].numpy(),
                                  ja["ssh"][2]["conv7x7_3"]["scale"])
    np.testing.assert_array_equal(a["stem.shift"].numpy(), ja["stem"]["shift"])


def test_priors_decode_nms_match_jax():
    for h, w in ((DET, DET), (640, 640), (100, 77)):
        np.testing.assert_array_equal(trf.priors(h, w), jrf.priors(h, w))
    rng = np.random.default_rng(1)
    pri = trf.priors(DET, DET)
    loc = rng.normal(0, 1, (len(pri), 4)).astype(np.float32)
    ldm = rng.normal(0, 1, (len(pri), 10)).astype(np.float32)
    np.testing.assert_array_equal(trf.decode_boxes(loc, pri), jrf.decode_boxes(loc, pri))
    np.testing.assert_array_equal(trf.decode_landms(ldm, pri), jrf.decode_landms(ldm, pri))
    boxes = jrf.decode_boxes(loc, pri)
    for scores in (rng.random(len(pri)).astype(np.float32),
                   rng.choice([0.6, 0.7, 0.9], len(pri)).astype(np.float32)):   # many ties
        for thr in (0.1, 0.4, 0.7):
            assert trf.nms(boxes, scores, thr) == jrf.nms(boxes, scores, thr)


def test_detect_faces_matches_jax(retinaface_pair):
    """`detect_faces` on a 200x160 photo: the canvas bit-equal, the same
    detections in the same order, scores within 1e-4, boxes and landmarks
    within 1e-2 pixels."""
    jp, model, _, _ = retinaface_pair
    img = np.random.default_rng(1).integers(0, 256, (200, 160, 3), dtype=np.uint8)
    canvas, scale = trf.canvas(img, DET)
    assert scale == DET / 200 and canvas.shape == (DET, DET, 3)
    for thr in (0.5, 0.9):
        want = jrf.detect_faces(jp, img, det_size=DET, score_thresh=thr)
        got = trf.detect_faces(model, img, det_size=DET, score_thresh=thr)
        assert len(want[1]) > 0 and [len(g) for g in got] == [len(w) for w in want]
        np.testing.assert_allclose(got[1], want[1], atol=1e-4)
        np.testing.assert_allclose(got[0], want[0], atol=1e-2)
        np.testing.assert_allclose(got[2], want[2], atol=1e-2)
        assert (got[0][:, [0, 2]] <= 160).all() and (got[0][:, [1, 3]] <= 200).all()


def test_retinaface_from_onnx(tmp_path):
    """An ONNX file (hand-encoded, as test_onnx_port builds one) holding a
    reduced-width model's initializers under the torch names: both
    `from_onnx`s equal `from_torch` of the same tensors; an export without
    those names raises in both."""
    cfg_t, cfg_j = trf.RetinaFaceConfig(**SMALL_RF), jrf.RetinaFaceConfig(**SMALL_RF)
    mem = trf.RetinaFace.random_init(8, cfg_t, device="cpu")
    sd = {k: v.numpy() for k, v in rl.retinaface_pytorch(mem, seed=9, prefix="").items()
          if v.dtype == torch.float32}
    path = tmp_path / "retinaface.onnx"
    path.write_bytes(onnx_model(sd))
    got, want = trf.from_onnx(str(path), cfg_t), trf.from_torch(sd, cfg_t)
    assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in got)
    jp = jrf.from_onnx(str(path), cfg_j)
    model = _load(trf.RetinaFace(cfg_t, device="cpu"), got)
    x = np.random.default_rng(3).normal(0, 60, (1, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    for g, w in zip(out, jrf.forward(jp, jnp.asarray(x), cfg_j)):
        assert _rel(g.numpy(), w) <= 1e-4
    bad = tmp_path / "other.onnx"
    bad.write_bytes(onnx_model({"backbone.weight": np.zeros((2, 2), np.float32)}))
    with pytest.raises(ValueError, match="Pytorch_Retinaface"):
        trf.from_onnx(str(bad))
    with pytest.raises(ValueError, match="Pytorch_Retinaface"):
        jrf.from_onnx(str(bad))


def test_retinaface_from_jax_params(numpy_normal):
    """JAX's `init_params` tree (folded kernel/scale/shift, head bias) ->
    from_jax_params -> the port's module, strict; the heads agree."""
    cfg_t, cfg_j = trf.RetinaFaceConfig(**SMALL_RF), jrf.RetinaFaceConfig(**SMALL_RF)
    jp = jax.tree.map(np.asarray, jrf.init_params(jax.random.PRNGKey(5), cfg_j))
    rng = np.random.default_rng(5)
    jp = jax.tree.map(lambda a: a + rng.uniform(-0.2, 0.2, a.shape).astype(np.float32)
                      if a.ndim == 1 else a, jp)
    state = convert.from_jax_params(jp)
    assert "stem.scale" in state and "stem.shift" in state and "stem.weight" in state
    model = _load(trf.RetinaFace(cfg_t, device="cpu"), state)
    x = np.random.default_rng(6).normal(0, 60, (1, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    for g, w in zip(out, jrf.forward(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), cfg_j)):
        assert _rel(g.numpy(), w) <= 1e-4


# -- make_detector -----------------------------------------------------------------

@pytest.fixture(scope="module")
def weight_files(tmp_path_factory, retinaface_pair, bisenet_written):
    d = tmp_path_factory.mktemp("detectors")
    files = {"retinaface": str(d / "Resnet50_Final.pth"), "bisenet": str(d / "79999_iter.pth"),
             "onnx": str(d / "retinaface.onnx")}
    torch.save(retinaface_pair[2], files["retinaface"])
    torch.save(bisenet_written[1], files["bisenet"])
    plain = {k[len("module."):]: v.numpy() for k, v in retinaface_pair[2].items()
             if v.dtype == torch.float32}
    with open(files["onnx"], "wb") as f:
        f.write(onnx_model(plain))
    return files


def test_make_detector_retinaface_matches_jax(weight_files):
    """'retinaface:<pth>' and 'retinaface:<onnx>': the crops of the port's
    detector against JAX's on one photo at the 640 canvas: as many faces,
    each crop within 1 level of JAX's (cv2's warp of landmarks that differ
    in their last bits)."""
    img = np.random.default_rng(2).integers(0, 256, (240, 200, 3), dtype=np.uint8)
    want = jfe.make_detector("retinaface:" + weight_files["retinaface"])(img)
    assert len(want) > 0
    for key in ("retinaface", "onnx"):
        got = tfe.make_detector(f"retinaface:{weight_files[key]}", device="cpu")(img)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == (112, 112, 3) and g.dtype == np.uint8
            d = np.abs(g.astype(int) - w)
            assert d.max() <= 1 and (d > 0).mean() < 0.05


def test_make_detector_bisenet_matches_jax(weight_files, monkeypatch):
    """'bisenet:<pth>': the labels at 512 equal JAX's away from near-ties,
    then the same crops (one photo; `parse_faces` of both packages)."""
    img = np.random.default_rng(3).integers(0, 256, (300, 260, 3), dtype=np.uint8)
    det = tfe.make_detector("bisenet:" + weight_files["bisenet"], device="cpu")
    jdet = jfe.make_detector("bisenet:" + weight_files["bisenet"])
    got, want = det(img), jdet(img)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_make_detector_routes_every_spec(weight_files, monkeypatch):
    """None follows $ADAPROMPT_RETINAFACE_CKPT, then $ADAPROMPT_BISENET_CKPT,
    then the centre crop; 'cascade:' needs cv2 (ModuleNotFoundError naming
    it when cv2 is missing); an unknown spec raises ValueError; the
    evaluator's default detector runs on the trunk's device."""
    img = np.random.default_rng(4).integers(0, 256, (150, 130, 3), dtype=np.uint8)
    monkeypatch.delenv("ADAPROMPT_RETINAFACE_CKPT", raising=False)
    monkeypatch.delenv("ADAPROMPT_BISENET_CKPT", raising=False)
    crop = tfe.make_detector(None)(img)
    np.testing.assert_array_equal(crop[0], jfe.center_crop_detector(img)[0])
    monkeypatch.setenv("ADAPROMPT_BISENET_CKPT", weight_files["bisenet"])
    monkeypatch.setenv("ADAPROMPT_RETINAFACE_CKPT", weight_files["retinaface"])
    calls = []
    real_load = trf.load
    monkeypatch.setattr(trf, "load", lambda *a, **k: calls.append(k) or real_load(*a, **k))
    det = tfe.make_detector(None, device="cpu")
    assert calls == [{"device": "cpu"}] and isinstance(det(img), list)
    monkeypatch.setenv("ADAPROMPT_RETINAFACE_CKPT", "/no/such/file.pth")
    called = []
    real_bis = tbis.load
    monkeypatch.setattr(tbis, "load", lambda *a, **k: called.append(a) or real_bis(*a, **k))
    tfe.make_detector(None, device="cpu")
    assert called == [(weight_files["bisenet"],)]
    from adaprompt_tpu_torch.models import arcface as taf
    from adaprompt_tpu_torch.models.arcface import IResNetConfig
    trunk = taf.ArcFace.random_init(0, IResNetConfig(layers=(1, 1, 1, 1), planes=(8, 16, 32, 64),
                                                     num_features=32), device="cpu")
    called.clear()
    tfe.FaceSimilarityEvaluator(trunk)
    assert called == [(weight_files["bisenet"],)]
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ModuleNotFoundError, match="cv2"):
        tfe.make_detector("cascade:/any/cascade.xml")
    with pytest.raises(ValueError, match="unknown detector spec"):
        tfe.make_detector("retina:x")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tfe.make_detector("retinaface:" + weight_files["retinaface"])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tfe.make_detector("bisenet:" + weight_files["bisenet"])


def _cascade_xml():
    cv2 = pytest.importorskip("cv2")
    if not hasattr(cv2, "CascadeClassifier"):
        pytest.skip(f"cv2 {cv2.__version__} has no CascadeClassifier (OpenCV 5 moved it out)")
    folder = getattr(getattr(cv2, "data", None), "haarcascades", "") or ""
    path = os.path.join(folder, "haarcascade_frontalface_default.xml")
    if not os.path.exists(path):
        pytest.skip("this cv2 ships no cascade XML (haarcascade_frontalface_default.xml)")
    return path


def test_cascade_detector_matches_jax():
    """With cv2 and a cascade file, the port's wrapper of cv2's detector
    gives JAX's crops."""
    path = _cascade_xml()
    img = np.random.default_rng(5).integers(0, 256, (200, 180, 3), dtype=np.uint8)
    got = tfe.make_detector("cascade:" + path)(img)
    want = jfe.make_detector("cascade:" + path)(img)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
