"""The port's face-detection geometry (`eval/face_detect.py`) against the
JAX package's on the same inputs: the connected components of a parsing map
(on numpy, against `scipy.ndimage`), the landmarks from part centroids, the
similarity fit, the square crop, the warp against OpenCV's `warpAffine`
(which the JAX package calls here) and the parsing detector with an injected
parse map; and the image helpers the curation CLI needs without PIL: PIL's
BILINEAR resize in every PNG mode and the grey PNG writer."""

import io

import numpy as np
import pytest

from adaprompt_tpu.eval import face_detect as jfd
from adaprompt_tpu_torch.eval import face_detect as tfd
from adaprompt_tpu_torch.utils import png as tpng
from adaprompt_tpu_torch.utils.resize import pil_bilinear, pil_bilinear_rgb
from torch_port_helpers import torch_threads  # noqa: F401


def test_constants_match():
    np.testing.assert_array_equal(tfd.ARCFACE_TEMPLATE, jfd.ARCFACE_TEMPLATE)
    assert tfd.FACE_CLASSES == jfd.FACE_CLASSES and tfd.MOUTH_CLASSES == jfd.MOUTH_CLASSES
    names = [n for n in dir(jfd) if n.startswith("CLS_")]
    assert names and all(getattr(tfd, n) == getattr(jfd, n) for n in names)


def _diagonal_contacts():
    """Blobs that touch only at corners (one component under 8-connectivity,
    several under 4), two boxes of equal area, and 1-pixel speckle."""
    p = np.zeros((60, 70), np.int64)
    p[5:15, 5:15] = 1
    p[15:25, 15:25] = 10          # touches the first blob at a corner only
    p[30:40, 40:50] = 4           # same box area as the first
    p[2, 60] = 1                  # speckle
    p[50, 3] = 13
    for i in range(8):            # a diagonal staircase of single pixels
        p[45 + i, 55 + i] = 2
    return p


@pytest.mark.parametrize("case", range(8))
def test_face_components_match_scipy(case):
    """Bboxes and their order equal JAX's (`scipy.ndimage.label`, 4-connected):
    random masks at several densities (diagonal-only contacts, equal-area
    ties and speckle in abundance), the hand-built case, each speckle cut."""
    rng = np.random.default_rng(case)
    if case == 0:
        p = _diagonal_contacts()
    else:
        h, w = rng.integers(20, 90, 2)
        density = (0.2, 0.4, 0.5, 0.6, 0.75, 0.9, 0.3)[case - 1]
        p = (rng.random((h, w)) < density) * rng.integers(1, 19, (h, w))
    for frac in (0.0, 0.002, 0.01, 0.05):
        want = jfd.face_components(p, frac)
        assert tfd.face_components(p, frac) == want
    assert jfd.face_components(np.zeros((8, 8), np.int64)) == tfd.face_components(
        np.zeros((8, 8), np.int64)) == []


def test_face_components_tie_order_at_parse_size():
    """At 512x512 with many boxes of equal area, the stable order of JAX's
    sort (raster order of the components' first pixels) is kept."""
    p = np.zeros((512, 512), np.int64)
    rng = np.random.default_rng(3)
    for y, x in rng.integers(0, 480, (40, 2)):
        p[y:y + 24, x:x + 24] = rng.integers(1, 14)
    p[rng.random((512, 512)) < 0.01] = 1
    assert tfd.face_components(p) == jfd.face_components(p)
    assert tfd.face_components(p, 0.0) == jfd.face_components(p, 0.0)


def _synthetic_parsing(size=512, oy=300, ox=80):
    p = np.zeros((size, size), np.int64)
    p[oy:oy + 120, ox:ox + 120] = jfd.CLS_SKIN
    p[oy + 30:oy + 38, ox + 20:ox + 32] = jfd.CLS_L_EYE
    p[oy + 30:oy + 38, ox + 80:ox + 92] = jfd.CLS_R_EYE
    p[oy + 55:oy + 70, ox + 50:ox + 62] = jfd.CLS_NOSE
    p[oy + 85:oy + 95, ox + 35:ox + 80] = jfd.CLS_MOUTH
    return p


def _parsing_cases():
    base = _synthetic_parsing()
    glasses = base.copy()
    glasses[(glasses == jfd.CLS_L_EYE) | (glasses == jfd.CLS_R_EYE)] = jfd.CLS_GLASSES
    swapped = base.copy()                          # the parser's left/right flipped
    swapped[base == jfd.CLS_L_EYE], swapped[base == jfd.CLS_R_EYE] = jfd.CLS_R_EYE, jfd.CLS_L_EYE
    no_nose = base.copy()
    no_nose[no_nose == jfd.CLS_NOSE] = jfd.CLS_SKIN
    no_eyes = base.copy()
    no_eyes[(no_eyes == jfd.CLS_L_EYE) | (no_eyes == jfd.CLS_R_EYE)] = jfd.CLS_SKIN
    no_mouth = base.copy()
    no_mouth[no_mouth == jfd.CLS_MOUTH] = jfd.CLS_SKIN
    two = _synthetic_parsing(oy=40, ox=300)
    two[300:420, 80:200] = _synthetic_parsing()[300:420, 80:200]
    two[10:60, 10:60] = jfd.CLS_SKIN
    rng = np.random.default_rng(5)
    noisy = base.copy()
    noisy[rng.random(base.shape) < 0.05] = jfd.CLS_U_LIP
    return {"base": base, "glasses": glasses, "swapped": swapped, "no_nose": no_nose,
            "no_eyes": no_eyes, "no_mouth": no_mouth, "two": two, "noisy": noisy}


@pytest.mark.parametrize("name", list(_parsing_cases()))
def test_landmarks_match_jax(name):
    """Landmarks from part centroids, with the glasses split, the eyes
    reordered by x, the nose stand-in and the None cases."""
    p = _parsing_cases()[name]
    boxes = jfd.face_components(p)
    assert boxes
    for bbox in boxes:
        want = jfd.landmarks_from_parsing(p, bbox)
        got = tfd.landmarks_from_parsing(p, bbox)
        if want is None:
            assert got is None
        else:
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_umeyama_and_crop_square_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        src = rng.normal(size=(5, 2)) * rng.uniform(5, 80) + rng.uniform(-50, 300, 2)
        want = jfd.umeyama_similarity(src, jfd.ARCFACE_TEMPLATE)
        got = tfd.umeyama_similarity(src, tfd.ARCFACE_TEMPLATE)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    mirrored = np.array([[1.0, 0.0], [0.0, 1.0], [3.0, 2.0], [1.0, 4.0], [0.5, 0.5]])
    np.testing.assert_allclose(tfd.umeyama_similarity(mirrored, mirrored[:, ::-1]),
                               jfd.umeyama_similarity(mirrored, mirrored[:, ::-1]), atol=1e-12)
    img = rng.integers(0, 256, (200, 150, 3), dtype=np.uint8)
    for bbox in ((10, 20, 60, 90), (150, 100, 199, 149), (0, 0, 200, 150), (80, 70, 81, 71)):
        for size, margin in ((112, 0.3), (37, 0.0), (64, 1.5)):
            np.testing.assert_array_equal(tfd.crop_square(img, bbox, size, margin),
                                          jfd.crop_square(img, bbox, size, margin))
    assert tfd.crop_square(img, (300, 300, 310, 310), 112) is None


def _warp_case(seed, leaves, h=200, w=180):
    """A seeded noise photo and a similarity onto the template whose crop
    stays inside the photo or leaves it."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    src = rng.uniform([40, 40], [w - 40, h - 40], (5, 2))
    if leaves:
        src = (src - src.mean(0)) * 0.4 + rng.uniform([-10, -10], [w + 10, h + 10])
    else:
        src = (src - src.mean(0)) * 0.25 + [w / 2, h / 2]
    return img, jfd.umeyama_similarity(src.astype(np.float32), jfd.ARCFACE_TEMPLATE)


@pytest.mark.parametrize("leaves", [False, True], ids=["inside", "leaves"])
@pytest.mark.parametrize("seed", range(4))
def test_warp_affine_bit_equal_to_cv2(seed, leaves):
    """The port's warp equals OpenCV's `warpAffine(INTER_LINEAR)` bit for
    bit: at 112 (whole 16-pixel blocks), at 45 and 100 (a row tail past the
    last block), and for a grey image; the crop that leaves the photo has
    pixels filled with 0 by both."""
    cv2 = pytest.importorskip("cv2")
    img, M = _warp_case(seed, leaves)
    for size in (112, 45, 100):
        want = cv2.warpAffine(img, M.astype(np.float32), (size, size), flags=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(tfd.warp_affine(img, M, size), want)
        np.testing.assert_array_equal(jfd.warp_affine(img, M, size), want)
    grey = img[..., 0].copy()
    np.testing.assert_array_equal(
        tfd.warp_affine(grey, M, 112),
        cv2.warpAffine(grey, M.astype(np.float32), (112, 112), flags=cv2.INTER_LINEAR))
    src_corners = np.array([[0, 0], [111, 0], [0, 111], [111, 111]], np.float64)
    inv = np.linalg.inv(np.vstack([M, [0, 0, 1]]))[:2]
    back = src_corners @ inv[:, :2].T + inv[:, 2]
    outside = ((back < 0) | (back > [img.shape[1] - 1, img.shape[0] - 1])).any()
    assert outside == leaves


def test_warp_affine_differs_from_jax_numpy_fallback():
    """JAX's numpy fallback (where cv2 is absent) truncates and clamps to the
    edge where OpenCV rounds and fills 0: the port follows OpenCV."""
    img, M = _warp_case(0, True)
    ours = tfd.warp_affine(img, M, 112)
    fallback = jfd.warp_affine_np(img, M, 112)
    assert (ours == 0).all(axis=-1).sum() > 100          # the zero border
    assert (fallback != ours).sum() > 1000


def _image_for(parsing, scale=2, seed=0):
    rng = np.random.default_rng(seed)
    h, w = parsing.shape
    return rng.integers(0, 256, (h * scale, w * scale - 24, 3), dtype=np.uint8)


@pytest.mark.parametrize("name", list(_parsing_cases()))
def test_parsing_detector_matches_jax(name):
    """`make_parsing_detector` with an injected parse map: the resize to
    the parser's size, the components, the aligned or fallback crops."""
    p = _parsing_cases()[name]
    img = _image_for(p, seed=len(name))
    seen = []

    def parse(batch):
        seen.append(batch.copy())
        return p[None]

    want = jfd.make_parsing_detector(parse, size=112)(img)
    got = tfd.make_parsing_detector(parse, size=112)(img)
    np.testing.assert_array_equal(seen[0], seen[1])
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    empty = tfd.make_parsing_detector(lambda b: np.zeros((1, 512, 512), np.int64))
    assert empty(img) == []


# -- PIL's BILINEAR resize and the grey PNG, without PIL ------------------------------

@pytest.mark.parametrize("shape", [(96, 80, 3), (700, 610, 3), (512, 512, 3), (300, 41),
                                   (1030, 777)])
def test_pil_bilinear_bit_equal_to_pil(shape):
    Image = pytest.importorskip("PIL.Image")
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    for out in ((512, 512), (77, 300)):
        want = np.asarray(Image.fromarray(img).resize(out[::-1], Image.BILINEAR))
        np.testing.assert_array_equal(pil_bilinear(img, *out), want)


def _png_modes(rng, h, w):
    from PIL import Image
    rgba = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    rgba[..., 3] = rng.choice([0, 7, 128, 200, 255], (h, w))
    return {"RGB": Image.fromarray(rgba[..., :3]), "L": Image.fromarray(rgba[..., 0]),
            "RGBA": Image.fromarray(rgba, "RGBA"), "LA": Image.fromarray(rgba[..., [0, 3]], "LA"),
            "P": Image.fromarray(rgba[..., :3]).convert("P"),
            "1": Image.fromarray(rgba[..., 0]).convert("1")}


@pytest.mark.parametrize("shape", [(96, 80), (700, 610)])
def test_resize_in_file_mode_bit_equal_to_pil(shape):
    """`pil_bilinear_rgb` of each PNG mode as `decode_png_mode` reads it
    equals PIL's open -> resize((512, 512), BILINEAR) -> convert("RGB")
    (the JAX gen_face_masks' order): premultiplied alpha for RGBA and LA,
    the nearest rule for P and 1."""
    Image = pytest.importorskip("PIL.Image")
    for mode, im in _png_modes(np.random.default_rng(shape[0]), *shape).items():
        buf = io.BytesIO()
        im.save(buf, format="PNG")
        data = buf.getvalue()
        want = np.asarray(Image.open(io.BytesIO(data)).resize((512, 512), Image.BILINEAR)
                          .convert("RGB"))
        got_mode, px, palette = tpng.decode_png_mode(data)
        assert got_mode == Image.open(io.BytesIO(data)).mode == mode
        np.testing.assert_array_equal(pil_bilinear_rgb(got_mode, px, 512, 512, palette), want,
                                      err_msg=mode)
        np.testing.assert_array_equal(tpng.decode_png(data),
                                      np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


def test_grey_png_decoded_by_pil(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(0)
    mask = (rng.random((67, 45)) < 0.5).astype(np.uint8) * 255
    grey = rng.integers(0, 256, (30, 31), dtype=np.uint8)
    for name, img in (("mask.png", mask), ("grey.png", grey)):
        path = tpng.write_png(str(tmp_path / name), img)
        with Image.open(path) as im:
            assert im.mode == "L"
            np.testing.assert_array_equal(np.asarray(im), img)
        mode, px, _ = tpng.read_png_mode(path)
        assert mode == "L"
        np.testing.assert_array_equal(px, img)
    with pytest.raises(ValueError, match="uint8"):
        tpng.encode_png(np.zeros((4, 4, 2), np.uint8))
