"""The port's evaluation modules against the JAX package's (CPU): PSNR and
SSIM, the random-ArcFace perceptual cosine, the folder loaders (bit for bit,
with PIL hidden from the port), compare_folders over shared tiny CLIP, DINO
and IResNet-18 weights, the prompt sets and the subject metadata parser."""

import sys

import numpy as np
import pytest

from adaprompt_tpu.data import dataset as jdata
from adaprompt_tpu.eval import face_eval as jfe, harness as jharness
from adaprompt_tpu.eval import image_metrics as jmetrics, prompts as jprompts
from adaprompt_tpu.eval import subject_info as jinfo
from adaprompt_tpu.eval.dino_eval import DINOEvaluator as JDINOEvaluator
from adaprompt_tpu_torch.data import dataset as tdata
from adaprompt_tpu_torch.eval import face_eval as tfe, harness as tharness
from adaprompt_tpu_torch.eval import image_metrics as tmetrics, prompts as tprompts
from adaprompt_tpu_torch.eval import subject_info as tinfo
from adaprompt_tpu_torch.eval.dino_eval import DINOEvaluator as TDINOEvaluator
from adaprompt_tpu_torch.utils.png import write_png
from adaprompt_tpu_torch.utils.tokenizer import CLIPTokenizer as TorchTokenizer
from adaface_fixtures import build_word_vocab
from torch_port_helpers import arcface_pair, dino_pair, scorer_pair
from torch_port_helpers import torch_threads  # noqa: F401

METRIC_RTOL = 1e-12     # psnr and ssim: the same float64 numpy arithmetic
COSINE_TOL = 1e-4       # random_arcface_cosine, absolute (fp32 trunks)
SCORE_TOL = 1e-4        # compare_folders' scores, absolute
IRESNET18 = dict(layers=(2, 2, 2, 2))


def _pairs():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (2, 40, 36, 3)).astype(np.uint8)
    near = np.clip(a.astype(int) + rng.integers(-12, 13, a.shape), 0, 255).astype(np.uint8)
    far = rng.integers(0, 256, a.shape).astype(np.uint8)
    return {"near": (a, near), "far": (a, far), "same": (a, a.copy())}


@pytest.mark.parametrize("pair", ["near", "far", "same"])
def test_psnr_ssim_match_jax(pair):
    a, b = _pairs()[pair]
    for fn in ("psnr", "ssim"):
        want, got = getattr(jmetrics, fn)(a, b), getattr(tmetrics, fn)(a, b)
        if pair == "same" and fn == "psnr":
            assert got == want == float("inf")
            continue
        np.testing.assert_allclose(got, want, rtol=METRIC_RTOL, atol=0, err_msg=fn)
    assert tmetrics.ssim(a, b, win=5) == pytest.approx(jmetrics.ssim(a, b, win=5), rel=METRIC_RTOL)


@pytest.fixture(scope="module")
def iresnet18():
    return arcface_pair(3, **IRESNET18)


def test_random_arcface_cosine_matches_jax(iresnet18):
    """IResNet-18 on shared weights, two 512x512 batches shrunk to 112 by
    the antialiased triangle resize; a batch against itself reads 1."""
    jp, jcfg, tm = iresnet18
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, (2, 512, 512, 3)).astype(np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-40, 41, a.shape), 0, 255).astype(np.uint8)
    want = jmetrics.random_arcface_cosine(a, b, arcface_params=jp, small=True)
    got = tmetrics.random_arcface_cosine(a, b, arcface=tm, small=True)
    assert abs(got - want) <= COSINE_TOL and -1.0 <= got <= 1.0
    assert abs(tmetrics.random_arcface_cosine(a, a, arcface=tm) - 1.0) <= 1e-6


def test_random_arcface_cosine_random_weights():
    """Without weights: an IResNet-18 with random weights from the seed, on
    the device asked for (the same seed, the same weights)."""
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (1, 64, 64, 3)).astype(np.uint8)
    b = rng.integers(0, 256, (1, 64, 64, 3)).astype(np.uint8)
    got = [tmetrics.random_arcface_cosine(a, b, seed=1, small=True, device="cpu")
           for _ in range(2)]
    assert got[0] == got[1] and -1.0 <= got[0] < 1.0


def _write_photos(d):
    """PNGs of each kind the loaders meet: 512x512 and 600x560 RGB (the
    port's writer), 100x77 RGB, grey and RGBA (PIL's writer)."""
    from PIL import Image
    rng = np.random.default_rng(6)
    d.mkdir(exist_ok=True)
    paths = [write_png(str(d / "a.png"), rng.integers(0, 256, (512, 512, 3), np.uint8)),
             write_png(str(d / "b.png"), rng.integers(0, 256, (560, 600, 3), np.uint8))]
    for name, mode, shape in (("c", "RGB", (77, 100, 3)), ("d", "L", (300, 260)),
                              ("e", "RGBA", (130, 170, 4))):
        Image.fromarray(rng.integers(0, 256, shape, np.uint8), mode).save(d / f"{name}.png")
        paths.append(str(d / f"{name}.png"))
    return paths


def test_loaders_bit_equal_to_jax(tmp_path, monkeypatch):
    """load_images_uint8 and load_images_pm1 at 256 equal JAX's PIL-based
    loaders bit for bit, the port's with PIL hidden."""
    paths = _write_photos(tmp_path)
    want_u8 = jharness.load_images_uint8(paths)
    want_pm1 = jharness.load_images_pm1(paths)
    monkeypatch.setitem(sys.modules, "PIL", None)
    got_u8 = tharness.load_images_uint8(paths)
    got_pm1 = tharness.load_images_pm1(paths)
    assert len(got_u8) == len(want_u8) == 5
    for p, g, w in zip(paths, got_u8, want_u8):
        assert g.dtype == np.uint8 and g.shape == w.shape == (256, 256, 3), p
        assert np.array_equal(g, w), p
    assert got_pm1.dtype == want_pm1.dtype == np.float32
    assert np.array_equal(got_pm1, want_pm1)
    small = tharness.load_images_uint8(paths[2:3], size=64)[0]
    monkeypatch.delitem(sys.modules, "PIL")
    assert np.array_equal(small, jharness.load_images_uint8(paths[2:3], size=64)[0])


@pytest.fixture(scope="module")
def eval_models(tmp_path_factory, iresnet18):
    """Shared tiny CLIP scorers and ViTs, and the IResNet-18 behind both
    packages' centre-crop face evaluators."""
    d = tmp_path_factory.mktemp("vocab")
    jtok = build_word_vocab(d)
    ttok = TorchTokenizer.from_files(str(d / "vocab.json"), str(d / "merges.txt"))
    jscorer, tscorer = scorer_pair(jtok, ttok, 7)
    jdp, jdcfg, tdm = dino_pair(9)
    jp, jcfg, tm = iresnet18
    return dict(jscorer=jscorer, tscorer=tscorer, jdino=JDINOEvaluator(jdp, jdcfg),
                tdino=TDINOEvaluator(tdm), jface=jfe.FaceSimilarityEvaluator(
                    jp, jcfg, detector=lambda im: jfe.center_crop_detector(im, 112)),
                tface=tfe.FaceSimilarityEvaluator(tm))


@pytest.mark.parametrize("num_samples,face", [(-1, True), (2, False)])
def test_compare_folders_matches_jax(eval_models, tmp_path, num_samples, face):
    """Photos with a `_mask.png` beside them (left out) against samples (the
    last `num_samples` of them); the face score only with a face evaluator."""
    rng = np.random.default_rng(11)
    gt, samples = tmp_path / "gt", tmp_path / "samples"
    gt.mkdir()
    samples.mkdir()
    for i in range(2):
        write_png(str(gt / f"{i}.png"), rng.integers(0, 256, (96, 80, 3), np.uint8))
        write_png(str(gt / f"{i}_mask.png"), np.full((96, 80, 3), 255, np.uint8))
    for i in range(3):
        write_png(str(samples / f"p000-{i:05d}.png"), rng.integers(0, 256, (64, 64, 3), np.uint8))
    m = eval_models
    args = (str(gt), str(samples), "a photo of a * person")
    want = jharness.compare_folders(m["jscorer"], m["jdino"], *args, num_samples=num_samples,
                                    face_evaluator=m["jface"] if face else None)
    got = tharness.compare_folders(m["tscorer"], m["tdino"], *args, num_samples=num_samples,
                                   face_evaluator=m["tface"] if face else None)
    for k in ("sim_img", "sim_text", "sim_dino"):
        assert isinstance(getattr(got, k), float)
        assert abs(getattr(got, k) - getattr(want, k)) <= SCORE_TOL, k
    assert (got.sim_face is None) == (want.sim_face is None) == (not face)
    if face:
        assert abs(got.sim_face - want.sim_face) <= SCORE_TOL


@pytest.mark.parametrize("prompt_set", ["dreambench", "community", "all"])
@pytest.mark.parametrize("broad_class", [0, 1, 2])
@pytest.mark.parametrize("fp_trick", [False, True])
def test_format_prompt_list_matches_jax(prompt_set, broad_class, fp_trick):
    kw = dict(z_prefix="portrait of", z_suffix=", smiling", background_string=" at dusk",
              class_token="person", class_long_token="young person", broad_class=broad_class,
              prompt_set_name=prompt_set, use_fp_trick=fp_trick)
    assert tprompts.format_prompt_list("z", **kw) == jprompts.format_prompt_list("z", **kw)


def test_prompt_lists_and_file_match_jax(tmp_path):
    for name in ("OBJECT_PROMPT_LIST", "ANIMAL_PROMPT_LIST", "COMMUNITY_PROMPT_LIST"):
        assert getattr(tprompts, name) == getattr(jprompts, name), name
    f = tmp_path / "prompts.txt"
    f.write_text("# a comment\n{0} {1}{2} in a garden\n\n  {0} {1}{2} on a boat  \n")
    assert tprompts.load_prompt_file(str(f)) == jprompts.load_prompt_file(str(f)) == [
        "{0} {1}{2} in a garden", "{0} {1}{2} on a boat"]
    for pkg in (tprompts, jprompts):
        with pytest.raises(ValueError):
            pkg.format_prompt_list("z", prompt_set_name="other")


# the fish-shell layout of the reference's evaluation/info-subjects.sh: every
# variable kind the parser knows (ints, per-subject weight lists, a 1-based
# selection, a $reference), quoted groups and lines it skips
SUBJECT_FILE = """#!/usr/bin/fish
# subject metadata
set -g subjects alice bob teapot
set -g cls_delta_strings "young woman" man teapot
set -g class_names woman man "tea pot"
set -g broad_classes 1 1 0
set -g are_faces 1 1 0
set -g maxiters 500 500 800
set -g all_init_word_weights "1 2" "1" "0.5 0.5 1"
set -g bg_init_strings "room" "street" "table"
set -g sel_set 1 3
set -g cls_strings $cls_delta_strings
set -g data_folder subjects-mixed
echo done
"""


def test_subject_file_matches_jax(tmp_path):
    path = tmp_path / "info-subjects.sh"
    path.write_text(SUBJECT_FILE)
    got, want = tinfo.parse_subject_file(str(path)), jinfo.parse_subject_file(str(path))
    assert got == want
    info, attr = got
    assert info["sel_set"] == [0, 2] and info["cls_strings"] == ["young woman", "man", "teapot"]
    assert attr["all_init_word_weights"]["teapot"] == [0.5, 0.5, 1.0]
    subjects = {}
    for pkg, data in (("jax", jdata), ("port", tdata)):
        subjects[pkg] = [data.SubjectInfo(n, [f"{n}.png"], [None]) for n in ("alice", "teapot",
                                                                             "carol")]
    jinfo.apply_subject_info(subjects["jax"], want[1])
    out = tinfo.apply_subject_info(subjects["port"], got[1])
    assert out is subjects["port"]
    for s, w in zip(subjects["port"], subjects["jax"]):
        assert (s.name, s.cls_delta_string, s.broad_class, s.is_face) == (
            w.name, w.cls_delta_string, w.broad_class, w.is_face)
    assert [s.is_face for s in out] == [True, False, True]


@pytest.mark.parametrize("missing,match", [("subjects", "subjects not defined"),
                                           ("broad_classes", "broad_classes: 2 values")])
def test_subject_file_errors_match_jax(tmp_path, missing, match):
    lines = SUBJECT_FILE.splitlines()
    if missing == "subjects":
        lines = [ln for ln in lines if not ln.startswith("set -g subjects")]
    else:
        lines = [("set -g broad_classes 1 0" if ln.startswith("set -g broad_classes") else ln)
                 for ln in lines]
    path = tmp_path / "bad.sh"
    path.write_text("\n".join(lines))
    for pkg in (tinfo, jinfo):
        with pytest.raises(ValueError, match=match):
            pkg.parse_subject_file(str(path))

