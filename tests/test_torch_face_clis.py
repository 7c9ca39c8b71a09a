"""The port's face curation CLIs and the folder comparison against the JAX
package's (CPU, float32): `compare_face_folders` and `face_tools compare /
filter / knn` over a tiny ArcFace holding the same weights in both packages,
the evaluator behind an aligning detector, and `gen_face_masks` on PNG (and
one JPEG) photos of every PNG mode against JAX's CLI over the same
`79999_iter.pth` file: the written images and masks decoded bit-equal, the
parts histogram and the curation moves equal."""

import os
import shutil
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from adaprompt_tpu.cli import face_tools as jft
from adaprompt_tpu.cli import gen_face_masks as jgfm
from adaprompt_tpu.eval import face_detect as jfd
from adaprompt_tpu.eval import face_eval as jfe
from adaprompt_tpu_torch.cli import face_tools as tft
from adaprompt_tpu_torch.cli import gen_face_masks as tgfm
from adaprompt_tpu_torch.eval import face_detect as tfd
from adaprompt_tpu_torch.eval import face_eval as tfe
from adaprompt_tpu_torch.models import bisenet as tbis
from torch_port_helpers import arcface_pair, numpy_random_normal
from torch_port_helpers import torch_threads  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import reference_layouts as rl  # noqa: E402

TINY = dict(layers=(1, 1, 1, 1), planes=(8, 16, 32, 64), num_features=32, input_size=112)


@pytest.fixture(scope="module")
def evaluators():
    with numpy_random_normal():
        jp, jcfg, model = arcface_pair(0, **TINY)
    return jfe.FaceSimilarityEvaluator(jp, jcfg), tfe.FaceSimilarityEvaluator(model)


@pytest.fixture(autouse=True)
def no_detector_env(monkeypatch):
    monkeypatch.delenv("ADAPROMPT_RETINAFACE_CKPT", raising=False)
    monkeypatch.delenv("ADAPROMPT_BISENET_CKPT", raising=False)


def _photo_folders(root, n=3, seed=0):
    """Folders a, b and an outlier-bearing c of seeded PNG photos (written
    by PIL, which JAX's CLI reads them with): similar photos share a base."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (128, 120, 3)).astype(np.int64)
    out = {}
    for name in ("a", "b", "c"):
        d = root / name
        d.mkdir()
        for i in range(n):
            img = np.clip(base + rng.integers(-30, 31, base.shape), 0, 255).astype(np.uint8)
            if name == "c" and i == n - 1:
                img = rng.integers(0, 256, base.shape, dtype=np.uint8)     # the outlier
            Image.fromarray(img).save(d / f"img{i}.png")
        out[name] = str(d)
    return out


def test_compare_face_folders_matches_jax(tmp_path, evaluators):
    jev, tev = evaluators
    f = _photo_folders(tmp_path)
    for src, dst, ns in ((f["a"], f["b"], -1), (f["a"], f["c"], 2), (f["b"], f["b"], -1)):
        want = jfe.compare_face_folders(jev, src, dst, dst_num_samples=ns)
        got = tfe.compare_face_folders(tev, src, dst, dst_num_samples=ns)
        assert got[1:] == want[1:]
        assert abs(got[0] - want[0]) <= 1e-5


def test_evaluator_behind_an_aligning_detector_matches_jax(evaluators):
    """Photos -> the parsing detector (an injected parse map) -> the tiny
    ArcFace: crops bit-equal to JAX's, embeddings within 1e-5."""
    jev, tev = evaluators
    p = np.zeros((512, 512), np.int64)
    p[100:300, 150:330] = jfd.CLS_SKIN
    p[160:175, 190:215] = jfd.CLS_L_EYE
    p[158:172, 265:290] = jfd.CLS_R_EYE
    p[200:230, 230:250] = jfd.CLS_NOSE
    p[250:265, 210:270] = jfd.CLS_MOUTH
    rng = np.random.default_rng(1)
    photos = [rng.integers(0, 256, (400 + 30 * i, 380, 3), dtype=np.uint8) for i in range(2)]
    jdet = jfd.make_parsing_detector(lambda b: p[None])
    tdet = tfd.make_parsing_detector(lambda b: p[None])
    for img in photos:
        np.testing.assert_array_equal(tdet(img)[0], jdet(img)[0])
    j = jfe.FaceSimilarityEvaluator(jev.params, jev.cfg, detector=jdet)
    t = tfe.FaceSimilarityEvaluator(tev.arcface, detector=tdet)
    np.testing.assert_allclose(t(images_np=photos), j(images_np=photos), atol=1e-5)


def _run(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out


def test_face_tools_match_jax(tmp_path, evaluators, monkeypatch, capsys):
    """compare, knn and filter print what JAX's CLI prints; filter moves the
    same photos into the reject folder."""
    jev, tev = evaluators
    monkeypatch.setattr(jft, "_evaluator", lambda ckpt: jev)
    monkeypatch.setattr(tft, "_evaluator", lambda ckpt, device: tev)
    f = _photo_folders(tmp_path, n=4)
    for argv in (["compare", f["a"], f["b"]], ["compare", f["a"], f["c"]],
                 ["knn", os.path.join(f["a"], "img0.png"), f["b"], "--k", "3"]):
        want = _run(jft.main, argv, capsys)
        assert _run(tft.main, ["--device", "cpu"] + argv, capsys) == want
        assert want.strip()
    out = tft.main(["knn", os.path.join(f["a"], "img0.png"), f["c"], "--k", "2"])
    assert len(out) == 2 and out[0][0] >= out[1][0]
    capsys.readouterr()
    # the threshold: mid-way across the widest gap between the photos'
    # similarities to their mean (a random trunk maps all photos close)
    embs = np.stack([e[0] for e in jev.embed_folder(jfe.list_images(f["c"]))])
    mean = embs.mean(0) / np.linalg.norm(embs.mean(0))
    sims = np.sort(embs @ mean)
    gap = int(np.argmax(np.diff(sims)))
    assert sims[gap + 1] - sims[gap] > 1e-4
    threshold = float(sims[gap] + sims[gap + 1]) / 2
    moved = {}
    for name, main, extra in (("jax", jft.main, []), ("port", tft.main, ["--device", "cpu"])):
        folder = tmp_path / f"filter_{name}"
        shutil.copytree(f["c"], folder)
        reject = tmp_path / f"reject_{name}"
        text = _run(main, extra + ["filter", str(folder), "--threshold", repr(threshold),
                                   "--reject_dir", str(reject)], capsys)
        moved[name] = (sorted(os.listdir(reject)), sorted(os.listdir(folder)), text)
    assert moved["port"][:2] == moved["jax"][:2] and moved["jax"][0]
    assert moved["port"][2].replace("port", "jax") == moved["jax"][2]


# -- gen_face_masks ------------------------------------------------------------------

@pytest.fixture(scope="module")
def parser_ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("bisenet") / "79999_iter.pth"
    torch.save(rl.bisenet_face_parsing(tbis.BiSeNet.random_init(0, device="cpu"), seed=10), path)
    return str(path)


def _subject_photos(root):
    """Photos of every PNG mode, at several sizes, and a JPEG, written by
    PIL: two subject folders of three photos each (batches of 2, the last
    one short) and a flat folder of the same six."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[:300, :280]
    gradient = np.stack([yy * 255 // 300, xx * 255 // 280, (xx + yy) * 255 // 580], -1)
    noise = rng.integers(0, 256, (96, 80, 3), dtype=np.uint8)
    rgba = np.concatenate([rng.integers(0, 256, (512, 512, 3), dtype=np.uint8),
                           rng.choice([0, 90, 255], (512, 512, 1)).astype(np.uint8)], -1)
    checker = ((((np.mgrid[:600, :520][0] // 40) + (np.mgrid[:600, :520][1] // 40)) % 2)
               * 255).astype(np.uint8)
    jpeg = rng.integers(0, 256, (140, 150, 3), dtype=np.uint8)
    photos = {"s0/noise.png": Image.fromarray(noise),
              "s0/gradient.png": Image.fromarray(gradient.astype(np.uint8)).convert("P"),
              "s0/grey.png": Image.fromarray(gradient[..., 1].astype(np.uint8)),
              "s1/checker.png": Image.fromarray(checker),
              "s1/alpha.png": Image.fromarray(rgba, "RGBA"),
              "s1/photo.jpg": Image.fromarray(jpeg)}
    for rel, im in photos.items():
        for layout in ("subjects", "flat"):
            path = root / layout / (rel if layout == "subjects" else rel.replace("/", "_"))
            path.parent.mkdir(parents=True, exist_ok=True)
            im.save(path)
    return str(root / "subjects"), str(root / "flat")


def _tree(root):
    """{relative path: decoded pixels} of every file under root (PIL)."""
    out = {}
    for folder, _, files in os.walk(root):
        for f in files:
            with Image.open(os.path.join(folder, f)) as im:
                out[os.path.relpath(os.path.join(folder, f), root)] = (im.mode, np.asarray(im))
    return out


def _both(tmp_path, src, argv, tag):
    """JAX's and the port's CLI each over its own copy of `src`: {package:
    (the src tree after the run, its _trash and _inspect trees, the out
    tree)}, and the port's result."""
    trees, result = {}, None
    for name, main, extra in (("jax", jgfm.main, []), ("port", tgfm.main, ["--device", "cpu"])):
        s, out = tmp_path / f"{tag}_{name}" / "src", tmp_path / f"{tag}_{name}" / "out"
        shutil.copytree(src, s)
        r = main(["--src", str(s), "--out", str(out)] + argv + extra)
        if name == "port":
            result = r
        trees[name] = tuple(_tree(p) if os.path.exists(p) else {}
                            for p in (s, str(s) + "_trash", str(s) + "_inspect", out))
    return trees, result


def _assert_trees_equal(trees):
    for want, got in zip(trees["jax"], trees["port"]):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k][0] == want[k][0], k
            np.testing.assert_array_equal(got[k][1], want[k][1], err_msg=k)


def test_gen_face_masks_matches_jax(tmp_path, parser_ckpt, capsys):
    """Every photo through (no curation), subject folders, batches of 2:
    the 512x512 images and the `_mask.png` masks (mode 'L', values in
    {0, 255}) decode bit-equal to JAX's, the printed parts histogram
    equal; then with thresholds at the histogram's ends over the flat
    folder with --move_bad: the same photos trashed and inspected."""
    subjects, flat = _subject_photos(tmp_path)
    trees, result = _both(tmp_path, subjects, ["--bisenet_ckpt", parser_ckpt, "--batch_size", "2",
                                               "--trash_min_parts", "0",
                                               "--inspect_max_parts", "10000"], "all")
    text = capsys.readouterr().out.strip().splitlines()
    assert text[-1].split("; ")[1] == text[-2].split("; ")[1]       # the same histogram
    _assert_trees_equal(trees)
    out = trees["port"][3]
    masks = [k for k in out if k.endswith("_mask.png")]
    assert len(masks) == result["written"] == 6
    for k in masks:
        mode, m = out[k]
        assert mode == "L" and m.shape == (512, 512) and set(np.unique(m)) <= {0, 255}
    for k in out:
        if not k.endswith("_mask.png"):
            assert out[k][1].shape == (512, 512, 3), k
    parts = sorted(result["parts"])
    assert len(parts) >= 3, result
    trees, result = _both(tmp_path, flat, [
        "--bisenet_ckpt", parser_ckpt, "--flat", "--batch_size", "2", "--move_bad",
        "--trash_min_parts", str(parts[0]), "--inspect_max_parts", str(parts[-1])], "curated")
    _assert_trees_equal(trees)
    assert result["trash"] and result["inspect"] and 0 < result["written"] < 6


def test_gen_face_masks_curation_copies(tmp_path, parser_ckpt):
    """By default bad photos are copied, not moved: everything to trash."""
    subjects, _ = _subject_photos(tmp_path)
    trees, result = _both(tmp_path, subjects, ["--bisenet_ckpt", parser_ckpt, "--batch_size", "2",
                                               "--trash_min_parts", "10000"], "trash")
    _assert_trees_equal(trees)
    assert result["written"] == 0 and len(result["trash"]) == 6
    assert len(trees["port"][0]) == len(trees["port"][1]) == 6


def test_gen_face_masks_needs_pil_only_for_other_formats(tmp_path, parser_ckpt, monkeypatch):
    """With PIL hidden, PNG photos go through; a JPEG raises
    ModuleNotFoundError naming PIL."""
    subjects, _ = _subject_photos(tmp_path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    argv = ["--bisenet_ckpt", parser_ckpt, "--src", subjects, "--out", str(tmp_path / "o"),
            "--device", "cpu", "--batch_size", "2", "--trash_min_parts", "0",
            "--inspect_max_parts", "10000", "--max_imgs_per_person", "1"]
    os.remove(os.path.join(subjects, "s1", "photo.jpg"))
    assert tgfm.main(argv)["written"] == 2
    with open(os.path.join(subjects, "s0", "a.jpg"), "wb") as f:
        f.write(b"\xff\xd8\xff")
    with pytest.raises(ModuleNotFoundError, match="PIL"):
        tgfm.main(argv)
