"""The port's background overlays (`adaprompt_tpu_torch/data/overlays.py`)
and the dataset's overlay path against the JAX package's, which decodes
and resizes with PIL: the provider over a folder and over a .tar (PNG in
the RGB, RGBA and grey modes, and JPEG; accepted and rejected captions,
ratios and sizes, down- and upscaled backgrounds) gives the same draws and
bit-equal backgrounds; `composite_wds_example` is bit-equal; the dataset's
batches at overlay_prob 0 and 1 and without a provider are bit-equal to
JAX's; a batch mixed at 0.5 collates, each example equal to JAX's."""

import tarfile

import numpy as np
import pytest
from PIL import Image

from adaprompt_tpu.data import dataset as jds
from adaprompt_tpu.data import overlays as jov
from adaprompt_tpu_torch.data import dataset as tds
from adaprompt_tpu_torch.data import overlays as tov
from adaprompt_tpu_torch.utils.png import write_png
from torch_port_helpers import torch_threads  # noqa: F401

SIZE = 64
# name, (h, w), PIL mode, caption (None: no sidecar file); accepted: a (down),
# b (up), i (grey), j (RGBA); the rest rejected
BACKGROUNDS = [
    ("a.jpg", (80, 96), "RGB", "A mountain lake at sunset"),
    ("b.png", (56, 60), "RGB", "a quiet beach with palm trees"),
    ("c.png", (70, 70), "RGB", "a man hiking a mountain"),
    ("d.png", (40, 40), "RGB", "a tiny background image here"),
    ("e.png", (64, 128), "RGB", "a very wide panorama of hills"),
    ("f.png", (70, 70), "RGB", "z in a quiet room"),
    ("g.png", (70, 70), "RGB", None),
    ("h.png", (70, 70), "RGB", "hut"),
    ("i.png", (72, 66), "L", "a foggy forest road"),
    ("j.png", (66, 72), "RGBA", "an empty city street at night"),
]


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """A folder of the backgrounds with their captions, and a .tar of it."""
    d = tmp_path_factory.mktemp("overlays")
    bg = d / "bg"
    bg.mkdir()
    rng = np.random.default_rng(0)
    for name, (h, w), mode, cap in BACKGROUNDS:
        ch = {"RGB": 3, "L": 1, "RGBA": 4}[mode]
        px = rng.integers(0, 256, (h, w, ch), dtype=np.uint8)
        Image.fromarray(px[..., 0] if ch == 1 else px, mode).save(bg / name)
        if cap is not None:
            (bg / name).with_suffix(".txt").write_text(cap)
    tar = d / "bgs.tar"
    with tarfile.open(tar, "w") as tf:
        for f in sorted(bg.iterdir()):
            tf.add(f, arcname=f.name)
    return {"folder": str(bg), "tar": str(tar), "root": d}


@pytest.mark.parametrize("kind", ["folder", "tar"])
def test_provider_matches_jax(sources, kind):
    """Twelve draws: the same accepted captions, bit-equal [64, 64, 3]
    backgrounds, the same random state afterwards; every accepted item
    comes up."""
    jp = jov.BackgroundOverlayProvider(sources[kind], size=SIZE, seed=5)
    tp = tov.BackgroundOverlayProvider(sources[kind], size=SIZE, seed=5)
    caps = set()
    for _ in range(12):
        (jimg, jcap), (timg, tcap) = jp.sample(), tp.sample()
        assert tcap == jcap and timg.dtype == np.uint8 and timg.shape == (SIZE, SIZE, 3)
        np.testing.assert_array_equal(timg, jimg)
        caps.add(tcap)
    assert caps == {"A mountain lake at sunset", "a quiet beach with palm trees",
                    "a foggy forest road", "an empty city street at night"}
    assert tp.rng.bit_generator.state == jp.rng.bit_generator.state


def test_accept_matches_jax(sources):
    jp = jov.BackgroundOverlayProvider(sources["folder"], size=SIZE)
    tp = tov.BackgroundOverlayProvider(sources["folder"], size=SIZE)
    for cap in ("a red barn", "the portrait gallery", "a Horse field", "y by the sea", "ab",
                "  a   ", "two cats", "catalog of shelves"):
        for w, h in ((64, 64), (48, 64), (64, 47), (100, 74), (49, 49), (50, 50), (85, 64)):
            assert tp._accept(cap, w, h) == jp._accept(cap, w, h), (cap, w, h)


def test_empty_source_matches_jax(sources):
    empty = sources["root"] / "empty"
    empty.mkdir(exist_ok=True)
    assert tov.BackgroundOverlayProvider(str(empty)).sample() is None
    assert jov.BackgroundOverlayProvider(str(empty)).sample() is None


def test_composite_matches_jax():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    ex = {"image_unnorm": img, "fg_mask": (rng.random((SIZE, SIZE)) > 0.5).astype(np.uint8),
          "aug_mask": np.ones((SIZE, SIZE), np.uint8), "caption": "a photo of a z",
          "caption_bg": "a photo of a z with background y", "has_wds_comp": False}
    bg = rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    want = jov.composite_wds_example(ex, bg, "A Lake", "young woman")
    got = tov.composite_wds_example(ex, bg, "A Lake", "young woman")
    assert set(got) == set(want) and got["has_wds_comp"] is True
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k
    assert ex["has_wds_comp"] is False                                 # out of place


@pytest.fixture(scope="module")
def subjects(tmp_path_factory):
    """Two subjects of PNG photos (one without a mask), read by both packages."""
    root = tmp_path_factory.mktemp("subjects")
    rng = np.random.default_rng(2)
    for name, n in (("alice", 3), ("bob", 2)):
        (root / name).mkdir()
        for i in range(n):
            write_png(str(root / name / f"{i}.png"), rng.integers(0, 256, (80, 72, 3), np.uint8))
            if (name, i) != ("bob", 1):
                mask = np.zeros((80, 72, 3), np.uint8)
                mask[16:64, 12:60] = 255
                write_png(str(root / name / f"{i}_mask.png"), mask)
    return str(root)


def _iterators(subjects, bg, prob, seed=4, bs=3):
    """(JAX's, the port's) batch iterators at num_workers=0 over the same
    subjects, with a provider of `bg` at `prob` (none when bg is None)."""
    out = []
    for ds, ov in ((jds, jov), (tds, tov)):
        subs = ds.scan_subject_folders(subjects)
        prov = None if bg is None else ov.BackgroundOverlayProvider(bg, size=SIZE, seed=seed)
        dset = ds.PersonalizedDataset(subs, size=SIZE, seed=seed, overlay_provider=prov,
                                      overlay_prob=prob)
        out.append((dset, ds.make_batch_iterator(dset, ds.SubjectSampler(subs, seed=seed),
                                                 batch_size=bs)))
    return out


def _assert_same(got, want, what):
    assert type(got) is type(want) or isinstance(want, np.ndarray), what
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want, what


@pytest.mark.parametrize("prob", [None, 0.0, 1.0], ids=["no_provider", "prob0", "prob1"])
def test_batches_match_jax(subjects, sources, prob):
    """Three batches, every key bit-equal to JAX's."""
    (_, jit), (_, tit) = _iterators(subjects, None if prob is None else sources["folder"],
                                    prob or 0.0)
    for i in range(3):
        want, got = next(jit), next(tit)
        assert list(got) == list(want)
        for k in want:
            _assert_same(got[k], want[k], f"batch {i} {k}")
        assert all(got["has_wds_comp"]) == (prob == 1.0)


def test_mixed_batch_collates(subjects, sources):
    """At overlay_prob 0.5 a batch holds composited and plain examples: the
    composites' keys are lists with None for the plain ones, and every
    example equals JAX's, drawn one by one (JAX's own collate reads the
    first example's keys: it drops those keys or raises KeyError)."""
    (jdset, _), (_, tit) = _iterators(subjects, sources["tar"], 0.5, seed=8, bs=4)
    jsampler = jds.SubjectSampler(jds.scan_subject_folders(subjects), seed=8)
    mixed = 0
    for _ in range(3):
        got = next(tit)
        subj = jsampler.next_subject()
        want = [jdset.sample(subj) for _ in range(4)]
        assert got["subject_idx"] == subj
        flags = got["has_wds_comp"]
        assert flags == [e["has_wds_comp"] for e in want]
        for k in dict.fromkeys(k for e in want for k in e):
            for i, e in enumerate(want):
                if k in e:
                    _assert_same(got[k][i], e[k], f"{k}[{i}]")
                else:
                    assert got[k][i] is None and not flags[i], k
        if 0 < sum(flags) < 4:
            mixed += 1
            assert [x is None for x in got["wds_image"]] == [not f for f in flags]
            try:
                jbatch = jds._collate(want, subj)
            except KeyError:
                assert flags[0]
            else:
                assert not flags[0] and "wds_image" not in jbatch
    assert mixed >= 1
