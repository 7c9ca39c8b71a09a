"""The port's training data (`adaprompt_tpu_torch/data/`, `utils/config.py`
and the PNG decoder's additions) against the JAX package's: the config tree
and namespace, the prompt sets, and the dataset's batches bit for bit (PNGs
in RGB, RGBA, grey, 1-bit and palette modes, sizes other than the training
size, with and without masks, PIL hidden from the port)."""

import argparse
import io
import random
import sys

import numpy as np
import pytest
from PIL import Image

from adaprompt_tpu.data import dataset as jds, prompts as jprompts
from adaprompt_tpu.utils import config as jconfig
from adaprompt_tpu_torch.data import dataset as tds, prompts as tprompts
from adaprompt_tpu_torch.utils import config as tconfig, png as tpng
from torch_port_helpers import torch_threads  # noqa: F401

SIZE = 32


def _save(img: Image.Image, path, **kw):
    img.save(str(path), format="PNG", **kw)
    return str(path)


@pytest.fixture(scope="module")
def subject_tree(tmp_path_factory):
    """Three subjects of PNGs in several modes and sizes, most with masks
    (grey with soft edges, RGB, 1-bit, palette), one without."""
    root = tmp_path_factory.mktemp("subjects")
    rng = np.random.default_rng(0)
    rgb = lambda h, w: Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8))

    def soft_mask(h, w):
        yy, xx = np.mgrid[:h, :w]
        d = np.hypot(yy - h / 2, xx - w / 2) / (min(h, w) / 2)
        return np.clip(255 * (1.4 - d), 0, 255).astype(np.uint8)

    alice, bob, carol = (root / n for n in ("alice", "bob", "carol"))
    for d in (alice, bob, carol):
        d.mkdir()
    _save(rgb(70, 60), alice / "a0.png")
    _save(Image.fromarray(soft_mask(70, 60)), alice / "a0_mask.png")          # L
    _save(rgb(48, 48).convert("RGBA"), alice / "a1.png")
    m = soft_mask(48, 48)
    _save(Image.fromarray(np.stack([m, m // 2, 255 - m], -1)), alice / "a1_mask.png")   # RGB
    _save(rgb(41, 53).quantize(16), alice / "a2.png")                         # palette
    _save(Image.fromarray(soft_mask(41, 53)).convert("1"), alice / "a2_mask.png")       # 1-bit
    _save(rgb(50, 50).convert("L"), bob / "b0.png")                            # grey, no mask
    _save(rgb(SIZE, SIZE), bob / "b1.png")                                     # the training size
    _save(Image.fromarray(soft_mask(SIZE, SIZE)).convert("RGB").quantize(8), bob / "b1_mask.png")
    _save(rgb(64, 80).convert("LA"), carol / "c0.png")
    _save(Image.fromarray(soft_mask(64, 80)), carol / "c0_mask.png")
    (carol / "notes.txt").write_text("not an image")
    return str(root)


def _same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert np.array_equal(g, w), k
        else:
            assert g == w, k


def _batches(mod, root, seed, workers, n=3):
    subjects = mod.scan_subject_folders(root)
    dset = mod.PersonalizedDataset(subjects, size=SIZE, seed=seed)
    it = mod.make_batch_iterator(dset, mod.SubjectSampler(subjects, seed=seed), batch_size=2,
                                 num_workers=workers)
    out = [next(it) for _ in range(n)]
    it.close()
    return out


def test_scan_subject_folders_matches_jax(subject_tree):
    want = [vars(s) for s in jds.scan_subject_folders(subject_tree)]
    assert [vars(s) for s in tds.scan_subject_folders(subject_tree)] == want
    assert [s["name"] for s in want] == ["alice", "bob", "carol"]
    assert want[1]["fg_mask_paths"][0] is None


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batches_match_jax_bit_for_bit(subject_tree, monkeypatch, seed, workers):
    want = _batches(jds, subject_tree, seed, workers)
    monkeypatch.setitem(sys.modules, "PIL", None)     # the card's machine has no PIL
    got = _batches(tds, subject_tree, seed, workers)
    for g, w in zip(got, want):
        _same(g, w)
    assert {b["subject_name"][0] for b in want} and want[0]["image"].shape == (2, SIZE, SIZE, 3)


def test_nearest_resize_picks_pils_pixels():
    rng = np.random.default_rng(3)
    for h, w in ((1, 1), (7, 5), (33, 64), (100, 37), (512, 512), (640, 333)):
        a = rng.integers(0, 256, (h, w, 4), np.uint8)
        for size in (8, 31, 32, 359, 512):
            want = np.asarray(Image.fromarray(a).resize((size, size), Image.NEAREST))
            assert np.array_equal(tds._nearest_resize(a, size), want), (h, w, size)


def test_decoder_and_grey_match_pil_convert():
    """decode_png is PIL's convert("RGB") and to_grey its convert("L"),
    for every PNG mode the dataset meets (1-, 2-, 4- and 8-bit palettes)."""
    rng = np.random.default_rng(4)
    base = Image.fromarray(rng.integers(0, 256, (19, 23, 3), np.uint8))
    images = [base, base.convert("RGBA"), base.convert("L"), base.convert("LA"),
              base.convert("1")] + [(base.quantize(2 ** b), b) for b in (1, 2, 4, 8)]
    for im in images:
        im, bits = im if isinstance(im, tuple) else (im, None)
        buf = io.BytesIO()
        im.save(buf, format="PNG", **({"bits": bits} if bits else {}))
        data = buf.getvalue()
        got = tpng.decode_png(data, "x.png")
        with Image.open(io.BytesIO(data)) as ref:
            assert np.array_equal(got, np.asarray(ref.convert("RGB"))), (im.mode, bits)
            assert np.array_equal(tpng.to_grey(got), np.asarray(ref.convert("L"))), (im.mode, bits)


@pytest.mark.parametrize("seed", [0, 5, 11])
def test_prompt_sets_match_jax(seed):
    kw = [dict(), dict(num_vectors_per_subj_token=16, num_vectors_per_bg_token=4,
                       background_string="y", cls_bg_delta_string="background"),
          dict(broad_class=0, is_animal=False, num_compositions_per_image=3)]
    for k in kw:
        want = jprompts.generate_prompt_set("z", "person", rng=random.Random(seed), **k)
        assert tprompts.generate_prompt_set("z", "person", rng=random.Random(seed), **k) == want
    for training in (True, False):
        want = jprompts.sample_compositions(6, "animal", training, random.Random(seed))
        assert tprompts.sample_compositions(6, "animal", training, random.Random(seed)) == want


def _parser(mod):
    p = argparse.ArgumentParser()
    mod.add_config_args(p)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--lr", type=float, default=1.0)
    p.add_argument("--name", type=str, default="a")
    p.add_argument("--flag", action="store_true")
    return p


def test_config_files_match_jax(tmp_path, monkeypatch, capsys):
    a, b = tmp_path / "a.yaml", tmp_path / "b.yaml"
    a.write_text("trainer:\n  steps: 100\n  lr: 0.5\ndata:\n  name: x\n  flag: true\n")
    b.write_text("trainer:\n  lr: 0.25\nother:\n  unknown_key: 3\n")
    argv = ["--base", str(a), str(b), "--set", "trainer.lr=2e-3", "data.lst=1,2,x",
            "data.none=null", "--steps", "999"]
    want = vars(jconfig.apply_config_files(_parser(jconfig).parse_args(argv), _parser(jconfig),
                                           argv))
    got = vars(tconfig.apply_config_files(_parser(tconfig).parse_args(argv), _parser(tconfig),
                                          argv))
    assert got == want and want["steps"] == 999 and want["lr"] == 2e-3
    tree = jconfig.load_config_tree([str(a), str(b)])
    assert tconfig.load_config_tree([str(a), str(b)]) == tree
    dot = ["trainer.lr=1", "x.y.z=True", "q=0.5,foo"]
    assert tconfig.apply_dotlist(tree, dot) == jconfig.apply_dotlist(tree, dot)
    # without yaml: --set alone works, --base raises and names the package
    monkeypatch.setitem(sys.modules, "yaml", None)
    argv = ["--set", "trainer.steps=7", "--lr", "3"]
    got = vars(tconfig.apply_config_files(_parser(tconfig).parse_args(argv), _parser(tconfig),
                                          argv))
    assert got["steps"] == 7 and got["lr"] == 3.0
    with pytest.raises(RuntimeError, match="yaml"):
        tconfig.apply_config_files(_parser(tconfig).parse_args(["--base", str(a)]),
                                   _parser(tconfig), ["--base", str(a)])
