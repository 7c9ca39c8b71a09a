"""The port's gen_eval CLI and txt2img's --compare_with against the JAX
package's (CPU, `--device cpu`, tiny models, the files and pipelines of
tests/test_torch_cli.py): the same contexts in every generate call, the
same subjects scored or skipped, the same CSV columns, and scores within
SCORE_TOL. The two packages draw their initial noise from different
generators, so each generate call runs and is recorded, and then hands
both CLIs the same seeded images; the random-weight CLIP scorer and DINO
model of both CLIs are replaced by tiny ones on shared weights."""

import csv
import os

import numpy as np
import pytest

from adaprompt_tpu.cli import common as jcommon, gen_eval as jgen_eval, txt2img as jtxt2img
from adaprompt_tpu.eval import clip_scorer as jscorer_mod, dino_eval as jdev_mod
from adaprompt_tpu.eval import face_eval as jfe, harness as jharness
from adaprompt_tpu.models import dino as jdino
from adaprompt_tpu_torch.cli import common as tcommon, gen_eval as tgen_eval
from adaprompt_tpu_torch.cli import txt2img as ttxt2img
from adaprompt_tpu_torch.eval import clip_scorer as tscorer_mod, face_eval as tfe
from adaprompt_tpu_torch.eval import harness as tharness
from adaprompt_tpu_torch.models import dino as tdino
from adaprompt_tpu_torch.utils.png import read_png, write_png
from test_torch_cli import CTX_TOL, clis, env  # noqa: F401
from torch_port_helpers import assert_close, dino_pair, scorer_pair
from torch_port_helpers import torch_threads  # noqa: F401

SCORE_TOL = 1e-4        # each score of the CSV / of compare_folders, absolute
SAMPLE = 64             # the side of the images each generate call hands the CLI


@pytest.fixture(scope="module")
def scorers(env):
    """Tiny CLIP scorers and ViTs on shared weights, each scorer with its
    package's tokenizer of the shared word vocabulary."""
    jscorer, tscorer = scorer_pair(env["jtok"], env["ttok"], 21)
    return jscorer, tscorer, dino_pair(23)


@pytest.fixture()
def eval_clis(env, clis, scorers, monkeypatch):
    """The CLIs of `clis`, their scorers and DINO models the shared tiny
    ones, every generate's images replaced (after it ran) by seeded noise
    of SAMPLE pixels, and a flat photo showing no face to either detector.
    Returns (the generate calls, the compare_folders calls) by package."""
    jscorer, tscorer, (jdp, jdcfg, tdm) = scorers
    monkeypatch.setattr(jscorer_mod.CLIPScorer, "random_init", lambda *a, **k: jscorer)
    monkeypatch.setattr(tscorer_mod.CLIPScorer, "random_init", lambda *a, **k: tscorer)
    monkeypatch.setattr(jdino, "init_params", lambda *a, **k: jdp)
    evaluator = jdev_mod.DINOEvaluator
    monkeypatch.setattr(jdev_mod, "DINOEvaluator", lambda params: evaluator(params, jdcfg))
    monkeypatch.setattr(tdino.DINO, "random_init", lambda *a, **k: tdm)
    for mod in (jfe, tfe):
        crop = mod.center_crop_detector
        monkeypatch.setattr(mod, "center_crop_detector",
                            lambda im, size=112, crop=crop: [] if im.std() == 0 else crop(im, size))
    for pipe in (jcommon.load_pipeline(None), tcommon.load_pipeline(None)):
        generate = pipe.generate

        def noise(*a, generate=generate, **k):
            n = len(generate(*a, **k))
            rng = np.random.default_rng(k["seed"])
            return rng.integers(0, 256, (n, SAMPLE, SAMPLE, 3)).astype(np.uint8)

        pipe.generate = noise
    folders = {"jax": [], "port": []}
    for pkg, mod in (("jax", jharness), ("port", tharness)):
        compare = mod.compare_folders

        def recorded(*a, compare=compare, calls=folders[pkg], **k):
            calls.append(compare(*a, **k))
            return calls[-1]

        monkeypatch.setattr(mod, "compare_folders", recorded)
    return clis, folders


def _check_contexts(calls):
    assert len(calls["jax"]) == len(calls["port"]) > 0
    for (kj, _), (kt, _) in zip(calls["jax"], calls["port"]):
        assert kt["seed"] == kj["seed"]
        for name in ("context", "context_uncond"):
            assert tuple(kt[name].shape) == np.asarray(kj[name]).shape, name
            assert_close(kt[name], np.asarray(kj[name]), atol=CTX_TOL)


def _subjects(root):
    """Two subjects of photos (masks beside one's) and one of flat photos."""
    rng = np.random.default_rng(24)
    for name, n in (("alice", 3), ("bob", 2), ("blank", 2)):
        d = root / name
        d.mkdir(parents=True)
        for i in range(n):
            img = (np.full((96, 80, 3), 128, np.uint8) if name == "blank"
                   else rng.integers(0, 256, (96, 80, 3), np.uint8))
            write_png(str(d / f"{i}.png"), img)
            if name == "alice":
                write_png(str(d / f"{i}_mask.png"), np.full((96, 80, 3), 255, np.uint8))
    return str(root)


def _read_csv(path):
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


def test_gen_eval_cli_matches_jax(env, eval_clis, tmp_path, capsys):
    """Every subject of the root: two scored (2 prompts x 2 images each,
    seed + pi), the flat one skipped; the CSVs' columns, subjects and
    scores; the PNGs are the images generate handed back."""
    calls, folders = eval_clis
    root = _subjects(tmp_path / "subjects")
    argv = ["--subjects_root", root, "--max_prompts", "2", "--n_per_prompt", "2",
            "--num_steps", "2", "--adaface_ckpt", env["files"]["pt"],
            "--arcface_ckpt", env["files"]["arcface"]]
    rows_j = jgen_eval.main(argv + ["--outdir", str(tmp_path / "jax")])
    out_j = capsys.readouterr().out
    rows_t = tgen_eval.main(argv + ["--outdir", str(tmp_path / "port"), "--device", "cpu"])
    out_t = capsys.readouterr().out
    assert "skip blank: no face" in out_j and "skip blank: no face" in out_t
    _check_contexts(calls)
    assert [k["seed"] for k, _ in calls["port"]] == [42, 43, 42, 43]
    cols_j, csv_j = _read_csv(tmp_path / "jax" / "scores.csv")
    cols_t, csv_t = _read_csv(tmp_path / "port" / "scores.csv")
    assert cols_t == cols_j == ["subject", "sim_img", "sim_text", "sim_dino", "sim_face"]
    assert [r["subject"] for r in csv_t] == [r["subject"] for r in csv_j] == ["alice", "bob"]
    assert [r["subject"] for r in rows_t] == ["alice", "bob"]
    for rt, rj in zip(csv_t, csv_j):
        for k in cols_j[1:]:
            assert abs(float(rt[k]) - float(rj[k])) <= SCORE_TOL, (rt["subject"], k)
            assert -1.0 <= float(rt[k]) <= 1.0
    assert len(folders["port"]) == len(folders["jax"]) == 2
    for name in ("alice", "bob"):
        pngs = sorted(os.listdir(tmp_path / "port" / name))
        assert pngs == sorted(os.listdir(tmp_path / "jax" / name)) == [
            "p000-00000.png", "p000-00001.png", "p001-00000.png", "p001-00001.png"]
        for p in pngs:
            assert np.array_equal(read_png(str(tmp_path / "port" / name / p)),
                                  read_png(str(tmp_path / "jax" / name / p)))


def test_gen_eval_cli_subjects_filter(env, eval_clis, tmp_path):
    """--subjects keeps the named subjects only; a run whose subjects all
    show no face writes a CSV of its header alone."""
    root = _subjects(tmp_path / "subjects")
    argv = ["--subjects_root", root, "--subjects", "blank", "--max_prompts", "1",
            "--n_per_prompt", "1", "--num_steps", "1", "--device", "cpu"]
    assert tgen_eval.main(argv + ["--outdir", str(tmp_path / "port")]) == []
    cols, rows = _read_csv(tmp_path / "port" / "scores.csv")
    assert cols == tgen_eval.SCORE_COLUMNS and rows == []
    assert not eval_clis[0]["port"]


def test_txt2img_compare_with_matches_jax(env, eval_clis, tmp_path, capsys):
    """--compare_with scores the generations against the photos' folder by
    the first prompt: CLIP image and text, DINO, no face score; the line it
    prints carries the three scores."""
    calls, folders = eval_clis
    argv = ["--prompt", "photo of a z in the park", "--n_samples", "2", "--ddim_steps", "2",
            "--H", "32", "--W", "32", "--adaface_ckpt", env["files"]["pt"],
            "--compare_with", env["photos"]]
    jtxt2img.main(argv + ["--outdir", str(tmp_path / "jax")])
    capsys.readouterr()
    ttxt2img.main(argv + ["--outdir", str(tmp_path / "port"), "--device", "cpu"])
    out = capsys.readouterr().out
    _check_contexts(calls)
    (sj,), (st,) = folders["jax"], folders["port"]
    assert st.sim_face is None and sj.sim_face is None
    for k in ("sim_img", "sim_text", "sim_dino"):
        assert abs(getattr(st, k) - getattr(sj, k)) <= SCORE_TOL, k
    assert (f"sim_img={st.sim_img:.3f} sim_text={st.sim_text:.3f} "
            f"sim_dino={st.sim_dino:.3f}") in out
