"""The port's demo CLI against the JAX package's (CPU, tiny models of
tests/test_torch_cli.py, `load_pipeline` monkeypatched, `--device cpu`,
generate at 32x32): the REPL driven through a monkeypatched `input`, the
Gradio UI's function under a stub `gradio` module, `main`'s fallback to the
REPL where gradio is missing, and an ImportError raised inside the UI,
which the port lets through and the JAX demo takes for a missing gradio.

Both demos build a random ArcFace trunk (JAX's `arcface.init_params(
PRNGKey(2))`, the port's `common.load_arcface(None)`): here both are
monkeypatched to the tiny trunk of test_torch_cli's `.pth`. The images of
the two packages differ (their initial noise comes from different
generators): the contexts each demo passes to generate must agree within
CTX_TOL, the seeds must be equal, and the port's PNGs must decode to the
images generate returned."""

import builtins
import sys
import types

import numpy as np
import pytest

from adaprompt_tpu.cli import demo as jdemo
from adaprompt_tpu.models import arcface as jarcface
from adaprompt_tpu.utils import torch_port as jtp
from adaprompt_tpu_torch.cli import common as tcommon, demo as tdemo
from adaprompt_tpu_torch.eval.face_eval import list_images
from adaprompt_tpu_torch.utils.png import read_png
from test_torch_cli import CTX_TOL, clis, env  # noqa: F401
from torch_port_helpers import assert_close
from torch_port_helpers import torch_threads  # noqa: F401

STEPS = "2"


@pytest.fixture()
def demos(env, clis, monkeypatch, tmp_path):
    """(JAX argv, port argv) over the shared files; both demos' random
    ArcFace trunks replaced by the tiny one of the shared `.pth`."""
    af = jarcface.from_torch(jtp.load_state_dict(env["files"]["arcface"]))
    monkeypatch.setattr(jarcface, "init_params", lambda *a, **k: af)
    load_arcface = tcommon.load_arcface
    monkeypatch.setattr(tcommon, "load_arcface",
                        lambda path, device: load_arcface(env["files"]["arcface"], device))
    argv = ["--adaface_ckpt", env["files"]["pt"], "--num_steps", STEPS, "--no_warmup"]
    return (argv + ["--outdir", str(tmp_path / "jax")],
            argv + ["--outdir", str(tmp_path / "port"), "--device", "cpu"])


def _feed(monkeypatch, lines):
    it = iter(lines)

    def fake_input(prompt=""):
        try:
            return next(it)
        except StopIteration:
            raise EOFError from None
    monkeypatch.setattr(builtins, "input", fake_input)


def _check_contexts(calls):
    assert len(calls["jax"]) == len(calls["port"]) > 0
    for (kj, _), (kt, _) in zip(calls["jax"], calls["port"]):
        assert kt["seed"] == kj["seed"]
        for name in ("context", "context_uncond"):
            assert tuple(kt[name].shape) == tuple(np.asarray(kj[name]).shape)
            assert_close(kt[name], kj[name], atol=CTX_TOL)


def test_repl_matches_jax(env, clis, demos, monkeypatch, capsys):
    """subject, two gens, an unknown command and quit: the same contexts and
    seeds (42, 43) in both; the port saves one PNG a gen under its seed."""
    script = [f"subject {env['photos']}", "gen portrait of a z", "what", "gen a z in the snow",
              "quit", "gen never reached"]
    outs = {}
    for pkg, demo, argv in (("jax", jdemo, demos[0]), ("port", tdemo, demos[1])):
        args = demo.parse_args(argv)
        ada = demo.build_pipeline(args)
        _feed(monkeypatch, script)
        demo.run_repl(ada, args)
        outs[pkg] = capsys.readouterr().out
    _check_contexts(clis)
    assert [k["seed"] for k, _ in clis["port"]] == [42, 43]
    for pkg in ("jax", "port"):
        assert outs[pkg].count("subject loaded") == 1 and outs[pkg].count("unknown command") == 1
    saved = [ln.split("saved: ", 1)[1] for ln in outs["port"].splitlines() if "saved: " in ln]
    assert [p.rsplit("/", 1)[1] for p in saved] == ["seed42-00000.png", "seed43-00000.png"]
    for path, (_, img) in zip(saved, clis["port"]):
        assert np.array_equal(read_png(path), img[0])


def test_main_falls_back_to_the_repl_without_gradio(demos, clis, monkeypatch, capsys):
    """gradio cannot be imported: main warms up (two generates, 1 and 4
    images), prints the fallback line and runs the REPL."""
    monkeypatch.setitem(sys.modules, "gradio", None)        # import gradio -> ImportError
    _feed(monkeypatch, ["quit"])
    tdemo.main([a for a in demos[1] if a != "--no_warmup"])
    out = capsys.readouterr().out
    assert "gradio not installed — falling back to the REPL demo" in out
    assert "warmup done" in out and "demo REPL" in out
    assert [k["context"].shape[1] for k, _ in clis["port"]] == [1, 4]


def _stub_gradio(monkeypatch):
    """A `gradio` module whose Interface keeps its function; launch does nothing."""
    gr = types.ModuleType("gradio")
    gr.interfaces = []

    class Interface:
        def __init__(self, fn, **kw):
            self.fn = fn
            gr.interfaces.append(self)

        def launch(self, **kw):
            pass
    gr.Interface = Interface
    for name in ("Gallery", "Textbox", "Slider", "Number"):
        setattr(gr, name, lambda *a, **k: None)
    monkeypatch.setitem(sys.modules, "gradio", gr)
    return gr


def test_gradio_function_matches_jax(env, clis, demos, monkeypatch):
    """The UI's function on three photos: the same contexts and seeds as
    JAX's under the same stub; no photo gives no generation."""
    gr = _stub_gradio(monkeypatch)
    for demo, argv in ((jdemo, demos[0]), (tdemo, demos[1])):
        args = demo.parse_args(argv)
        demo.run_gradio(demo.build_pipeline(args), args)
    jfn, tfn = (ui.fn for ui in gr.interfaces)
    photos = [read_png(p) for p in list_images(env["photos"])]
    out_j = jfn(photos, "portrait of a z", 5.0, 7, 2)
    out_t = tfn(photos, "portrait of a z", 5.0, 7, 2)
    assert len(out_t) == len(out_j) == 2 and out_t[0].dtype == np.uint8
    _check_contexts(clis)
    assert clis["port"][0][0]["seed"] == 7 and clis["port"][0][0]["guidance_scale"] == 5.0
    assert tfn(None, "portrait of a z", 5.0, 7, 2) == []


def test_import_error_inside_the_ui_is_not_swallowed(demos, clis, monkeypatch, capsys):
    """gradio imports, then the UI raises ImportError: the port's main
    raises it, where the JAX demo falls back to the REPL."""
    _stub_gradio(monkeypatch)

    def broken(ada, args):
        raise ImportError("a module the UI needs is missing")
    monkeypatch.setattr(tdemo, "run_gradio", broken)
    monkeypatch.setattr(jdemo, "run_gradio", broken)
    with pytest.raises(ImportError, match="the UI needs"):
        tdemo.main(demos[1])
    _feed(monkeypatch, ["quit"])
    jdemo.main(demos[0])
    assert "falling back to the REPL demo" in capsys.readouterr().out
