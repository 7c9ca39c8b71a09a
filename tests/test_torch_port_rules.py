"""Rules of the PyTorch port: it imports neither jax nor adaprompt_tpu, its
entry points default to CUDA and raise without it, and a kernel wrapper
takes its plain version only for CPU tensors. The kernels themselves are
compared with their plain versions on the card (marker `cuda`)."""

import dataclasses
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import adaprompt_tpu_torch
from adaprompt_tpu_torch import pipeline as tpipe
from adaprompt_tpu_torch.ops import attention as tattn, conv_halo as tch, geglu as tgeglu
from adaprompt_tpu_torch.ops import kernel_wrappers
from adaprompt_tpu_torch.ops.quant import int8_matmul, quantize_acts, quantize_weight

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLASH_VARIANTS = [tattn.FlashVariant(exp2=True), tattn.FlashVariant(ilv=True),
                  tattn.FlashVariant(nomax=True), tattn.FlashVariant(ilv=True, exp2=True),
                  tattn.FlashVariant(nomax=True, exp2=True)]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import adaprompt_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "adaprompt_tpu", "regex"))
print(len(names), bad)
"""


def test_port_imports_no_jax_nor_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.strip().split(" ", 1)
    assert int(n) >= 40          # every module of the package was imported
    assert bad == "[]", bad


_OPTIONAL_PACKAGES = ("PIL", "safetensors", "yaml", "cv2", "scipy")


def test_port_imports_no_optional_package_at_top_level():
    """The card's machine lacks PIL, safetensors, yaml, cv2 and scipy: no
    module of the port imports one when it is imported (the loaders and
    the image reader import them inside the call that needs that format)."""
    code = _IMPORT_ALL.replace('("jax", "jaxlib", "adaprompt_tpu", "regex")',
                               repr(_OPTIONAL_PACKAGES))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.strip().split(" ", 1)
    assert int(n) >= 50 and bad == "[]", (n, bad)


def test_random_init_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpipe.StableDiffusionPipeline.random_init(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpipe.resolve_device("cuda")
    assert tpipe.resolve_device("cpu").type == "cpu"


def _profile_step_main():
    from adaprompt_tpu_torch import profile_step
    for argv in (["profile_step"], ["profile_step", "--train", "--flash", "exp2"]):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sys, "argv", argv)
            with pytest.raises(SystemExit, match="needs a CUDA card"):
                profile_step.main()
    raise RuntimeError("CUDA is not available (profile_step exits without a card)")


def _entry_points():
    from adaprompt_tpu_torch.adaface.wrapper import AdaFacePipeline
    from adaprompt_tpu_torch.eval.clip_scorer import CLIPScorer
    from adaprompt_tpu_torch.models.arcface import ArcFace
    from adaprompt_tpu_torch.models.clip_vision import CLIPVisionModel
    from adaprompt_tpu_torch.train.trainer import (AdaPromptTrainer, TrainerConfig,
                                                   synthetic_raw_batches)
    from adaprompt_tpu_torch.cli import gen_eval, infer, train, txt2img
    from adaprompt_tpu_torch.eval.image_metrics import random_arcface_cosine
    from adaprompt_tpu_torch.models.dino import DINO
    from adaprompt_tpu_torch.cli import face_tools, gen_face_masks
    from adaprompt_tpu_torch.cli import arc2face_gen, demo, translate
    from adaprompt_tpu_torch.eval.face_eval import make_detector
    from adaprompt_tpu_torch.models.bisenet import BiSeNet
    from adaprompt_tpu_torch.models.retinaface import RetinaFace
    img = torch.zeros(1, 8, 8, 3, dtype=torch.uint8).numpy()
    return {"AdaFacePipeline": lambda: AdaFacePipeline.random_init(0),
            "from_checkpoint": lambda: tpipe.StableDiffusionPipeline.from_checkpoint(
                os.path.join(ROOT, "no-such-model.ckpt")),
            "txt2img.main": lambda: txt2img.main(["--prompt", "a z", "--ddim_steps", "1"]),
            "infer.main": lambda: infer.main(["--subject", ROOT, "--num_steps", "1"]),
            "train.main": lambda: train.main(["--data_roots", ROOT, "--synthetic_faces",
                                              "--num_steps", "1"]),
            "CLIPVisionModel": lambda: CLIPVisionModel.random_init(0),
            "AdaPromptTrainer": lambda: AdaPromptTrainer.random_init(
                0, synthetic_raw_batches(0), TrainerConfig(seed=0)),
            "ArcFace": lambda: ArcFace.random_init(0),
            "CLIPScorer": lambda: CLIPScorer.random_init(0),
            "DINO": lambda: DINO.random_init(0),
            "random_arcface_cosine": lambda: random_arcface_cosine(img, img, small=True),
            "gen_eval.main": lambda: gen_eval.main(["--subjects_root", ROOT, "--num_steps", "1"]),
            "profile_step": _profile_step_main,
            "RetinaFace": lambda: RetinaFace.random_init(0),
            "BiSeNet": lambda: BiSeNet.random_init(0),
            "make_detector_retinaface": lambda: make_detector("retinaface:no-such.pth"),
            "make_detector_bisenet": lambda: make_detector("bisenet:no-such.pth"),
            "gen_face_masks.main": lambda: gen_face_masks.main(
                ["--bisenet_ckpt", "no-such.pth", "--src", ROOT, "--out", ROOT]),
            "face_tools.main": lambda: face_tools.main(["compare", ROOT, ROOT]),
            "translate.main": lambda: translate.main(["--in_folder", ROOT, "--num_steps", "2"]),
            "arc2face_gen.main": lambda: arc2face_gen.main(["--ddim_steps", "1"]),
            "demo.build_pipeline": lambda: demo.build_pipeline(demo.parse_args([]))}


@pytest.mark.parametrize("name", ["AdaFacePipeline", "AdaPromptTrainer", "ArcFace",
                                  "CLIPVisionModel", "profile_step", "CLIPScorer",
                                  "from_checkpoint", "txt2img.main", "infer.main",
                                  "train.main", "DINO", "random_arcface_cosine",
                                  "gen_eval.main", "RetinaFace", "BiSeNet",
                                  "make_detector_retinaface", "make_detector_bisenet",
                                  "gen_face_masks.main", "face_tools.main",
                                  "translate.main", "arc2face_gen.main",
                                  "demo.build_pipeline"])
def test_entry_points_default_to_cuda_and_raise_without_it(name):
    """Every entry point of the port, called without a device, asks for CUDA
    and raises where there is none: none falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[name]()


def test_port_calls_no_library_attention_nor_compile():
    """No module of the port calls a library's fused attention or
    torch.compile: its kernels are the hand-written ones under csrc/."""
    pkg = os.path.join(ROOT, "adaprompt_tpu_torch")
    hits = []
    for folder, _, files in os.walk(pkg):
        for f in files:
            if f.endswith((".py", ".cu")):
                text = open(os.path.join(folder, f)).read()
                hits += [(f, word) for word in ("scaled_dot_product_attention", "torch.compile",
                                                "cublas", "cudnn.h", "cutlass/gemm/device")
                         if word in text]
    assert not hits, hits


STAGE2_MODULES = ("adaprompt_tpu_torch.adaface.cls_delta", "adaprompt_tpu_torch.train.compos",
                  "adaprompt_tpu_torch.train.elastic", "adaprompt_tpu_torch.train.compos_step",
                  "adaprompt_tpu_torch.eval.clip_scorer")


def test_stage2_modules_fall_under_the_rules():
    """The compositional slice's modules are among those the two rules above
    walk: each is found by the package walk, imported alone in a fresh
    interpreter it brings in neither jax nor the JAX package, and its source
    calls no library attention and no torch.compile."""
    import pkgutil
    walked = {m.name for m in pkgutil.walk_packages(adaprompt_tpu_torch.__path__,
                                                     "adaprompt_tpu_torch.")}
    assert set(STAGE2_MODULES) <= walked
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import importlib, sys\n"
            + "".join(f"importlib.import_module({m!r})\n" for m in STAGE2_MODULES)
            + "print(sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'adaprompt_tpu')))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout
    for m in STAGE2_MODULES:
        text = open(os.path.join(ROOT, *m.split(".")) + ".py").read()
        assert not [w for w in ("scaled_dot_product_attention", "torch.compile", "import jax",
                                "adaprompt_tpu.") if w in text], m


TRAIN_CLI_MODULES = ("adaprompt_tpu_torch.utils.config", "adaprompt_tpu_torch.data.prompts",
                     "adaprompt_tpu_torch.data.dataset", "adaprompt_tpu_torch.cli.train")


def test_train_cli_modules_fall_under_the_rules():
    """The training CLI's modules and their data and configuration copies:
    each is found by the package walk; imported together in a fresh
    interpreter they bring in neither jax, the JAX package, PIL nor yaml;
    no top-level statement of theirs imports PIL or yaml (they do so only
    inside the call that needs the format), and none names the JAX package."""
    import ast
    import pkgutil
    walked = {m.name for m in pkgutil.walk_packages(adaprompt_tpu_torch.__path__,
                                                     "adaprompt_tpu_torch.")}
    assert set(TRAIN_CLI_MODULES) <= walked
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import importlib, sys\n"
            + "".join(f"importlib.import_module({m!r})\n" for m in TRAIN_CLI_MODULES)
            + "print(sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'adaprompt_tpu', 'PIL', 'yaml')))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout
    for m in TRAIN_CLI_MODULES:
        text = open(os.path.join(ROOT, *m.split(".")) + ".py").read()
        top = [n for n in ast.parse(text).body if isinstance(n, (ast.Import, ast.ImportFrom))]
        names = [a.name for n in top if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in top if isinstance(n, ast.ImportFrom)]
        assert not [x for x in names if x.split(".")[0] in ("PIL", "yaml", "jax",
                                                            "adaprompt_tpu")], (m, names)
        assert "import jax" not in text and "adaprompt_tpu." not in text, m


EVAL_MODULES = ("adaprompt_tpu_torch.utils.resize", "adaprompt_tpu_torch.models.dino",
                "adaprompt_tpu_torch.eval.dino_eval", "adaprompt_tpu_torch.eval.image_metrics",
                "adaprompt_tpu_torch.eval.harness", "adaprompt_tpu_torch.eval.prompts",
                "adaprompt_tpu_torch.eval.subject_info", "adaprompt_tpu_torch.cli.gen_eval",
                "adaprompt_tpu_torch.adaface.zs_features",
                "adaprompt_tpu_torch.adaface.subj_basis_generator",
                "adaprompt_tpu_torch.cli.txt2img")


def test_eval_modules_fall_under_the_rules():
    """The evaluation path's modules: each is found by the package walk;
    imported together in a fresh interpreter they bring in neither jax, the
    JAX package, PIL nor transformers; no top-level statement of theirs
    imports one, none names the JAX package, and none holds code that only
    CUDA runs (a `.cuda()` call, a `torch.cuda` call, a hard-coded 'cuda'
    device): their device is the caller's or the pipeline's."""
    import ast
    import pkgutil
    walked = {m.name for m in pkgutil.walk_packages(adaprompt_tpu_torch.__path__,
                                                     "adaprompt_tpu_torch.")}
    assert set(EVAL_MODULES) <= walked
    banned = ("jax", "jaxlib", "adaprompt_tpu", "PIL", "transformers")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import importlib, sys\n"
            + "".join(f"importlib.import_module({m!r})\n" for m in EVAL_MODULES)
            + f"print(sorted(m for m in sys.modules if m.split('.')[0] in {banned!r}))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout
    for m in EVAL_MODULES:
        text = open(os.path.join(ROOT, *m.split(".")) + ".py").read()
        top = [n for n in ast.parse(text).body if isinstance(n, (ast.Import, ast.ImportFrom))]
        names = [a.name for n in top if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in top if isinstance(n, ast.ImportFrom)]
        assert not [x for x in names if x.split(".")[0] in banned], (m, names)
        assert "import jax" not in text and "adaprompt_tpu." not in text, m
        assert not re.search(r"\.cuda\(|torch\.cuda\.|[\"']cuda[\"']", text), m


DETECTION_MODULES = ("adaprompt_tpu_torch.eval.face_detect", "adaprompt_tpu_torch.models.bisenet",
                     "adaprompt_tpu_torch.models.retinaface", "adaprompt_tpu_torch.eval.face_eval",
                     "adaprompt_tpu_torch.utils.png", "adaprompt_tpu_torch.utils.resize",
                     "adaprompt_tpu_torch.cli.face_tools", "adaprompt_tpu_torch.cli.gen_face_masks")


def test_detection_modules_fall_under_the_rules():
    """The detection slice's modules: each is found by the package walk;
    imported together in a fresh interpreter they bring in neither jax, the
    JAX package, PIL, cv2 nor scipy; no top-level statement of theirs
    imports one (cv2 and PIL are imported inside the calls that need them),
    none names the JAX package, and the library modules (not the CLIs, whose
    --device defaults to 'cuda') hold no code that only CUDA runs."""
    import ast
    import pkgutil
    walked = {m.name for m in pkgutil.walk_packages(adaprompt_tpu_torch.__path__,
                                                     "adaprompt_tpu_torch.")}
    assert set(DETECTION_MODULES) <= walked
    banned = ("jax", "jaxlib", "adaprompt_tpu", "PIL", "cv2", "scipy")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import importlib, sys\n"
            + "".join(f"importlib.import_module({m!r})\n" for m in DETECTION_MODULES)
            + f"print(sorted(m for m in sys.modules if m.split('.')[0] in {banned!r}))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout
    for m in DETECTION_MODULES:
        text = open(os.path.join(ROOT, *m.split(".")) + ".py").read()
        top = [n for n in ast.parse(text).body if isinstance(n, (ast.Import, ast.ImportFrom))]
        names = [a.name for n in top if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in top if isinstance(n, ast.ImportFrom)]
        assert not [x for x in names if x.split(".")[0] in banned], (m, names)
        assert "import jax" not in text and "adaprompt_tpu." not in text, m
        if ".cli." not in m:
            assert not re.search(r"\.cuda\(|torch\.cuda\.|[\"']cuda[\"']", text), m


IMG2IMG_MODULES = ("adaprompt_tpu_torch.sampling.ddim", "adaprompt_tpu_torch.utils.diffusers_port",
                   "adaprompt_tpu_torch.cli.translate", "adaprompt_tpu_torch.cli.arc2face_gen",
                   "adaprompt_tpu_torch.cli.demo")


def test_img2img_and_cli_modules_fall_under_the_rules():
    """The img2img sampler, the diffusers loaders and the translate,
    arc2face_gen and demo CLIs: each is found by the package walk; imported
    together in a fresh interpreter they bring in neither jax, the JAX
    package, PIL nor gradio; no top-level statement of theirs imports one
    (PIL is imported by translate only to write a photo that is not a PNG,
    gradio by the demo's UI only); none names the JAX package, and the
    library modules (not the CLIs) hold no code that only CUDA runs."""
    import ast
    import pkgutil
    walked = {m.name for m in pkgutil.walk_packages(adaprompt_tpu_torch.__path__,
                                                     "adaprompt_tpu_torch.")}
    assert set(IMG2IMG_MODULES) <= walked
    banned = ("jax", "jaxlib", "adaprompt_tpu", "PIL", "gradio")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import importlib, sys\n"
            + "".join(f"importlib.import_module({m!r})\n" for m in IMG2IMG_MODULES)
            + f"print(sorted(m for m in sys.modules if m.split('.')[0] in {banned!r}))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout
    for m in IMG2IMG_MODULES:
        text = open(os.path.join(ROOT, *m.split(".")) + ".py").read()
        top = [n for n in ast.parse(text).body if isinstance(n, (ast.Import, ast.ImportFrom))]
        names = [a.name for n in top if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in top if isinstance(n, ast.ImportFrom)]
        assert not [x for x in names if x.split(".")[0] in banned], (m, names)
        assert "import jax" not in text and "adaprompt_tpu." not in text, m
        if ".cli." not in m:
            assert not re.search(r"\.cuda\(|torch\.cuda\.|[\"']cuda[\"']", text), m


PERSONALIZATION_MODULES = ("adaprompt_tpu_torch.adaface.ada_embedder",
                           "adaprompt_tpu_torch.adaface.cls_delta",
                           "adaprompt_tpu_torch.data.overlays", "adaprompt_tpu_torch.data.dataset",
                           "adaprompt_tpu_torch.train.steps", "adaprompt_tpu_torch.cli.train")


def test_personalization_and_overlay_modules_fall_under_the_rules():
    """The legacy Ada embedders, the class-delta functions, the background
    overlays with the dataset and the train CLI that use them, and the steps
    with the full-UNet recon step: each is found by the package walk;
    imported together in a fresh interpreter they bring in neither jax, the
    JAX package nor PIL (the overlays import PIL only to decode a
    background that is not a PNG); no top-level statement of theirs imports
    one; none names the JAX package, and the library modules hold no code
    that only CUDA runs."""
    import ast
    import pkgutil
    walked = {m.name for m in pkgutil.walk_packages(adaprompt_tpu_torch.__path__,
                                                     "adaprompt_tpu_torch.")}
    assert set(PERSONALIZATION_MODULES) <= walked
    banned = ("jax", "jaxlib", "adaprompt_tpu", "PIL")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import importlib, sys\n"
            + "".join(f"importlib.import_module({m!r})\n" for m in PERSONALIZATION_MODULES)
            + f"print(sorted(m for m in sys.modules if m.split('.')[0] in {banned!r}))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout
    for m in PERSONALIZATION_MODULES:
        text = open(os.path.join(ROOT, *m.split(".")) + ".py").read()
        top = [n for n in ast.parse(text).body if isinstance(n, (ast.Import, ast.ImportFrom))]
        names = [a.name for n in top if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in top if isinstance(n, ast.ImportFrom)]
        assert not [x for x in names if x.split(".")[0] in banned], (m, names)
        assert "import jax" not in text and "adaprompt_tpu." not in text, m
        if ".cli." not in m:
            assert not re.search(r"\.cuda\(|torch\.cuda\.|[\"']cuda[\"']", text), m


PARALLEL_MODULES = ("adaprompt_tpu_torch.parallel", "adaprompt_tpu_torch.parallel.mesh")


def test_parallel_modules_fall_under_the_rules():
    """parallel/: each module is found by the package walk; imported in a
    fresh interpreter it brings in neither jax nor the JAX package, and its
    top-level imports are torch, numpy and the standard library only.
    Without an initialised process group make_mesh raises, and so do the
    trainer's and the pipeline's distribute, rather than make a world of
    one; init_distributed on a host without CUDA raises rather than fall
    back to gloo on the CPU."""
    import ast
    import pkgutil
    walked = {m.name for m in pkgutil.walk_packages(adaprompt_tpu_torch.__path__,
                                                     "adaprompt_tpu_torch.")}
    assert set(PARALLEL_MODULES) <= walked
    banned = ("jax", "jaxlib", "adaprompt_tpu")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE", "LOCAL_RANK")}
    code = ("import importlib, sys\n"
            + "".join(f"importlib.import_module({m!r})\n" for m in PARALLEL_MODULES)
            + "import torch.distributed as dist\n"
            "from adaprompt_tpu_torch.parallel import mesh\n"
            "from adaprompt_tpu_torch.pipeline import StableDiffusionPipeline\n"
            "for fn in (mesh.make_mesh, lambda: StableDiffusionPipeline.distribute(None)):\n"
            "    try:\n"
            "        fn()\n"
            "    except RuntimeError as e:\n"
            "        assert 'initialised process group' in str(e), e\n"
            "    else:\n"
            "        raise SystemExit('no error')\n"
            "assert not dist.is_initialized()\n"
            "import torch\n"
            "if not torch.cuda.is_available():\n"
            "    try:\n"
            "        mesh.init_distributed(rank=0, world_size=1)\n"
            "    except RuntimeError as e:\n"
            "        assert 'CUDA is not available' in str(e), e\n"
            "    else:\n"
            "        raise SystemExit('no error')\n"
            "    assert not dist.is_initialized()\n"
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in {banned!r}))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout
    stdlib = set(sys.stdlib_module_names) | {"__future__"}
    for m in PARALLEL_MODULES:
        path = os.path.join(ROOT, *m.split("."))
        text = open(path + ("/__init__.py" if os.path.isdir(path) else ".py")).read()
        top = [n for n in ast.parse(text).body if isinstance(n, (ast.Import, ast.ImportFrom))]
        names = [a.name for n in top if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in top if isinstance(n, ast.ImportFrom)]
        assert {x.split(".")[0] for x in names} <= stdlib | {"torch", "numpy"}, (m, names)
        assert "import jax" not in text and "adaprompt_tpu." not in text, m


def _int8_cross_args(x, wq, k, v, wo, bo):
    """The fused cross-attention's arguments with int8 weights and scales."""
    return (x, *quantize_weight(wq), k, v, *quantize_weight(wo), bo)


def _int8_geglu_args(x, w1, b1, w2, b2):
    return (x, *quantize_weight(w1), b1, *quantize_weight(w2), b2)


def _small_inputs(device, dtype):
    g = torch.Generator(device=device).manual_seed(0)
    rn = lambda *s: torch.randn(*s, generator=g, device=device).to(dtype)
    flash = (rn(2, 512, 2, 40), rn(2, 512, 2, 40), rn(2, 512, 2, 40))
    cross = (rn(2, 512, 64), rn(64, 64) / 8, rn(2, 77, 2, 32), rn(2, 77, 2, 32),
             rn(64, 64) / 8, rn(64).float() / 8)
    ff = (rn(96, 64), rn(512, 64) / 8, rn(512).float() / 8, rn(64, 256) / 16,
          rn(64).float() / 8)
    conv = (rn(2, 8, 8, 32), rn(16, 32, 3, 3) / 16, rn(16).float() / 8)
    return {
        # x, wq, wk, wv, wo, bo
        "self": (cross[0], cross[1], rn(64, 64) / 8, rn(64, 64) / 8, cross[4], cross[5]),
        "conv": conv,
        "gn_conv": (conv[0], rn(32).float(), rn(32).float()) + conv[1:],
        "flash": flash,
        # q, k, v, key_bias, out, lse, dout
        "flash_bwd": flash + (None, rn(2, 512, 2, 40), rn(4, 512, 1).float(), rn(2, 512, 2, 40)),
        "cross": cross,
        "geglu": ff,
        "cross_int8": _int8_cross_args(*cross),
        "geglu_int8": _int8_geglu_args(*ff),
    }


def test_wrappers_take_plain_version_only_on_cpu():
    """On CPU tensors no kernel launches; on any other device the wrapper
    goes to its kernel and, where that cannot run, raises."""
    before = {n: w.launches for n, w in kernel_wrappers().items()}
    x = _small_inputs("cpu", torch.float32)
    tattn.flash_attention_fwd(*x["flash"], None, 40 ** -0.5)
    tattn.flash_attention_bwd(*x["flash_bwd"], 40 ** -0.5)
    tattn.fused_cross_attention(*x["cross"], 32 ** -0.5, 2)
    tgeglu.geglu(*x["geglu"])
    tattn.fused_cross_attention_int8(*x["cross_int8"], 32 ** -0.5, 2)
    tgeglu.geglu_int8(*x["geglu_int8"])
    tch.gn_silu_conv3x3_halo(*x["gn_conv"])
    tch.conv3x3_halo(*x["conv"])
    tch.conv3x3_im2col(*x["conv"])
    for variant in FLASH_VARIANTS:
        tattn.flash_attention_fwd(*x["flash"], None, 40 ** -0.5, variant)
        tattn.flash_attention(*x["flash"], None, 40 ** -0.5, variant)
    tattn.flash_attention_bwd(*x["flash_bwd"], 40 ** -0.5, tattn.FlashVariant(exp2=True))
    tattn.flash_attention_int8(*x["flash"])
    tattn.fused_self_attention(*x["self"], 32 ** -0.5, 2)
    assert {n: w.launches for n, w in kernel_wrappers().items()} == before
    assert not any(getattr(w, "exp2_launches", 0) for w in kernel_wrappers().values())
    meta = {k: [None if a is None else a.to("meta") for a in v] for k, v in x.items()}
    with pytest.raises(TypeError, match="CUDA"):
        tattn.flash_attention_fwd(*meta["flash"], None, 40 ** -0.5)
    with pytest.raises(TypeError, match="CUDA"):
        tattn.flash_attention_bwd(*meta["flash_bwd"], 40 ** -0.5)
    with pytest.raises(TypeError, match="CUDA"):
        tattn.fused_cross_attention(*meta["cross"], 32 ** -0.5, 2)
    with pytest.raises(TypeError, match="CUDA"):
        tgeglu.geglu(*meta["geglu"])
    with pytest.raises(TypeError, match="CUDA"):
        tattn.fused_cross_attention_int8(*meta["cross_int8"], 32 ** -0.5, 2)
    with pytest.raises(TypeError, match="CUDA"):
        tgeglu.geglu_int8(*meta["geglu_int8"])
    with pytest.raises(TypeError, match="CUDA"):
        tch.gn_silu_conv3x3_halo(*meta["gn_conv"])
    with pytest.raises(TypeError, match="CUDA"):
        tch.conv3x3_halo(*meta["conv"])
    with pytest.raises(TypeError, match="CUDA"):
        tch.conv3x3_im2col(*meta["conv"])
    for variant in FLASH_VARIANTS:
        with pytest.raises(TypeError, match="CUDA"):
            tattn.flash_attention_fwd(*meta["flash"], None, 40 ** -0.5, variant)
        with pytest.raises(TypeError, match="CUDA"):
            tattn.flash_attention(*meta["flash"], None, 40 ** -0.5, variant)
    with pytest.raises(TypeError, match="CUDA"):
        tattn.flash_attention_bwd(*meta["flash_bwd"], 40 ** -0.5, tattn.FlashVariant(exp2=True))
    with pytest.raises(TypeError, match="CUDA"):
        tattn.flash_attention_int8(*meta["flash"])
    with pytest.raises(TypeError, match="CUDA"):
        tattn.fused_self_attention(*meta["self"], 32 ** -0.5, 2)


def test_fused_cross_attention_refuses_gradients_off_the_cpu():
    """The fused cross-attention kernel is forward-only (as the JAX
    package's): off the CPU it raises rather than cut the autograd graph."""
    x = [a.to("meta") for a in _small_inputs("cpu", torch.float32)["cross"]]
    x[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        tattn.fused_cross_attention(*x, 32 ** -0.5, 2)
    with torch.no_grad(), pytest.raises(TypeError, match="CUDA"):
        tattn.fused_cross_attention(*x, 32 ** -0.5, 2)


@pytest.mark.parametrize("name", ["cross_int8", "geglu_int8"])
def test_int8_kernels_refuse_gradients_off_the_cpu(name):
    """The w8a8 kernels are forward only (rounding has no gradient): off the
    CPU a wrapper raises on an input that needs a gradient."""
    fn = {"cross_int8": lambda *a: tattn.fused_cross_attention_int8(*a, 32 ** -0.5, 2),
          "geglu_int8": tgeglu.geglu_int8}[name]
    x = [a.to("meta") for a in _small_inputs("cpu", torch.float32)[name]]
    x[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        fn(*x)
    with torch.no_grad(), pytest.raises(TypeError, match="CUDA"):
        fn(*x)


@pytest.mark.parametrize("name", ["flash_int8", "self"])
def test_unwired_attention_kernels_refuse_gradients_off_the_cpu(name):
    """The int8-QK flash and the fused self-attention kernels are forward
    only (the JAX functions have no custom_vjp): off the CPU a wrapper raises
    on an input that needs a gradient; on the CPU the plain version
    differentiates."""
    fn = {"flash_int8": tattn.flash_attention_int8,
          "self": lambda *a: tattn.fused_self_attention(*a, 32 ** -0.5, 2)}[name]
    key = "flash" if name == "flash_int8" else "self"
    x = [a.to("meta") for a in _small_inputs("cpu", torch.float32)[key]]
    x[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        fn(*x)
    with torch.no_grad(), pytest.raises(TypeError, match="CUDA"):
        fn(*x)
    x = [a.requires_grad_(True) for a in _small_inputs("cpu", torch.float32)[key]]
    fn(*x).sum().backward()
    assert all(a.grad is not None and torch.isfinite(a.grad).all() for a in x[1:])


@pytest.mark.parametrize("name", ["gn_silu_conv3x3_halo", "conv3x3_halo", "conv3x3_im2col"])
def test_conv_kernels_refuse_gradients_off_the_cpu(name):
    """The three conv kernels are forward only (the JAX functions have no
    custom_vjp): off the CPU a wrapper raises on an input that needs a
    gradient, whichever input it is; on the CPU the plain version
    differentiates."""
    fn = getattr(tch, name)
    key = "gn_conv" if name == "gn_silu_conv3x3_halo" else "conv"
    for i in range(len(_small_inputs("cpu", torch.float32)[key])):
        x = [a.to("meta") for a in _small_inputs("cpu", torch.float32)[key]]
        x[i].requires_grad_(True)
        with pytest.raises(RuntimeError, match="forward only"):
            fn(*x)
        with torch.no_grad(), pytest.raises(TypeError, match="CUDA"):
            fn(*x)
    x = [a.requires_grad_(True) for a in _small_inputs("cpu", torch.float32)[key]]
    fn(*x).sum().backward()
    assert all(a.grad is not None and torch.isfinite(a.grad).all() for a in x)


def test_kernel_sources_and_wrappers_exist():
    from adaprompt_tpu_torch.ops import cuda_build
    for name in cuda_build.SOURCES:
        assert (cuda_build.CSRC / f"{name}.cu").is_file()
    assert set(kernel_wrappers()) == {"flash_attention_fwd", "flash_attention_bwd",
                                      "fused_cross_attention", "geglu_fwd",
                                      "fused_cross_attention_int8", "geglu_int8",
                                      "gn_silu_conv3x3_halo", "conv3x3_halo", "conv3x3_im2col",
                                      "flash_attention_int8", "fused_self_attention",
                                      "flash_attention_fwd_ilv", "flash_attention_fwd_nomax"}
    assert set(cuda_build.SOURCES) == {"flash_attention", "flash_attention_bwd",
                                       "fused_cross_attention", "geglu",
                                       "fused_cross_attention_int8", "geglu_int8", "conv_halo",
                                       "flash_attention_ilv", "flash_attention_nomax",
                                       "flash_attention_int8", "fused_self_attention"}
    for lib, fn in (("flash_attention", "flash_attention_fwd"),
                    ("flash_attention_bwd", "flash_attention_bwd"),
                    ("flash_attention_ilv", "flash_attention_fwd_ilv"),
                    ("flash_attention_nomax", "flash_attention_fwd_nomax"),
                    ("flash_attention_int8", "flash_attention_int8_fwd"),
                    ("fused_self_attention", "fused_self_attention_fwd")):
        assert f'extern "C" int {fn}(' in (cuda_build.CSRC / f"{lib}.cu").read_text()
    src = (cuda_build.CSRC / "conv_halo.cu").read_text()
    for fn in ("gn_silu_conv3x3_halo_fwd", "conv3x3_halo_fwd", "conv3x3_im2col_fwd"):
        assert f'extern "C" int {fn}(' in src
    assert adaprompt_tpu_torch.__version__


def test_library_path_covers_included_headers(monkeypatch, tmp_path):
    """A kernel's library name hashes its source and every csrc header the
    source includes, directly or through another header: editing any of
    them names a new library, so a stale build is never loaded."""
    from adaprompt_tpu_torch.ops import cuda_build
    flash = [p.name for p in cuda_build.source_files("flash_attention")]
    assert flash == ["flash_attention.cu", "flash_sm90.cuh"]
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "kern.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint x;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "unused.cuh").write_text("// not included\n")
    first = cuda_build.library_path("kern")
    assert first.parent == tmp_path / "build" and first.name.startswith("kern-")
    assert [p.name for p in cuda_build.source_files("kern")] == ["kern.cu", "a.cuh", "b.cuh"]
    (tmp_path / "unused.cuh").write_text("// edited\n")
    assert cuda_build.library_path("kern") == first
    seen = {first}
    for name, text in (("b.cuh", "// b, edited\n"), ("a.cuh", '#include "b.cuh"\n// edited\n'),
                       ("kern.cu", '#include "a.cuh"\nint y;\n')):
        (tmp_path / name).write_text(text)
        path = cuda_build.library_path("kern")
        assert path not in seen, name
        seen.add(path)


def test_flash_backward_source_structure():
    """The backward kernel is built on the Hopper helpers the forwards share
    (cp.async, ldmatrix, mma.sync in flash_sm90.cuh), not on WMMA; its
    library's name hashes that header; its C call and its describe function
    are there."""
    from adaprompt_tpu_torch.ops import cuda_build
    src = (cuda_build.CSRC / "flash_attention_bwd.cu").read_text()
    assert '#include "flash_sm90.cuh"' in src
    assert "wmma::" not in src and "<mma.h>" not in src
    assert [p.name for p in cuda_build.source_files("flash_attention_bwd")] == [
        "flash_attention_bwd.cu", "flash_sm90.cuh"]
    for fn in ("flash_attention_bwd", "flash_attention_bwd_describe"):
        assert f'extern "C" int {fn}(' in src


def test_geglu_source_structure():
    """B3 is built on the block-GEMM main loop of block_gemm.cuh, over the
    Hopper helpers of flash_sm90.cuh (cp.async, ldmatrix, mma.sync), not on
    WMMA; its library's name hashes both headers; its C call and its
    describe function are there."""
    from adaprompt_tpu_torch.ops import cuda_build
    src = (cuda_build.CSRC / "geglu.cu").read_text()
    assert '#include "block_gemm.cuh"' in src
    assert '#include "flash_sm90.cuh"' in (cuda_build.CSRC / "block_gemm.cuh").read_text()
    assert "wmma::" not in src and "<mma.h>" not in src
    assert "struct BlockGemm" not in src and "struct Staging" not in src
    assert sorted(p.name for p in cuda_build.source_files("geglu")) == [
        "block_gemm.cuh", "flash_sm90.cuh", "geglu.cu"]
    for fn in ("geglu_fwd", "geglu_describe"):
        assert f'extern "C" int {fn}(' in src


def test_fused_cross_source_structure():
    """B2 is built on the same block-GEMM main loop and Hopper helpers as
    B3, not on WMMA; its library's name hashes both headers; its C call and
    its describe function are there, and no `fused_cross_kernel` is left for
    the profile to file."""
    from adaprompt_tpu_torch.ops import cuda_build
    src = (cuda_build.CSRC / "fused_cross_attention.cu").read_text()
    assert '#include "block_gemm.cuh"' in src
    assert "wmma::" not in src and "<mma.h>" not in src
    assert "\nfused_cross_kernel(" not in src
    assert sorted(p.name for p in cuda_build.source_files("fused_cross_attention")) == [
        "block_gemm.cuh", "flash_sm90.cuh", "fused_cross_attention.cu"]
    for fn in ("fused_cross_attention_fwd", "fused_cross_describe"):
        assert f'extern "C" int {fn}(' in src
    for kernel in ("cross_q_attn_kernel", "cross_out_kernel"):
        assert f"\n{kernel}(" in src


def test_int8_geglu_source_structure():
    """B6 is built on the int8 sibling of the block-GEMM main loop
    (BlockGemmS8 of block_gemm.cuh, which keeps the bf16 BlockGemm and
    Staging that B2 and B3 share) and on the row passes and out-projection
    it shares with B5 (int8_rows.cuh); its library's name hashes the three
    headers; its C call, its workspace size and its describe function are
    there, and no `geglu_int8_kernel` is left for the profile to file."""
    from adaprompt_tpu_torch.ops import cuda_build
    src = (cuda_build.CSRC / "geglu_int8.cu").read_text()
    assert '#include "block_gemm.cuh"' in src and '#include "int8_rows.cuh"' in src
    assert "\ngeglu_int8_kernel(" not in src
    assert sorted(p.name for p in cuda_build.source_files("geglu_int8")) == [
        "block_gemm.cuh", "flash_sm90.cuh", "geglu_int8.cu", "int8_rows.cuh"]
    for fn in ("geglu_int8_fwd", "geglu_int8_workspace", "geglu_int8_describe"):
        assert f'extern "C" int {fn}(' in src
    for kernel in ("geglu_int8_quant_x_kernel", "geglu_int8_proj_kernel",
                   "geglu_int8_quant_g_kernel", "geglu_int8_out_kernel"):
        assert f"\n{kernel}(" in src
    header = (cuda_build.CSRC / "block_gemm.cuh").read_text()
    for struct in ("struct BlockGemmS8", "struct BlockGemm ", "struct Staging"):
        assert struct in header
    assert "m16n8k32.row.col.s32.s8.s8.s32" in header


def test_int8_fused_cross_source_structure():
    """B5 is four kernels on BlockGemmS8 and the row passes and
    out-projection it shares with B6 (int8_rows.cuh), not on WMMA; its
    library's name hashes exactly the headers it includes; its C call, its
    workspace size and its describe function are there, and no
    `fused_cross_int8_kernel` is left for the profile to file."""
    from adaprompt_tpu_torch.ops import cuda_build
    src = (cuda_build.CSRC / "fused_cross_attention_int8.cu").read_text()
    assert '#include "block_gemm.cuh"' in src and '#include "int8_rows.cuh"' in src
    assert "BlockGemmS8<" in src
    assert "wmma::" not in src and "<mma.h>" not in src
    assert "\nfused_cross_int8_kernel(" not in src
    assert sorted(p.name for p in cuda_build.source_files("fused_cross_attention_int8")) == [
        "block_gemm.cuh", "flash_sm90.cuh", "fused_cross_attention_int8.cu", "int8_rows.cuh"]
    for fn in ("fused_cross_attention_int8_fwd", "fused_cross_int8_workspace",
               "fused_cross_int8_describe"):
        assert f'extern "C" int {fn}(' in src
    for kernel in ("cross_int8_quant_x_kernel", "cross_int8_q_attn_kernel",
                   "cross_int8_quant_o_kernel", "cross_int8_out_kernel"):
        assert f"\n{kernel}(" in src
    header = (cuda_build.CSRC / "int8_rows.cuh").read_text()
    assert "__global__ void" not in header
    for body in ("quant_x_rows", "quant_partial_rows", "out_tile", "launch_after"):
        assert f" {body}(" in header and re.search(rf"\b{body}(<[^>]*>)?\(", src), body


def test_int8_flash_source_structure():
    """B10 is B1's register-resident forward on the Hopper helpers of
    flash_sm90.cuh, with q.k^T on the int8 mma.sync and its int8 operands made
    by its own kernels: no WMMA, no score or P buffer in shared memory (Ss,
    Ps), no byte transposes of K; its library's name hashes exactly the
    headers it includes; its C call, its workspace layout, its key pass and
    its describe function are there, with its three kernels."""
    from adaprompt_tpu_torch.ops import cuda_build
    src = (cuda_build.CSRC / "flash_attention_int8.cu").read_text()
    assert '#include "flash_sm90.cuh"' in src and '#include "int8_rows.cuh"' in src
    assert "wmma::" not in src and "<mma.h>" not in src
    assert not re.search(r"\b(Ss|Ps|Os)\b", src)
    assert "m16n8k16.row.col.s32.s8.s8.s32" in src and "mma_s8_16832(" in src
    assert sorted(p.name for p in cuda_build.source_files("flash_attention_int8")) == [
        "block_gemm.cuh", "flash_attention_int8.cu", "flash_sm90.cuh", "int8_rows.cuh"]
    for fn in ("flash_attention_int8_fwd", "flash_attention_int8_workspace",
               "flash_attention_int8_keys", "flash_attention_int8_describe"):
        assert f'extern "C" int {fn}(' in src
    for kernel in ("flash_int8_key_sum_kernel", "flash_int8_key_quant_kernel",
                   "flash_fwd_int8_kernel"):
        assert f"\n{kernel}(" in src
    for step in ("add_key_bias<", "mask_keys_past<", "pv_product<", "store_rows<", "ldmatrix_x4("):
        assert step in src, step
    for body in ("row_scale", "quantize8", "wait_for_predecessor", "launch_after"):
        assert f"int8_rows::{body}" in src, body


def test_conv_source_structure():
    """B7, B8 and B9 are implicit GEMMs on the Hopper helpers of flash_sm90.cuh
    (cp.async, ldmatrix plain and transposed, mma.sync), with no WMMA and no
    patch tile anywhere; B8's and B7's globals run one halo loop, B7's with
    its producer pass over each landed halo; B7's C call launches its
    statistics kernel, its conv and its splits' sum, with no atomics; the
    library's name hashes the one header the source includes; the C
    functions are there."""
    from adaprompt_tpu_torch.ops import cuda_build
    src = (cuda_build.CSRC / "conv_halo.cu").read_text()
    assert "wmma" not in src and "<mma.h>" not in src and "PS_ELEMS" not in src
    assert not re.search(r"\batomic\w*\(", src)              # fixed-order sums only
    for helper in ("cp_async_16(", "ldmatrix_x4(", "ldmatrix_x4_trans(", "mma_bf16_16816("):
        assert helper in src, helper

    def body(head):
        text = src[src.index(head):]
        return text[:text.index("\n}\n")]

    for kernel in ("\nconv3x3_im2col_mma_kernel(", "void halo_conv("):
        assert "cp_async_16(" in body(kernel) and "tile_product<T>(" in body(kernel), kernel
    assert "gn_silu_pass(" in body("void halo_conv(")
    assert "halo_conv<false>(" in body("\nconv3x3_halo_mma_kernel(")
    assert "halo_conv<true>(" in body("\ngn_silu_conv3x3_mma_kernel(")
    assert "group_walk_any(" in body("\ngn_silu_conv3x3_stats_kernel(")
    assert "split_sum(" in body("void gn_silu_conv3x3_sum_kernel(")
    fwd = body('extern "C" int gn_silu_conv3x3_halo_fwd(')
    for launch in ("launch_stats(", "gn_silu_conv3x3_mma_kernel<<<",
                   "launch_sum(gn_silu_conv3x3_sum_kernel"):
        assert launch in fwd, launch
    assert "gn_silu_conv3x3_stats_kernel<<<" in body("int launch_stats(")
    assert re.findall(r'^#include "([^"]+)"', src, re.M) == ["flash_sm90.cuh"]
    assert [p.name for p in cuda_build.source_files("conv_halo")] == [
        "conv_halo.cu", "flash_sm90.cuh"]
    for fn in ("conv3x3_halo_fwd", "conv3x3_im2col_fwd", "gn_silu_conv3x3_halo_fwd",
               "conv_halo_describe", "gn_silu_conv_describe", "gn_silu_conv_workspace",
               "gn_silu_conv_stats"):
        assert f'extern "C" int {fn}(' in src


@pytest.mark.parametrize("o", [20, 48])
def test_gn_silu_conv_wrapper_makes_no_operand_in_pytorch(monkeypatch, o):
    """Off the CPU the fused wrapper hands x as it is and gs, gb as float32 to
    its one C call (no `gn_affine` in PyTorch) with a uint8 workspace of the
    size the layout function states at the planned k splits; it pads O = 20
    to 24 (the packed weight's and the bias's columns) and drops the padding
    from what it returns, passes O = 48 as it is, counts one launch a call,
    and refuses C not a multiple of 8, a scale of another width and inputs
    that need a gradient before the call."""
    calls, sizes = [], []
    monkeypatch.setattr(tch, "gn_affine",
                        lambda *a, **kw: pytest.fail("the wrapper made the affine in PyTorch"))
    monkeypatch.setattr(tch.cuda_build, "kernel_operands", lambda what, *t, **kw: list(t))
    monkeypatch.setattr(tch, "_sm_count", lambda index: tch.H100_SMS)
    monkeypatch.setattr(tch, "_gn_conv_workspace_bytes",
                        lambda *shape: sizes.append(shape) or 4096)
    monkeypatch.setattr(tch, "gn_silu_conv_kernel_call", lambda *a, **kw: calls.append((a, kw)))
    meta = lambda *s, dtype=torch.bfloat16: torch.empty(*s, device="meta", dtype=dtype)
    x, op = meta(2, 9, 17, 64), -(-o // 8) * 8
    args = (x, meta(64), meta(64), meta(o, 64, 3, 3), meta(o))
    before = tch.gn_silu_conv3x3_halo.launches
    with torch.no_grad():
        out = tch.gn_silu_conv3x3_halo(*args, eps=1e-6)
    assert tch.gn_silu_conv3x3_halo.launches == before + 1 and len(calls) == 1
    (cx, gs, gb, packed, bias, work, cout, groups, eps, splits), kw = calls[0]
    assert cx is x and not kw and groups == 32 and eps == 1e-6
    assert gs.dtype == gb.dtype == bias.dtype == torch.float32
    assert gs.shape == gb.shape == (64,) and bias.shape == (op,)
    assert packed.shape == (9, 64, op) and packed.dtype == torch.bfloat16
    assert splits == tch.conv_plan("halo", 2, 9, 17, 64, op).splits
    assert sizes == [(2, 9, 17, 64, op, 32, splits)]
    assert work.dtype == torch.uint8 and work.numel() == 4096
    assert cout.shape == (2, 9, 17, op) and cout.dtype == torch.bfloat16
    assert out.shape == (2, 9, 17, o) and (out is cout) == (o == op)
    with torch.no_grad(), pytest.raises(ValueError, match="C=36"):
        tch.gn_silu_conv3x3_halo(meta(2, 9, 17, 36), meta(36), meta(36), meta(o, 36, 3, 3),
                                 meta(o), num_groups=4)
    with torch.no_grad(), pytest.raises(ValueError, match="gn_scale"):
        tch.gn_silu_conv3x3_halo(x, meta(32), *args[2:])
    with pytest.raises(RuntimeError, match="forward only"):
        tch.gn_silu_conv3x3_halo(x.clone().requires_grad_(True), *args[1:])
    assert tch.gn_silu_conv3x3_halo.launches == before + 1 and len(calls) == 1


def test_int8_flash_wrapper_makes_no_operand_in_pytorch(monkeypatch):
    """Off the CPU the int8 wrapper hands q, k, v as they are to its one C
    call (no `int8_qk_operands`, no fold or transpose copy) and counts one
    launch; the C call gets a workspace of the size the C side states and
    writes a contiguous [B, Sq, H, D] output."""
    calls = []
    monkeypatch.setattr(tattn, "int8_qk_operands",
                        lambda *a: pytest.fail("the wrapper made the operands in PyTorch"))
    monkeypatch.setattr(tattn, "_int8_flash_layout", lambda *shape: (4096,) + (0,) * 6)
    monkeypatch.setattr(tattn.cuda_build, "kernel_operands", lambda what, *t, **kw: list(t))
    monkeypatch.setattr(tattn, "int8_flash_kernel_call",
                        lambda *a, **kw: calls.append((a, kw)))
    meta = lambda *s, dtype=torch.bfloat16: torch.empty(*s, device="meta", dtype=dtype)
    q, k, v = meta(2, 70, 3, 16), meta(2, 90, 3, 16), meta(2, 90, 3, 16)
    before = tattn.flash_attention_int8.launches
    with torch.no_grad():
        out = tattn.flash_attention_int8(q, k, v, meta(2, 90, dtype=torch.float64), 0.25)
    assert tattn.flash_attention_int8.launches == before + 1 and len(calls) == 1
    (cq, ck, cv, cbias, work, cout, scale), kw = calls[0]
    assert cq.shape == q.shape and ck.shape == k.shape and cv.shape == v.shape
    assert cbias.dtype == torch.float32 and cbias.shape == (2, 90)
    assert work.numel() == 4096 and work.dtype == torch.uint8
    assert cout is out and out.shape == q.shape and scale == 0.25 and not kw


@pytest.mark.parametrize("shape", [dict(c=72), dict(keys=81), dict(c=336, heads=2)])
def test_int8_fused_cross_wrapper_refuses_shapes_it_cannot_take(shape):
    """Off the CPU the int8 wrapper names a shape that the kernels cannot
    take (C not a multiple of 16, more than 80 keys, a head dim over 160)
    before it reaches the C call; head dims 12 (not a multiple of 8) and 160
    pass on to it, where meta tensors raise TypeError ("CUDA")."""
    meta = lambda *s, dtype=torch.float32: torch.empty(*s, device="meta", dtype=dtype)

    def args(c, heads, keys):
        hd = c // heads
        return (meta(2, 10, c, dtype=torch.bfloat16), meta(c, c, dtype=torch.int8), meta(c),
                meta(2, keys, heads, hd, dtype=torch.bfloat16),
                meta(2, keys, heads, hd, dtype=torch.bfloat16), meta(c, c, dtype=torch.int8),
                meta(c), meta(c), hd ** -0.5, heads)

    c, heads, keys = shape.get("c", 64), shape.get("heads", 2), shape.get("keys", 77)
    hd = c // heads
    with torch.no_grad(), pytest.raises(
            ValueError, match=f"C={c}" if c % 16 else f"head dim {hd} and {keys} keys"):
        tattn.fused_cross_attention_int8(*args(c, heads, keys))
    for ok in ((96, 8, 77), (320, 2, 77)):       # hd = 12 and 160
        with torch.no_grad(), pytest.raises(TypeError, match="CUDA"):
            tattn.fused_cross_attention_int8(*args(*ok))


@pytest.mark.parametrize("c,f", [(1280, 5120), (320, 1280), (48, 64)])
def test_int8_geglu_wrapper_takes_any_width_it_can(c, f):
    """Off the CPU the int8 wrapper passes C=1280 (F=5120) on to the kernels,
    where the old shared-memory layout capped C at 640 and F at 2560: on meta
    tensors it raises TypeError ("CUDA") before the C call."""
    meta = lambda *s, dtype=torch.float32: torch.empty(*s, device="meta", dtype=dtype)
    args = (meta(70, c, dtype=torch.bfloat16), meta(2 * f, c, dtype=torch.int8), meta(2 * f),
            meta(2 * f), meta(c, f, dtype=torch.int8), meta(c), meta(c))
    with torch.no_grad(), pytest.raises(TypeError, match="CUDA"):
        tgeglu.geglu_int8(*args)


@pytest.mark.parametrize("c,f", [(72, 288), (320, 1312)])
def test_int8_geglu_wrapper_refuses_shapes_it_cannot_take(c, f):
    """Off the CPU the int8 wrapper names a width that the kernels cannot take
    (C not a multiple of 16, F not a multiple of 64) before the C call."""
    meta = lambda *s, dtype=torch.float32: torch.empty(*s, device="meta", dtype=dtype)
    args = (meta(70, c, dtype=torch.bfloat16), meta(2 * f, c, dtype=torch.int8), meta(2 * f),
            meta(2 * f), meta(c, f, dtype=torch.int8), meta(c), meta(c))
    with torch.no_grad(), pytest.raises(ValueError, match=f"C={c}, F={f}"):
        tgeglu.geglu_int8(*args)


@pytest.mark.parametrize("c,heads,match", [(72, 1, "C=72"), (96, 8, "head dim \\(12\\)"),
                                           (1296, 9, "C=1296"), (640, 1, "head dim 640"),
                                           (1248, 2, "head dim 624")])
def test_fused_self_wrapper_refuses_shapes_it_cannot_take(c, heads, match):
    """Off the CPU the fused self-attention wrapper names a shape that the
    kernels cannot take (C not a multiple of 16 or above 1280, a head dim not
    a multiple of 8 or above 480) before the C call; head dims up to 480 pass
    on to it."""
    meta = lambda *s: torch.empty(*s, device="meta")
    w = lambda n: meta(n, n)
    with torch.no_grad(), pytest.raises(ValueError, match=match):
        tattn.fused_self_attention(meta(2, 10, c), w(c), w(c), w(c), w(c), meta(c),
                                   (c // heads) ** -0.5, heads)
    for c, heads in ((1280, 8), (320, 2), (64, 8), (320, 1), (960, 2)):
        with torch.no_grad(), pytest.raises(TypeError, match="CUDA"):
            tattn.fused_self_attention(meta(2, 10, c), w(c), w(c), w(c), w(c), meta(c),
                                       (c // heads) ** -0.5, heads)


@pytest.mark.parametrize("shape", [dict(c=72), dict(keys=81), dict(c=320, heads=1),
                                   dict(c=336, heads=2)])
def test_fused_cross_wrapper_refuses_shapes_it_cannot_take(shape):
    """Off the CPU the wrapper names a shape that the kernels cannot take (C
    not a multiple of 16, more than 80 keys, a head dim over 160) before it
    reaches the C call; 77 keys and head dims up to 160 pass on to it."""
    c, heads, keys = shape.get("c", 64), shape.get("heads", 2), shape.get("keys", 77)
    hd = c // heads
    meta = lambda *s: torch.empty(*s, device="meta")
    args = (meta(2, 10, c), meta(c, c), meta(2, keys, heads, hd), meta(2, keys, heads, hd),
            meta(c, c), meta(c), hd ** -0.5, heads)
    with pytest.raises(ValueError, match=f"{c}" if c % 16 else f"head dim {hd} and {keys} keys"):
        tattn.fused_cross_attention(*args)
    ok = (meta(2, 10, 320), meta(320, 320), meta(2, 77, 2, 160), meta(2, 77, 2, 160),
          meta(320, 320), meta(320), 160 ** -0.5, 2)
    with pytest.raises(TypeError, match="CUDA"):
        tattn.fused_cross_attention(*ok)


# B5's four kernels as the profiler names them (the out kernel is templated
# on its tile, as B6's)
_B5_KERNEL_NAMES = [
    "_ZN12_GLOBAL__N_125cross_int8_quant_x_kernelEPK13__nv_bfloat16PaPfii",
    "void (anonymous namespace)::cross_int8_q_attn_kernel<48>(signed char const*, float const*, "
    "signed char const*, float const*, __nv_bfloat16 const*, __nv_bfloat16 const*, float*, "
    "float*, int, int, int, int, float)",
    "_ZN12_GLOBAL__N_125cross_int8_quant_o_kernelEPKfS1_PaPfiii",
    "void (anonymous namespace)::cross_int8_out_kernel<(anonymous namespace)::Out>(signed char "
    "const*, float const*, signed char const*, float const*, float const*, __nv_bfloat16*, int, "
    "int)"]


# B10's three kernels as the profiler names them (each templated on D / 8)
_B10_KERNEL_NAMES = [
    "void (anonymous namespace)::flash_int8_key_sum_kernel<5>(__nv_bfloat16 const*, float*, "
    "int, int)",
    "_ZN12_GLOBAL__N_127flash_int8_key_quant_kernelILi10EEEvPK13__nv_bfloat16PKfPaPfPS1_iif",
    "void (anonymous namespace)::flash_fwd_int8_kernel<5>(__nv_bfloat16 const*, signed char "
    "const*, float const*, __nv_bfloat16 const*, float const*, __nv_bfloat16*, signed char*, "
    "float*, int, int, int, float)"]


# B11's two kernels as the profiler names them (the q-attention kernel
# templated on its tile)
_B11_KERNEL_NAMES = [
    "void (anonymous namespace)::self_q_attn_kernel<48, 5, 48>(__nv_bfloat16 const*, "
    "__nv_bfloat16 const*, __nv_bfloat16 const*, float const*, __nv_bfloat16*, int, int, int, "
    "float)",
    "_ZN12_GLOBAL__N_115self_out_kernelEPK13__nv_bfloat16S2_PKfPS0_ii"]


@pytest.mark.parametrize("name,label", [
    ("void (anonymous namespace)::geglu_proj_kernel(__nv_bfloat16 const*, int, int, int)",
     "geglu_fwd"),
    ("_ZN12_GLOBAL__N_116geglu_out_kernelEPK13__nv_bfloat16S2_PKfPS0_iii", "geglu_fwd"),
    ("_ZN12_GLOBAL__N_125geglu_int8_quant_x_kernelEPK13__nv_bfloat16PaPfii", "geglu_int8"),
    ("void (anonymous namespace)::geglu_int8_proj_kernel(signed char const*, float const*, "
     "signed char const*, float const*, float const*, float*, float*, int, int, int)",
     "geglu_int8"),
    ("_ZN12_GLOBAL__N_125geglu_int8_quant_g_kernelEPKfS1_PaPfii", "geglu_int8"),
    ("void (anonymous namespace)::geglu_int8_out_kernel(signed char const*, float const*, "
     "signed char const*, float const*, float const*, __nv_bfloat16*, int, int, int)",
     "geglu_int8"),
    ("flash_fwd_kernel<5, false>", "flash_attention_fwd"),
    ("void (anonymous namespace)::cross_q_attn_kernel<48>(__nv_bfloat16 const*, int, float)",
     "fused_cross_attention"),
    ("_ZN12_GLOBAL__N_116cross_out_kernelEPK13__nv_bfloat16S2_PKfPS0_ii",
     "fused_cross_attention"),
] + [(name, "fused_cross_attention_int8") for name in _B5_KERNEL_NAMES]
   + [(name, "flash_attention_int8") for name in _B10_KERNEL_NAMES]
   + [(name, "fused_self_attention") for name in _B11_KERNEL_NAMES])
def test_profile_step_classes_kernels_by_name(name, label):
    """The profile's kernel classes: both of B3's kernels count as its
    wrapper's, as both of B2's count as B2's, all four of B6's (whose names
    contain no B3 kernel's name) as B6's, all four of B5's as B5's and all
    three of B10's (whose names contain no B1 kernel's name) as B10's."""
    from adaprompt_tpu_torch.profile_step import kernel_class
    assert kernel_class(name) == label


@pytest.mark.parametrize("name", _B5_KERNEL_NAMES)
def test_profile_step_files_no_int8_cross_kernel_under_b2_or_b6(name):
    """No kernel of B5 is filed as one of B2 (whose kernel names differ
    from B5's by "int8_") or B6 (whose row passes and out kernel share B5's
    device code under other names)."""
    from adaprompt_tpu_torch.profile_step import OUR_KERNELS, kernel_class
    assert kernel_class(name) not in ("fused_cross_attention", "geglu_int8")
    assert len([key for key in OUR_KERNELS if key in name]) == 1


@pytest.mark.parametrize("name", _B10_KERNEL_NAMES)
def test_profile_step_files_no_int8_flash_kernel_under_b1(name):
    """No kernel of B10 is filed as B1's forward (`flash_fwd_kernel`) or as
    the no-max kernel's key pre-pass: exactly one key of the table names it."""
    from adaprompt_tpu_torch.profile_step import OUR_KERNELS, kernel_class
    assert kernel_class(name) not in ("flash_attention_fwd", "flash_attention_fwd_nomax")
    assert len([key for key in OUR_KERNELS if key in name]) == 1


@pytest.mark.parametrize("name", _B11_KERNEL_NAMES)
def test_profile_step_files_no_self_attention_kernel_under_b1_or_b2(name):
    """No kernel of B11 is filed as B1's forward or as B2's, whose q-attention
    and out kernels B11's resemble: exactly one key of the table names it."""
    from adaprompt_tpu_torch.profile_step import OUR_KERNELS, kernel_class
    assert kernel_class(name) not in ("flash_attention_fwd", "fused_cross_attention")
    assert len([key for key in OUR_KERNELS if key in name]) == 1


# B8's and B9's kernels (each a main kernel and its k splits' sum) as the
# profiler names them, and B7's three (statistics, conv, sum), which share
# their source
_CONV_KERNEL_NAMES = [
    ("void (anonymous namespace)::conv3x3_halo_mma_kernel(__nv_bfloat16 const*, __nv_bfloat16 "
     "const*, float const*, __nv_bfloat16*, float*, int, int, int, int, int)", "conv3x3_halo"),
    ("_ZN12_GLOBAL__N_123conv3x3_halo_sum_kernelEPKfS1_P13__nv_bfloat16lii", "conv3x3_halo"),
    ("void (anonymous namespace)::conv3x3_im2col_mma_kernel(__nv_bfloat16 const*, __nv_bfloat16 "
     "const*, float const*, __nv_bfloat16*, float*, int, int, int, int, int)", "conv3x3_im2col"),
    ("_ZN12_GLOBAL__N_125conv3x3_im2col_mma_kernelEPK13__nv_bfloat16S2_PKfPS0_Pfiiiii",
     "conv3x3_im2col"),
    ("void (anonymous namespace)::conv3x3_im2col_sum_kernel(float const*, float const*, "
     "__nv_bfloat16*, long, int, int)", "conv3x3_im2col"),
    ("void (anonymous namespace)::gn_silu_conv3x3_stats_kernel(__nv_bfloat16 const*, float "
     "const*, float const*, float*, int, int, int, float)", "gn_silu_conv3x3_halo"),
    ("void (anonymous namespace)::gn_silu_conv3x3_mma_kernel(__nv_bfloat16 const*, float const*, "
     "__nv_bfloat16 const*, float const*, __nv_bfloat16*, float*, int, int, int, int, int)",
     "gn_silu_conv3x3_halo"),
    ("_ZN12_GLOBAL__N_126gn_silu_conv3x3_sum_kernelEPKfS1_P13__nv_bfloat16lii",
     "gn_silu_conv3x3_halo")]


@pytest.mark.parametrize("name,label", _CONV_KERNEL_NAMES)
def test_profile_step_files_conv_kernels_under_their_wrappers(name, label):
    """B8's and B9's kernels count as their wrappers' and never as cuDNN's
    convolutions (whose class takes any other name with "conv" in it); B7's
    three, which share B8's loop, stay its own: exactly one key of the table
    names each."""
    from adaprompt_tpu_torch.profile_step import OUR_KERNELS, kernel_class
    assert kernel_class(name) == label != "convolution (cuDNN)"
    assert len([key for key in OUR_KERNELS if key in name]) == 1


@pytest.mark.parametrize("exp2", [False, True])
def test_flash_backward_wrapper_off_the_card(monkeypatch, exp2):
    """On CPU tensors the backward wrapper returns its plain version and
    never reaches the kernel's C call nor counts a launch; on meta tensors it
    raises TypeError before the call."""
    calls = []
    monkeypatch.setattr(tattn, "flash_bwd_kernel_call", lambda *a: calls.append(a))
    variant = tattn.FlashVariant(exp2=exp2)
    x = _small_inputs("cpu", torch.float32)["flash_bwd"]
    before = (tattn.flash_attention_bwd.launches, tattn.flash_attention_bwd.exp2_launches)
    got = tattn.flash_attention_bwd(*x, 40 ** -0.5, variant)
    for a, ref in zip(got, tattn.flash_attention_bwd_reference(*x, 40 ** -0.5, exp2)):
        assert torch.equal(a, ref)
    meta = [None if a is None else a.to("meta") for a in x]
    with pytest.raises(TypeError, match="CUDA"):
        tattn.flash_attention_bwd(*meta, 40 ** -0.5, variant)
    assert not calls
    assert (tattn.flash_attention_bwd.launches,
            tattn.flash_attention_bwd.exp2_launches) == before


def _assert_near(out, ref, tol):
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    assert math.isfinite(err) and err <= tol * ref.float().abs().max().item(), err


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    """bf16 on the card; tolerance relative to the plain output's max."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    x = _small_inputs("cuda", torch.bfloat16)
    before = {n: w.launches for n, w in kernel_wrappers().items()}
    _assert_near(tattn.flash_attention_fwd(*x["flash"], None, 40 ** -0.5)[0],
                 tattn.attention_reference(*x["flash"], None, 40 ** -0.5)[0], 2e-2)
    _assert_near(tattn.fused_cross_attention(*x["cross"], 32 ** -0.5, 2),
                 tattn.fused_cross_attention_reference(*x["cross"], 32 ** -0.5, 2), 2e-2)
    _assert_near(tgeglu.geglu(*x["geglu"]), tgeglu.geglu_reference(*x["geglu"]), 1e-2)
    _assert_near(tattn.fused_cross_attention_int8(*x["cross_int8"], 32 ** -0.5, 2),
                 tattn.fused_cross_attention_int8_reference(*x["cross_int8"], 32 ** -0.5, 2),
                 2e-2)
    _assert_near(tgeglu.geglu_int8(*x["geglu_int8"]),
                 tgeglu.geglu_int8_reference(*x["geglu_int8"]), 2e-2)
    out, lse = tattn.flash_attention_fwd(*x["flash"], None, 40 ** -0.5)
    args = x["flash"] + (None, out, lse, x["flash_bwd"][-1], 40 ** -0.5)
    for got, ref in zip(tattn.flash_attention_bwd(*args),
                        tattn.flash_attention_bwd_reference(*args)):
        _assert_near(got, ref, 1e-2)
    conv = [a.contiguous() for a in x["conv"]]
    gn_conv = [a.contiguous() for a in x["gn_conv"]]
    _assert_near(tch.conv3x3_halo(*conv), tch.conv3x3_halo_reference(*conv), 2e-2)
    _assert_near(tch.conv3x3_im2col(*conv), tch.conv3x3_im2col_reference(*conv), 2e-2)
    _assert_near(tch.gn_silu_conv3x3_halo(*gn_conv),
                 tch.gn_silu_conv3x3_halo_reference(*gn_conv), 2e-2)
    for variant in (tattn.FlashVariant(ilv=True), tattn.FlashVariant(nomax=True)):
        _assert_near(tattn.flash_attention_fwd(*x["flash"], None, 40 ** -0.5, variant)[0],
                     tattn.flash_attention_fwd_reference(*x["flash"], None, 40 ** -0.5,
                                                         variant)[0], 2e-2)
    _assert_near(tattn.flash_attention_int8(*x["flash"]),
                 tattn.flash_attention_int8_reference(*x["flash"]), 2e-2)
    _assert_near(tattn.fused_self_attention(*x["self"], 32 ** -0.5, 2),
                 tattn.fused_self_attention_reference(*x["self"], 32 ** -0.5, 2), 2e-2)
    after = {n: w.launches for n, w in kernel_wrappers().items()}
    assert after == {n: before[n] + (2 if n == "flash_attention_fwd" else 1) for n in after}


def _flash_bias(kind, b, sk, g):
    """None, or a [B, Sk] key bias: ~40% of keys masked at random; under
    "tile" also every key of row 0's first 64-key tile; under "row" every
    key of the last row."""
    if kind is None:
        return None
    bias = torch.where(torch.rand(b, sk, device="cuda", generator=g) < 0.6, 0.0, tattn.NEG_BIG)
    if kind == "tile":
        bias[0, :64] = tattn.NEG_BIG
    if kind == "row":
        bias[-1] = tattn.NEG_BIG
    return bias


@pytest.mark.cuda
@pytest.mark.parametrize("exp2", [False, True])
@pytest.mark.parametrize("b,sq,sk,h,d,bias", [(1, 300, 200, 3, 64, "random"),
                                              (2, 100, 77, 2, 80, "random"),
                                              (1, 129, 1000, 1, 128, None),
                                              (2, 64, 64, 4, 8, None),
                                              (2, 200, 50, 2, 16, "random"),
                                              (2, 333, 300, 2, 40, "tile"),
                                              (2, 257, 190, 2, 40, "row")])
def test_flash_kernel_ragged_shapes(b, sq, sk, h, d, bias, exp2):
    """Ragged q and key tiles with Sq != Sk, padded and odd head dims, one
    key tile only (Sk = 50, 64), key bias that masks a whole key tile or
    every key of a row; out and lse, in both forms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(sq + sk)
    q = torch.randn(b, sq, h, d, device="cuda", generator=g).bfloat16()
    k, v = (torch.randn(b, sk, h, d, device="cuda", generator=g).bfloat16() for _ in range(2))
    bias = _flash_bias(bias, b, sk, g)
    variant = tattn.FlashVariant(exp2=exp2)
    out, lse = tattn.flash_attention_fwd(q, k, v, bias, d ** -0.5, variant)
    ref, lse_ref = tattn.flash_attention_fwd_reference(q, k, v, bias, d ** -0.5, variant)
    _assert_near(out, ref, 2e-2)
    assert (lse - lse_ref).abs().max().item() <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,h", [(2, 100, 64, 2), (1, 512, 320, 8), (1, 70, 1280, 8),
                                     (4, 127, 320, 8), (4, 129, 320, 8), (2, 100, 96, 8),
                                     (2, 100, 64, 1), (3, 300, 640, 8)])
def test_fused_cross_kernel_ragged_shapes(b, n, c, h):
    """Rows across the q kernel's 128- and 64-row tile edges (N = 127, 129),
    a head dim that is not a multiple of 8 (12: K/V and o through 2-byte
    accesses), one head (hd = C = 64), head dim 160 and B = 3; one launch
    counted a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(n + c)
    rn = lambda *s: torch.randn(*s, device="cuda", generator=g)
    args = (rn(b, n, c).bfloat16(), (rn(c, c) / c ** 0.5).bfloat16(),
            rn(b, 77, h, c // h).bfloat16(), rn(b, 77, h, c // h).bfloat16(),
            (rn(c, c) / c ** 0.5).bfloat16(), rn(c) / 8, (c // h) ** -0.5, h)
    before = tattn.fused_cross_attention.launches
    _assert_near(tattn.fused_cross_attention(*args),
                 tattn.fused_cross_attention_reference(*args), 2e-2)
    assert tattn.fused_cross_attention.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("m,c", [(50, 320), (33, 640), (96, 16), (127, 320), (129, 320),
                                 (257, 320), (200, 48), (4096, 640)])
def test_geglu_kernel_ragged_shapes(m, c):
    """Rows across the 128-row tile edge, C = 48 and 16 (K not a multiple of
    the 64-deep ring stages; out's columns past C in its last tile), C = 640
    at the UNet's row count; one launch counted a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(m + c)
    rn = lambda *s: torch.randn(*s, device="cuda", generator=g)
    f = 4 * c
    args = (rn(m, c).bfloat16(), (rn(2 * f, c) / c ** 0.5).bfloat16(), rn(2 * f) / 8,
            (rn(c, f) / f ** 0.5).bfloat16(), rn(c) / 8)
    before = tgeglu.geglu_fwd.launches
    _assert_near(tgeglu.geglu(*args), tgeglu.geglu_reference(*args), 1e-2)
    assert tgeglu.geglu_fwd.launches == before + 1


def _bwd_bias(biased, b, sk, g):
    """The backward tests' key bias: True for ~40% of keys masked at random,
    or "tile" / "row" as `_flash_bias`."""
    return _flash_bias({True: "random", False: None}.get(biased, biased), b, sk, g)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,d,biased", [(1, 300, 200, 3, 64, True),
                                                (2, 100, 77, 2, 80, True),
                                                (1, 129, 1000, 1, 128, False),
                                                (2, 64, 64, 4, 8, False),
                                                (2, 512, 512, 8, 40, True),
                                                (2, 200, 50, 2, 16, True),
                                                (2, 333, 300, 2, 40, "tile"),
                                                (2, 257, 190, 2, 40, "row")])
def test_flash_backward_kernel_ragged_shapes(b, sq, sk, h, d, biased):
    """Ragged q and key tiles, padded head dims, one key tile only, key bias
    that masks a whole key tile or every key of a row: dq, dk, dv against the
    plain version (P and dS are rounded to bf16 in the kernel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(sq + sk + d)
    rn = lambda s: torch.randn(*s, device="cuda", generator=g).bfloat16()
    q, k, v, dout = rn((b, sq, h, d)), rn((b, sk, h, d)), rn((b, sk, h, d)), rn((b, sq, h, d))
    bias = _bwd_bias(biased, b, sk, g)
    out, lse = tattn.flash_attention_fwd(q, k, v, bias, d ** -0.5)
    args = (q, k, v, bias, out, lse, dout, d ** -0.5)
    for got, ref in zip(tattn.flash_attention_bwd(*args),
                        tattn.flash_attention_bwd_reference(*args)):
        _assert_near(got, ref, 1e-2)


@pytest.mark.cuda
def test_autograd_through_the_kernels_on_the_card():
    """flash_attention and geglu as autograd Functions on the card (forward
    kernels, the flash backward kernel, GEGLU's recompute) against autograd
    through the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    x = _small_inputs("cuda", torch.bfloat16)
    bias = torch.where(torch.rand(2, 512, device="cuda") < 0.7, 0.0, tattn.NEG_BIG)
    cases = [(lambda *a: tattn.flash_attention(*a, bias, 40 ** -0.5),
              lambda *a: tattn.attention_reference(*a, bias, 40 ** -0.5)[0], x["flash"]),
             (tgeglu.geglu, tgeglu.geglu_reference, x["geglu"])]
    for fn, ref_fn, inputs in cases:
        grads = []
        for f in (fn, ref_fn):
            args = [a.detach().requires_grad_(True) for a in inputs]
            out = f(*args)
            torch.autograd.backward(out, torch.ones_like(out))
            grads.append([a.grad for a in args])
        for got, ref in zip(*grads):
            _assert_near(got, ref, 3e-2)


def _int8_cross_card_args(b, n, c, h, seed, peak_last=False):
    """x [b, n, c] bf16, B5's int8 weights and 77-key K/V (h heads) on the
    card; with peak_last V of the last head is 30x larger, so that every
    row's max|o| lies in the last head."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(*s, device="cuda", generator=g)
    v = rn(b, 77, h, c // h)
    if peak_last:
        v[:, :, -1] *= 30
    return _int8_cross_args(rn(b, n, c).bfloat16(), rn(c, c) / c ** 0.5,
                            rn(b, 77, h, c // h).bfloat16(), v.bfloat16(),
                            rn(c, c) / c ** 0.5, rn(c) / 8) + ((c // h) ** -0.5, h)


def _int8_cross_call_near_plain(args):
    before = tattn.fused_cross_attention_int8.launches
    _assert_near(tattn.fused_cross_attention_int8(*args),
                 tattn.fused_cross_attention_int8_reference(*args), 2e-2)
    assert tattn.fused_cross_attention_int8.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,h", [(2, 100, 64, 2), (1, 512, 320, 8), (3, 33, 640, 8),
                                     (1, 70, 1280, 8), (4, 127, 320, 8), (4, 129, 320, 8),
                                     (2, 100, 96, 8), (2, 100, 64, 1), (3, 300, 640, 8),
                                     (2, 65, 64, 8)])
def test_int8_fused_cross_kernel_ragged_shapes(b, n, c, h):
    """The bf16 kernel's ragged set: rows across the q-attention kernel's
    128- and 64-row tiles (N = 33, 65, 127, 129), head dims 8, 12 (not a
    multiple of 8: 2-byte K/V loads, o's columns one at a time), 32, 64 (one
    head) and 160, K = C of 64, 96 and 320 bytes (a ragged last ring stage),
    B = 3; bf16 against the plain version (x and o quantized per row, int8
    projections), one launch counted a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    _int8_cross_call_near_plain(_int8_cross_card_args(b, n, c, h, n + c))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c", [(2, 4096, 320), (1, 1000, 640)])
def test_int8_fused_cross_kernel_row_max_in_last_head(b, n, c):
    """Every row's max|o| lies in the last head only: o's scale has to come
    from all H heads' partial maxima (a per-head scale, or one that missed
    the last head's, would clip or mis-scale o there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    args = _int8_cross_card_args(b, n, c, 8, n + c, peak_last=True)
    x, wq_q, wq_s, k, v = args[:5]
    x_q, xs = quantize_acts(x)
    q = (int8_matmul(x_q, wq_q) * xs * wq_s).to(x.dtype).reshape(b, n, 8, c // 8)
    p = torch.softmax(torch.einsum("bnhd,bshd->bhns", q.float(), k.float()) * args[8], dim=-1)
    o = torch.einsum("bhns,bshd->bnhd", p.to(x.dtype).float(), v.float()).abs().amax(-1)
    assert (o[..., -1] > o[..., :-1].amax(-1)).all()
    _int8_cross_call_near_plain(args)


@pytest.mark.cuda
def test_int8_fused_cross_kernel_two_calls_in_a_row():
    """Two calls in a row on other inputs and shapes (the workspace carries
    nothing over: each is within the bound of its own plain version)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    _int8_cross_call_near_plain(_int8_cross_card_args(2, 300, 320, 8, 1, peak_last=True))
    _int8_cross_call_near_plain(_int8_cross_card_args(2, 300, 320, 8, 2))
    _int8_cross_call_near_plain(_int8_cross_card_args(1, 1000, 640, 8, 3))


def _int8_geglu_card_args(m, c, seed, peak_last=False):
    """x [m, c] bf16 and B6's weights (F = 4c) on the card; with peak_last
    W1's a-half rows of the last 64 g columns are 30x larger, so that every
    row's max|g| lies in the last proj tile."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(*s, device="cuda", generator=g)
    f = 4 * c
    w1 = rn(2 * f, c) / c ** 0.5
    if peak_last:
        w1[f - 64:f] *= 30
    return _int8_geglu_args(rn(m, c).bfloat16(), w1, rn(2 * f) / 8, rn(c, f) / f ** 0.5,
                            rn(c) / 8)


def _int8_geglu_call_near_plain(args):
    before = tgeglu.geglu_int8.launches
    _assert_near(tgeglu.geglu_int8(*args), tgeglu.geglu_int8_reference(*args), 2e-2)
    assert tgeglu.geglu_int8.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("m,c", [(50, 320), (33, 640), (96, 32), (8, 64), (4096, 640),
                                 (127, 320), (129, 320), (257, 320), (70, 1280)])
def test_int8_geglu_kernel_ragged_shapes(m, c):
    """Ragged 128-row tiles (fewer rows than a tile, one past it, two past
    it), C = 32 and 64 (F = 128 and 256: two and four 64-column proj tiles,
    where a wrong a/gate group would show), a K of C = 320 that ends in half
    a 128-byte stage, C = 1280 (no cap on C or F); bf16 against the plain
    version, one launch counted a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    _int8_geglu_call_near_plain(_int8_geglu_card_args(m, c, m + c))


@pytest.mark.cuda
@pytest.mark.parametrize("m,c", [(2048, 320), (1000, 640)])
def test_int8_geglu_kernel_row_max_in_last_columns(m, c):
    """Every row's max|g| lies in the last 64 g columns only: g's scale has
    to come from all F columns (a per-tile scale, or one that missed the
    last tile's partial maxima, would clip or mis-scale g there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    args = _int8_geglu_card_args(m, c, m + c, peak_last=True)
    x_q, xs = quantize_acts(args[0])
    h = int8_matmul(x_q, args[1]) * xs * args[2] + args[3]
    a, gate = h.chunk(2, dim=-1)
    g = (a * torch.nn.functional.gelu(gate)).abs()
    assert (g[:, -64:].amax(dim=1) > g[:, :-64].amax(dim=1)).all()
    _int8_geglu_call_near_plain(args)


@pytest.mark.cuda
def test_int8_geglu_kernel_two_calls_in_a_row():
    """Two calls in a row on other inputs and shapes (the scratch carries
    nothing over: each is within the bound of its own plain version)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    _int8_geglu_call_near_plain(_int8_geglu_card_args(300, 320, 1, peak_last=True))
    _int8_geglu_call_near_plain(_int8_geglu_card_args(300, 320, 2))
    _int8_geglu_call_near_plain(_int8_geglu_card_args(1000, 640, 3))


@pytest.mark.cuda
def test_int8_quantization_matches_between_cpu_and_card():
    """The plain versions' scales are true divisions on the card too (as the
    kernels' __fdiv_rn and the CPU's), so int8 values and scales agree
    exactly across devices."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from adaprompt_tpu_torch.ops.quant import quantize_acts
    g = torch.Generator().manual_seed(0)
    x = torch.randn(512, 640, generator=g) * 3
    x[:, 0] = 127.0                                   # scale 1.0: .5 levels round to even
    x[:, 1:64] = torch.randint(-126, 126, (512, 63), generator=g) + 0.5
    for w in (x, x.T.contiguous()):
        q_cpu, s_cpu = quantize_weight(w)
        q_gpu, s_gpu = quantize_weight(w.cuda())
        assert torch.equal(q_gpu.cpu(), q_cpu) and torch.equal(s_gpu.cpu(), s_cpu)
    q_cpu, s_cpu = quantize_acts(x)
    q_gpu, s_gpu = quantize_acts(x.cuda())
    assert torch.equal(q_gpu.cpu(), q_cpu) and torch.equal(s_gpu.cpu(), s_cpu)


# -- the three 3x3 conv kernels on the card --------------------------------------

def _card_case(seed, b, h, w, c, o, gn_shift):
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(*s, device="cuda", generator=g)
    x = (rn(b, h, w, c) * 1.5 + 0.5).bfloat16()
    wt = (rn(o, c, 3, 3) / math.sqrt(9 * c)).bfloat16()
    return x, wt, rn(o) * 0.1, 1 + 0.1 * rn(c), 0.1 * rn(c) + gn_shift


RAGGED = [(2, 8, 8, 32, 32), (1, 13, 21, 40, 20), (3, 7, 33, 96, 72), (1, 9, 17, 36, 10),
          (2, 12, 12, 64, 48), (1, 16, 16, 1280, 64), (1, 5, 40, 8, 136),
          (3, 23, 37, 200, 72), (1, 16, 16, 1280, 1280)]


_SD_CONVS = [(4, 64, 64, 320, 320), (4, 32, 32, 640, 640), (4, 16, 16, 1280, 1280)]
# B7's three (the fused table's keys) at B=4: 1, 2 and 2 k splits
_B7_CONVS = [(4, 64, 64, 320, 320), (4, 32, 32, 320, 640), (4, 32, 32, 960, 640)]


@pytest.mark.parametrize("form", ["halo", "im2col"])
@pytest.mark.parametrize("b,h,w,c,o", _SD_CONVS + _B7_CONVS[1:] + RAGGED)
def test_conv_plan_covers_every_output_once(form, b, h, w, c, o):
    """conv_plan's grid covers each output pixel and channel exactly once and
    leaves no block without an output or without a channel chunk; at the SD
    shapes it makes at least 120 blocks (1, 2 and 4 splits), at B7's (the
    halo form's plan) 256 (1, 2 and 2)."""
    import numpy as np
    plan = tch.conv_plan(form, b, h, w, c, o)
    cols, tiles, splits = plan.grid
    assert splits == plan.splits
    assert (cols - 1) * tch.TILE_CHANNELS < o <= cols * tch.TILE_CHANNELS
    assert 1 <= splits <= min(tch.MAX_SPLITS, -(-c // tch.CHUNK))
    seen = np.zeros((b, h, w), np.int64)
    if form == "im2col":
        flat = seen.reshape(-1)
        for t in range(tiles):
            block = flat[t * tch.TILE_PIXELS:(t + 1) * tch.TILE_PIXELS]
            assert block.size
            block += 1
    else:
        th, tw = tch.HALO_ROWS, tch.HALO_COLS
        assert th * tw == tch.TILE_PIXELS
        tiles_w = -(-w // tw)
        per_image = -(-h // th) * tiles_w
        assert tiles == b * per_image
        for t in range(tiles):
            y0, x0 = (t % per_image) // tiles_w * th, (t % per_image) % tiles_w * tw
            block = seen[t // per_image, y0:y0 + th, x0:x0 + tw]
            assert block.size
            block += 1
    assert (seen == 1).all()
    if (b, h, w, c, o) in _SD_CONVS:
        assert plan.blocks >= 120 and splits == (1, 2, 4)[_SD_CONVS.index((b, h, w, c, o))]
    if form == "halo" and (b, h, w, c, o) in _B7_CONVS:
        assert plan.blocks == 256 and splits == (1, 2, 2)[_B7_CONVS.index((b, h, w, c, o))]


@pytest.mark.cuda
@pytest.mark.parametrize("fn", ["conv3x3_halo", "conv3x3_im2col"])
@pytest.mark.parametrize("b,h,w,c,o", RAGGED)
def test_conv_kernels_ragged_shapes(fn, b, h, w, c, o):
    """Ragged row, column, channel-chunk and output-channel tiles, channel
    counts that rule out 16-byte loads; bf16 against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    x, wt, bias, _, _ = _card_case(h + w + c + o, b, h, w, c, o, 0.0)
    wrapper = getattr(tch, fn)
    before = wrapper.launches
    out = wrapper(x, wt, bias)
    assert wrapper.launches == before + 1
    _assert_near(out, getattr(tch, fn + "_reference")(x, wt, bias), 2e-2)
    _assert_near(wrapper(x, wt, bias, packed=tch.pack_conv_weight(wt)), out, 0.0)


def _forced_plan(monkeypatch, splits):
    """Every B8 and B9 wrapper call takes this many k splits."""
    plan = tch.conv_plan
    monkeypatch.setattr(tch, "conv_plan", lambda *a: dataclasses.replace(plan(*a), splits=splits))


@pytest.mark.cuda
@pytest.mark.parametrize("fn", ["conv3x3_halo", "conv3x3_im2col"])
@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("b,h,w,c,o", [s for s in RAGGED if s[3] >= 128])
def test_conv_kernels_every_split_on_ragged_shapes(monkeypatch, fn, splits, b, h, w, c, o):
    """B8 and B9 at each count of k splits, not only the one conv_plan picks
    (channel chunks in unequal parts at 3 splits of C = 200's 7), one launch
    counted a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    _forced_plan(monkeypatch, splits)
    x, wt, bias, _, _ = _card_case(h + w + c + o, b, h, w, c, o, 0.0)
    wrapper = getattr(tch, fn)
    before = wrapper.launches
    out = wrapper(x, wt, bias)
    assert wrapper.launches == before + 1
    _assert_near(out, getattr(tch, f"{fn}_reference")(x, wt, bias), 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("fn", ["conv3x3_halo", "conv3x3_im2col"])
def test_conv_kernels_two_calls_give_equal_bits(fn):
    """The k splits are summed in a fixed order (no atomics): two calls on the
    same inputs give equal bits, at (1, 16, 16, 1280, 1280) (4 splits) and a
    ragged shape, also with a call on other shapes between them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    wrapper = getattr(tch, fn)
    cases = [_card_case(7, 1, 16, 16, 1280, 1280, 0.0)[:3],
             _card_case(8, 3, 23, 37, 200, 72, 0.0)[:3]]
    first = [wrapper(*args) for args in cases]
    for args, out in zip(cases, first):
        assert torch.equal(wrapper(*args), out)
    assert torch.equal(wrapper(*cases[0]), first[0])


# B7's ragged cases: ragged tiles, O not a multiple of 8 (20, 10), a group
# of 1, 3, 2, 5 and 40 channels
GN_RAGGED = [(2, 8, 8, 32, 32), (3, 7, 33, 96, 72), (2, 12, 12, 64, 48), (1, 21, 13, 160, 40),
             (1, 16, 16, 1280, 64), (1, 13, 21, 64, 20), (1, 9, 17, 32, 10)]


def _unmasked_border_err(x, gs, gb, wt, bias, ref):
    """max|out - ref| / max|ref| of a fused conv that padded x before the
    affine (silu(b) instead of 0 outside the image)."""
    ab = tch.gn_affine(x, gs, gb)
    seg = (torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1)) * ab[:, 0, None, None, :]
           + ab[:, 1, None, None, :])
    act = (seg * torch.sigmoid(seg)).to(x.dtype).float().permute(0, 3, 1, 2)
    wrong = torch.nn.functional.conv2d(act, wt.float(), bias).permute(0, 2, 3, 1)
    return ((wrong - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("gn_shift", [0.0, 3.0])
@pytest.mark.parametrize("b,h,w,c,o", GN_RAGGED)
def test_gn_silu_conv_kernel_ragged_shapes(b, h, w, c, o, gn_shift):
    """The fused kernel on ragged tiles; gn_shift=3 makes an unmasked border
    (silu(b) instead of 0 outside the image) miss the bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    x, wt, bias, gs, gb = _card_case(h + w + c + o + 1, b, h, w, c, o, gn_shift)
    before = tch.gn_silu_conv3x3_halo.launches
    out = tch.gn_silu_conv3x3_halo(x, gs, gb, wt, bias)
    assert tch.gn_silu_conv3x3_halo.launches == before + 1
    assert out.shape == (b, h, w, o) and out.is_contiguous()
    _assert_near(out, tch.gn_silu_conv3x3_halo_reference(x, gs, gb, wt, bias), 2e-2)
    _assert_near(tch.gn_silu_conv3x3_halo(x, gs, gb, wt, bias, packed=tch.pack_conv_weight(wt)),
                 out, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("gn_shift", [0.0, 3.0])
@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("b,h,w,c,o", [s for s in GN_RAGGED if s[3] >= 128]
                         + [(2, 11, 19, 256, 24)])
def test_gn_silu_conv_kernel_every_split(monkeypatch, b, h, w, c, o, splits, gn_shift):
    """B7 at each count of k splits (each split's first chunk transformed
    before its loop, the others during the chunk before), one launch counted
    a call; at gn_shift=3 the border would miss the bound unmasked."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    _forced_plan(monkeypatch, splits)
    x, wt, bias, gs, gb = _card_case(h + w + c + o + splits, b, h, w, c, o, gn_shift)
    before = tch.gn_silu_conv3x3_halo.launches
    out = tch.gn_silu_conv3x3_halo(x, gs, gb, wt, bias)
    assert tch.gn_silu_conv3x3_halo.launches == before + 1
    ref = tch.gn_silu_conv3x3_halo_reference(x, gs, gb, wt, bias)
    _assert_near(out, ref, 2e-2)
    if gn_shift:
        assert _unmasked_border_err(x, gs, gb, wt, bias, ref) > 4e-2


@pytest.mark.cuda
def test_gn_silu_conv_kernel_two_calls_give_equal_bits():
    """The statistics and the k splits are summed in a fixed order (no
    atomics): two calls on the same inputs give equal bits, at (1, 16, 16,
    1280, 1280) (4 splits) and a ragged shape, also with a call on other
    shapes between them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    cases = [_card_case(7, 1, 16, 16, 1280, 1280, 0.5), _card_case(8, 3, 23, 37, 192, 72, 0.5)]
    call = lambda x, wt, bias, gs, gb: tch.gn_silu_conv3x3_halo(x, gs, gb, wt, bias)
    first = [call(*args) for args in cases]
    for args, out in zip(cases, first):
        assert torch.equal(call(*args), out)
    assert torch.equal(call(*cases[0]), first[0])


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c", [(4, 64, 64, 320), (4, 32, 32, 640), (4, 32, 32, 960),
                                     (1, 16, 16, 1280), (3, 7, 33, 96), (2, 8, 8, 32)])
def test_gn_silu_conv_statistics_kernel_matches_gn_affine(b, h, w, c):
    """B7's statistics kernel (a group of 10, 20, 30, 40, 3 and 1 channels:
    pieces of 2, 4, 2, 16, 2 and 2 bytes) against `gn_affine` on the card,
    each half within 1e-5 of its max; two calls give equal bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    x, _, _, gs, gb = _card_case(b + h + c, b, h, w, c, 8, 1.0)
    got = tch.gn_affine_kernel(x, gs, gb)
    ref = tch.gn_affine(x, gs, gb)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (b, 2, c)
    for k in range(2):
        err = (got[:, k] - ref[:, k]).abs().max().item()
        assert math.isfinite(err) and err <= 1e-5 * ref[:, k].abs().max().item(), (k, err)
    assert torch.equal(tch.gn_affine_kernel(x, gs, gb), got)


# -- the flash variants and the two unwired attention kernels on the card ---------------

@pytest.mark.cuda
@pytest.mark.parametrize("variant", FLASH_VARIANTS, ids=str)
@pytest.mark.parametrize("b,sq,sk,h,d,bias", [(1, 300, 200, 3, 64, "random"),
                                              (2, 100, 77, 2, 80, "random"),
                                              (1, 129, 1000, 1, 128, None),
                                              (2, 64, 64, 4, 8, None),
                                              (2, 200, 50, 2, 16, "random"),
                                              (2, 333, 300, 2, 40, "tile"),
                                              (2, 257, 190, 2, 40, "row"),
                                              (2, 128, 576, 2, 40, "random"),
                                              (1, 100, 128, 2, 40, None),
                                              (1, 100, 192, 2, 24, "random")])
def test_flash_variant_kernels_ragged_shapes(variant, b, sq, sk, h, d, bias):
    """Each forward kernel and exp2 form against its own plain version, on
    the one-chain kernel's ragged cases: Sq != Sk with both ragged, head dims
    8 to 128, key bias, a key tile masked whole, a row masked whole; key-tile
    counts 4, 2, 16, 1, 1, 5, 3, 9, 2 and 3 (for the two-chain kernel odd and
    even, whole and ragged); out, lse and the launch counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(sq + sk)
    q = torch.randn(b, sq, h, d, device="cuda", generator=g).bfloat16()
    k, v = (torch.randn(b, sk, h, d, device="cuda", generator=g).bfloat16() for _ in range(2))
    bias = _flash_bias(bias, b, sk, g)
    wrapper = {"base": tattn.flash_attention_fwd, "ilv": tattn.flash_attention_fwd_ilv,
               "nomax": tattn.flash_attention_fwd_nomax}[variant.forward]
    before = (wrapper.launches, wrapper.exp2_launches)
    out, lse = tattn.flash_attention_fwd(q, k, v, bias, d ** -0.5, variant)
    assert (wrapper.launches, wrapper.exp2_launches) == (before[0] + 1, before[1] + variant.exp2)
    ref, lse_ref = tattn.flash_attention_fwd_reference(q, k, v, bias, d ** -0.5, variant)
    _assert_near(out, ref, 2e-2)
    assert (lse - lse_ref).abs().max().item() <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("b,sk,h,d", [(1, 1000, 3, 40), (2, 77, 2, 128), (4, 4096, 8, 40)])
def test_nomax_key_max_prepass(b, sk, h, d):
    """The no-max kernel call's pre-pass over K against `nomax_key_max`, to
    fp32 rounding; the call's out and lse are the wrapper's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(sk + d)
    rn = lambda *s: torch.randn(*s, device="cuda", generator=g)
    k = (rn(b, sk, h, d) * torch.rand(b, sk, 1, 1, device="cuda", generator=g) * 3).bfloat16()
    q, v = rn(b, sk, h, d).bfloat16(), k.flip(1).contiguous()
    kmax, out = torch.empty(b * h, device="cuda"), torch.empty_like(q)
    lse = torch.empty(b * h, sk, 1, device="cuda")
    tattn.nomax_kernel_call(q, k, v, None, kmax, out, lse, d ** -0.5, False)
    _assert_near(kmax, tattn.nomax_key_max(k), 1e-5)
    out_w, lse_w = tattn.flash_attention_fwd_nomax(q, k, v, None, d ** -0.5)
    assert torch.equal(out, out_w) and torch.equal(lse, lse_w)


@pytest.mark.cuda
def test_nomax_kernel_underflow_gives_finite_zeros():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    q = torch.full((1, 512, 1, 40), 60.0, device="cuda", dtype=torch.bfloat16)
    for exp2 in (False, True):
        out, lse = tattn.flash_attention_fwd_nomax(q, -q, torch.ones_like(q), None, 40 ** -0.5,
                                                   exp2)
        assert bool(torch.isfinite(lse).all()) and float(out.float().abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,d,biased", [(1, 300, 200, 3, 64, True),
                                                (2, 512, 512, 8, 40, True),
                                                (1, 129, 1000, 1, 128, False),
                                                (2, 333, 300, 2, 40, "tile"),
                                                (2, 257, 190, 2, 40, "row")])
def test_flash_backward_exp2_kernel_ragged_shapes(b, sq, sk, h, d, biased):
    """The backward's exp2 form from an exp2 forward's out and lse, against
    its plain version, also with a key tile or a row masked whole; and any
    forward pairs with any backward: the natural backward from the same lse
    agrees with the exp2 one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(sq + sk + d)
    rn = lambda s: torch.randn(*s, device="cuda", generator=g).bfloat16()
    q, k, v, dout = rn((b, sq, h, d)), rn((b, sk, h, d)), rn((b, sk, h, d)), rn((b, sq, h, d))
    bias = _bwd_bias(biased, b, sk, g)
    out, lse = tattn.flash_attention_fwd(q, k, v, bias, d ** -0.5, tattn.FlashVariant(exp2=True))
    args = (q, k, v, bias, out, lse, dout, d ** -0.5)
    before = tattn.flash_attention_bwd.exp2_launches
    got = tattn.flash_attention_bwd(*args, tattn.FlashVariant(exp2=True))
    assert tattn.flash_attention_bwd.exp2_launches == before + 1
    for a, ref, nat in zip(got, tattn.flash_attention_bwd_reference(*args, exp2=True),
                           tattn.flash_attention_bwd(*args)):
        _assert_near(a, ref, 1e-2)
        _assert_near(a, nat, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("exp2", [False, True])
@pytest.mark.parametrize("b,sq,sk,h,d", [(1, 300, 200, 3, 64), (2, 512, 512, 8, 40),
                                         (2, 100, 77, 2, 80)])
def test_flash_backward_kernel_call_prepass(b, sq, sk, h, d, exp2):
    """The backward kernel call fills its scratch itself: the pre-pass's
    (lse*log2(e), delta) against lse and `flash_bwd_delta` (1e-5 of the
    largest), dk and dv bit for bit the wrapper's, and dq the wrapper's up to
    the order of its atomic sums."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(sq + sk + d)
    rn = lambda s: torch.randn(*s, device="cuda", generator=g).bfloat16()
    q, k, v, dout = rn((b, sq, h, d)), rn((b, sk, h, d)), rn((b, sk, h, d)), rn((b, sq, h, d))
    bias = _bwd_bias(True, b, sk, g)
    variant = tattn.FlashVariant(exp2=exp2)
    out, lse = tattn.flash_attention_fwd(q, k, v, bias, d ** -0.5, variant)
    ld = torch.full((b * h, sq, 2), float("nan"), device="cuda")
    dq_acc = torch.full((b, sq, h, d), float("nan"), device="cuda")
    grads = [torch.empty_like(x) for x in (q, k, v)]
    before = tattn.flash_attention_bwd.launches
    tattn.flash_bwd_kernel_call(q, k, v, bias, out, lse, dout, ld, dq_acc, *grads, d ** -0.5,
                                exp2)
    assert tattn.flash_attention_bwd.launches == before
    _assert_near(ld[..., 1], tattn.flash_bwd_delta(out, dout), 1e-5)
    _assert_near(ld[..., 0], lse[..., 0] * tattn.LOG2E, 1e-6)
    dq, dk, dv = tattn.flash_attention_bwd(q, k, v, bias, out, lse, dout, d ** -0.5, variant)
    assert torch.equal(dk, grads[1]) and torch.equal(dv, grads[2])
    _assert_near(grads[0], dq, 1e-2)


def _int8_flash_card_args(b, sq, sk, h, d, biased, masked=None, seed=0):
    """q, k (off centre), v [B, S, H, D] bf16 on the card and, when biased, a
    key bias that drops ~40% of the keys; masked="tile" drops every key of
    batch 0's first 64-key tile, masked="row" every key of the last batch."""
    g = torch.Generator(device="cuda").manual_seed(seed or sq + sk + d)
    q = torch.randn(b, sq, h, d, device="cuda", generator=g).bfloat16()
    k = (torch.randn(b, sk, h, d, device="cuda", generator=g) + 0.7).bfloat16()
    v = torch.randn(b, sk, h, d, device="cuda", generator=g).bfloat16()
    bias = None
    if biased:
        bias = torch.where(torch.rand(b, sk, device="cuda", generator=g) < 0.6, 0.0,
                           tattn.NEG_BIG)
        if masked == "tile":
            bias[0, :64] = tattn.NEG_BIG
        elif masked == "row":
            bias[-1] = tattn.NEG_BIG
    return q, k, v, bias


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,d,biased,masked", [
    (1, 300, 203, 3, 64, True, None), (2, 100, 1000, 2, 128, False, None),
    (2, 512, 512, 8, 40, True, None), (1, 1024, 1024, 8, 80, False, None),
    (2, 64, 64, 2, 16, False, None), (2, 129, 65, 2, 8, True, None),
    (1, 1, 63, 3, 24, False, None), (2, 333, 300, 2, 40, True, "tile"),
    (2, 257, 190, 2, 80, True, "row"), (2, 129, 1, 2, 128, True, None),
    (1, 1, 203, 2, 40, True, None), (2, 70, 65, 3, 80, False, None)])
def test_int8_flash_kernel_ragged_shapes(b, sq, sk, h, d, biased, masked):
    """The int8-QK call (its key pass and attention kernel) against its plain
    version, which makes its operands in PyTorch: head dims 8 to 128 (int8
    depths DQ 16, 32, 48, 64, 80, 128: the k16 tail at 16, 48 and 80), Sk of
    1, 63, 65, 190, 203 and 1000 (ragged key tiles and key-pass chunks), Sq
    of 1 and 129 (ragged query tiles), a key tile masked whole, a row masked
    whole; one launch counted a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    q, k, v, bias = _int8_flash_card_args(b, sq, sk, h, d, biased, masked)
    before = tattn.flash_attention_int8.launches
    out = tattn.flash_attention_int8(q, k, v, bias)
    assert tattn.flash_attention_int8.launches == before + 1 and out.shape == q.shape
    assert out.is_contiguous()
    _assert_near(out, tattn.flash_attention_int8_reference(q, k, v, bias), 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,d", [(4, 1024, 4096, 8, 40), (2, 300, 1024, 8, 80),
                                         (1, 129, 203, 3, 24), (2, 70, 65, 2, 128)])
def test_int8_flash_prepass_matches_operands(b, sq, sk, h, d):
    """The operands one C call made on the card, read back from its workspace
    (a call with keep_q), against `int8_qk_operands` on the same card
    tensors: q_q and q_s bit-equal; k_q within one level, and k_q and k_s
    equal in every head whose bf16 key mean agrees with k.mean(1); the pad
    columns [D, DQ) zero (chip_smoke.int8_operands_check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    sys.path.insert(0, ROOT)
    import chip_smoke
    q, k, v, _ = _int8_flash_card_args(b, sq, sk, h, d, False)
    work = torch.empty(tattn._int8_flash_layout(b, sq, sk, h, d)[0], dtype=torch.uint8,
                       device="cuda")
    out = torch.empty_like(q)
    tattn.int8_flash_kernel_call(q, k, v, None, work, out, d ** -0.5, keep_q=True)
    torch.cuda.synchronize()
    ok, detail = chip_smoke.int8_operands_check(q, k, v, work)
    assert ok, detail
    assert torch.equal(out, tattn.flash_attention_int8(q, k, v))


@pytest.mark.cuda
def test_int8_flash_two_calls_give_equal_bits():
    """The key pass sums in a fixed order (no atomics): two calls in a row on
    the same inputs give equal bits, also with another call between them on
    other shapes (the workspace carries nothing over)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    args = _int8_flash_card_args(2, 1000, 1500, 8, 40, True)
    first = tattn.flash_attention_int8(*args)
    assert torch.equal(tattn.flash_attention_int8(*args), first)
    other = _int8_flash_card_args(1, 300, 203, 3, 80, True)
    _assert_near(tattn.flash_attention_int8(*other), tattn.flash_attention_int8_reference(*other),
                 2e-2)
    assert torch.equal(tattn.flash_attention_int8(*args), first)


def _self_card_args(b, n, c, h, biased):
    g = torch.Generator(device="cuda").manual_seed(n + c + h)
    rn = lambda *s: torch.randn(*s, device="cuda", generator=g)
    w = lambda: (rn(c, c) / c ** 0.5).bfloat16()
    bias = None
    if biased:
        bias = torch.where(torch.rand(b, n, device="cuda", generator=g) < 0.6, 0.0, tattn.NEG_BIG)
    return (rn(b, n, c).bfloat16(), w(), w(), w(), w(), rn(c) / 8, (c // h) ** -0.5, h, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,h,biased", [
    (2, 100, 64, 2, True), (1, 1000, 320, 8, True), (2, 512, 640, 8, False),
    (1, 77, 1280, 8, False), (2, 127, 64, 8, True), (3, 129, 192, 8, False),
    (2, 300, 320, 8, True), (1, 50, 640, 8, True), (2, 129, 1280, 8, True),
    (1, 300, 320, 2, False), (2, 63, 128, 1, True), (1, 1, 320, 8, False),
    (2, 200, 1280, 16, True), (1, 333, 96, 2, True), (2, 129, 336, 2, True),
    (1, 300, 320, 1, False), (2, 77, 1280, 4, True), (1, 100, 912, 2, True),
    (1, 200, 400, 1, False)])
def test_fused_self_attention_kernel_ragged_shapes(b, n, c, h, biased):
    """Row tiles of 128 (hd <= 80) and 64 (hd 88 to 160) cut by N = 127, 129,
    300, 333, 1000; a single partial key tile (N = 1, 50, 63, 77); head dims
    8 to 160 (24 and 40 padded to 32 and 48 in q.k^T) and, in chunks of 80
    columns, 168 to 456 (one head or two); one launch counted a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    args = _self_card_args(b, n, c, h, biased)
    before = tattn.fused_self_attention.launches
    out = tattn.fused_self_attention(*args)
    assert tattn.fused_self_attention.launches == before + 1
    assert out.shape == args[0].shape and out.is_contiguous()
    _assert_near(out, tattn.fused_self_attention_reference(*args), 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("biased", [False, True])
def test_fused_self_attention_two_calls_give_equal_bits(biased):
    """Nothing is summed across blocks (no atomics): two calls on the same
    inputs give equal bits, and the C call alone gives the wrapper's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    args = _self_card_args(2, 1000, 320, 8, biased)
    x, wq, wk, wv, wo, bo, scale, h, bias = args
    first = tattn.fused_self_attention(*args)
    assert torch.equal(tattn.fused_self_attention(*args), first)
    kv = tattn.packed_kv(x, wk, wv).contiguous()
    o, out = torch.empty_like(x), torch.empty_like(x)
    tattn.fused_self_kernel_call(x, wq, kv, wo, bo.float(), bias, o, out, scale, h)
    assert torch.equal(out, first)


@pytest.mark.cuda
def test_fused_self_attention_scratch_carries_nothing():
    """The o scratch between the two kernels carries nothing from one call
    to the next: a call on a scratch full of NaN, and a call after one of
    another shape, give the bits of a first call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    args = _self_card_args(2, 300, 640, 8, True)
    x, wq, wk, wv, wo, bo, scale, h, bias = args
    first = tattn.fused_self_attention(*args)
    other = _self_card_args(1, 129, 1280, 8, False)
    _assert_near(tattn.fused_self_attention(*other),
                 tattn.fused_self_attention_reference(*other), 2e-2)
    assert torch.equal(tattn.fused_self_attention(*args), first)
    kv = tattn.packed_kv(x, wk, wv).contiguous()
    o = torch.full_like(x, float("nan"))
    out = torch.full_like(x, float("nan"))
    tattn.fused_self_kernel_call(x, wq, kv, wo, bo.float(), bias, o, out, scale, h)
    assert torch.equal(out, first)


@pytest.mark.cuda
def test_autograd_under_flash_variants_on_the_card():
    """flash_attention under each variant on the card (its forward kernel,
    the backward in the matching exp form) against autograd through the
    default plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    x = _small_inputs("cuda", torch.bfloat16)["flash"]
    bias = torch.where(torch.rand(2, 512, device="cuda") < 0.7, 0.0, tattn.NEG_BIG)
    ref_in = [a.detach().requires_grad_(True) for a in x]
    ref = tattn.attention_reference(*ref_in, bias, 40 ** -0.5)[0]
    torch.autograd.backward(ref, torch.ones_like(ref))
    for variant in FLASH_VARIANTS:
        args = [a.detach().requires_grad_(True) for a in x]
        out = tattn.flash_attention(*args, bias, 40 ** -0.5, variant)
        torch.autograd.backward(out, torch.ones_like(out))
        for a, r in zip(args, ref_in):
            _assert_near(a.grad, r.grad, 3e-2)


@pytest.mark.cuda
def test_unet_capture_on_the_card():
    """A small UNet's forward and backward with capture_ca, an img_mask and
    the fg/bg regularizers on its scores, in bf16 on the card against fp32
    on the CPU: the context gradient and every captured score map within
    5e-2 relative L2, with the flash kernels launched for self-attention
    (forward, its recompute, and the backward of the 4 layers a gradient
    reaches) and none for the capturing cross-attention."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from adaprompt_tpu_torch.models.unet import UNet, UNetConfig
    from adaprompt_tpu_torch.ops.layers import randomize_zero_init, reset_parameters
    from adaprompt_tpu_torch.train import fgbg
    gen = torch.Generator().manual_seed(0)
    cfg = UNetConfig(model_channels=64, num_heads=4, context_dim=64)
    cpu = randomize_zero_init(reset_parameters(UNet(cfg), gen), gen)
    card = UNet(cfg, device="cuda", dtype=torch.bfloat16)
    card.load_state_dict({k: v.to(torch.bfloat16) for k, v in cpu.state_dict().items()})
    x = torch.randn(1, 32, 32, 4, generator=gen)
    ctx = torch.randn(1, 1, 77, 64, generator=gen)
    mask = (torch.rand(1, 32, 32, 1, generator=gen) >= 0.3).float()
    fg = torch.zeros(1, 32, 32, 1)
    fg[:, 8:24, 10:22] = 1.0
    g = torch.randn(1, 32, 32, 4, generator=gen)
    rows = torch.arange(5, 21)[None]

    def run(model, dev, dt):
        c = ctx.to(dev).requires_grad_(True)
        eps, caps = model(x.to(dev, dt), torch.tensor([501], device=dev), c.to(dt),
                          img_mask=mask.to(dev), capture_ca=True)
        scores = {li: s.float() for li, s in caps["attnscore"].items()}
        reg = fgbg.calc_fg_bg_complementary_loss(scores, rows.to(dev), None, 1,
                                                 fg_mask=fg.to(dev))[1]
        reg = reg + fgbg.calc_fg_bg_xlayer_consist_loss(scores, rows.to(dev), None, 1)[0]
        ((eps.float() * g.to(dev)).sum() + reg).backward()
        return c.grad.float().cpu(), {li: s.detach().cpu() for li, s in scores.items()}

    before = {n: w.launches for n, w in kernel_wrappers().items()}
    grad_card, scores_card = run(card, "cuda", torch.bfloat16)
    launched = {n: w.launches - before[n] for n, w in kernel_wrappers().items()}
    grad_ref, scores_ref = run(cpu, "cpu", torch.float32)
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    assert rel(grad_card, grad_ref) <= 5e-2
    assert list(scores_card) == list(scores_ref) and len(scores_ref) == 12
    for li in scores_ref:
        assert rel(scores_card[li], scores_ref[li]) <= 5e-2, li
    assert launched["flash_attention_fwd"] == 10 and launched["flash_attention_bwd"] == 4
    assert launched["fused_cross_attention"] == 0


@pytest.mark.cuda
def test_vision_tower_on_the_card():
    """The full-width CLIP ViT-H/14 (fp32, TF32 off) on the card against the
    same weights on the CPU, one seeded 224x224 photo with a box fg mask:
    the second-to-last hidden states and pooled within 1e-4 relative L2, no
    kernel launched (chip_smoke.vision_tower_check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    sys.path.insert(0, ROOT)
    import chip_smoke
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        r = chip_smoke.vision_tower_check()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    assert r["hidden_states[-2]"] <= 1e-4 and r["pooled"] <= 1e-4, r
    assert r["launches"] == {}


@pytest.mark.cuda
def test_compos_phase_on_the_card():
    """The compositional phase (train/compos_step.ComposStep) on a small UNet
    in bf16 on the card (tools/compos_card_error.py's case, seed 0), over one
    trainable 4-type context with separate V/K mixes, capture, the
    mix-prompt, cross-layer and elastic preservation losses; no img_mask, so
    B1 and B4 run without key bias.
    Against fp32 on the CPU: the loss within 1e-2 relative, x_recon within
    1e-2 relative L2, the context gradient within 1e-1 relative L2 (the
    delta losses amplify bf16 rounding: the tool's bf16 runs of this seed,
    on the CPU, on the card, on the card with plain kernels, read
    4.1e-2-6.2e-2), the q BatchNorm statistics' 12 layers.
    From the card's one forward, its backward through B4 against one
    through B4's plain version: the context gradient within 5e-3, the
    gradients of the flash layers' q and k weights within 2.5e-2 and of
    their v weights within 1.5e-2 relative L2 (the tool read <= 1.9e-2 and
    <= 7.9e-3 over four seeds); a planted 5 % fault of B4's dq must break
    the q bound (3 % read 3.3e-2-3.4e-2).
    Launches: the flash forwards and their recompute, the backwards, no
    fused cross-attention."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import compos_card_error as cce
    unet, ctx, batch = cce.compos_case(0)
    card = cce.bf16_copy(unet, "cuda")
    before = {n: w.launches for n, w in kernel_wrappers().items()}
    got = cce.run_phase(card, ctx, batch, "cuda", torch.bfloat16,
                        [{}, cce.PLAIN["b4"], cce.faulty("b4_dq", 0.05)])
    launched = {n: w.launches - before[n] for n, w in kernel_wrappers().items()}
    ref = cce.run_phase(unet, ctx, batch, "cpu", torch.float32)
    vs_ref = cce.readings(got, ref)
    assert vs_ref["loss"] <= 1e-2 and vs_ref["x_recon"] <= 1e-2, vs_ref
    assert vs_ref["ctx_grad"] <= 1e-1, vs_ref
    assert sorted(got[3]) == sorted(ref[3]) and len(ref[3]) == 12
    b4 = cce.readings(got, got, 0, 1)
    assert b4["ctx_grad"] <= 5e-3, b4
    assert b4["q_grad"] <= 2.5e-2 and b4["k_grad"] <= 2.5e-2 and b4["v_grad"] <= 1.5e-2, b4
    planted = cce.readings(got, got, 2, 1)
    assert planted["q_grad"] > 2.5e-2, planted
    assert launched["flash_attention_fwd"] > 0 and launched["flash_attention_bwd"] > 0
    assert launched["fused_cross_attention"] == 0


def _card_pair(cls, seed):
    cpu = cls.random_init(seed, device="cpu")
    card = cls(device="cuda")
    card.load_state_dict(cpu.state_dict())
    return cpu, card.eval()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.cuda
def test_retinaface_on_the_card_ragged_photo():
    """A 333x517 photo into the 640 canvas: the card's fp32 heads (TF32
    off) within 1e-4 relative L2 of the CPU's; where no score lies within
    4x the measured error of the threshold or of another candidate's score
    (either could change what NMS keeps), the same detections. The class
    head is scaled down so that scores spread below 1 (random weights
    saturate them at exactly 1, where the order of ties decides NMS)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the fp32 card run against the CPU)")
    from adaprompt_tpu_torch.models import retinaface as trf
    torch.backends.cudnn.allow_tf32 = False
    cpu = trf.RetinaFace.random_init(11, device="cpu")
    img = np.random.default_rng(11).integers(0, 256, (333, 517, 3), dtype=np.uint8)
    x, scale = trf.canvas(img)
    with torch.no_grad():
        logits = cpu(torch.from_numpy(x[None]))[0][0]
        margin = logits[:, 1] - logits[:, 0]
        for conv in cpu.heads["ClassHead"]:        # margin std 2, ~1 % of anchors above 0.5
            conv.weight.mul_(2.0 / margin.std())
            conv.bias.mul_(2.0 / margin.std())
            conv.bias[1::2] -= torch.quantile(margin, 0.99) * 2.0 / margin.std()
    card = trf.RetinaFace(device="cuda")
    card.load_state_dict(cpu.state_dict())
    card.eval()
    with torch.no_grad():
        for g, c in zip(card(torch.from_numpy(x[None]).cuda()), cpu(torch.from_numpy(x[None]))):
            assert _rel(g.cpu().numpy(), c.numpy()) <= 1e-4
    a, b = trf.head_outputs(cpu, x[None]), trf.head_outputs(card, x[None])
    tol = 4 * np.abs(a[0] - b[0]).max() + 1e-7
    scores = a[0][0]
    keep = scores > 0.5
    assert 0 < keep.sum() < len(scores) // 2
    # a near-tie: a score at the threshold, or two candidates whose order could
    # swap while they overlap enough for the first kept to suppress the other
    boxes = trf.decode_boxes(a[1][0][keep], trf.priors(640, 640)[keep])
    order = np.argsort(scores[keep])
    close = np.flatnonzero(np.diff(scores[keep][order]) <= tol)
    x0, y0, x1, y1 = boxes.T
    i, j = order[close], order[close + 1]
    inter = (np.clip(np.minimum(x1[i], x1[j]) - np.maximum(x0[i], x0[j]), 0, None)
             * np.clip(np.minimum(y1[i], y1[j]) - np.maximum(y0[i], y0[j]), 0, None))
    area = (x1 - x0) * (y1 - y0)
    near = (np.abs(scores - 0.5) <= tol).any() or (inter / (area[i] + area[j] - inter)
                                                   > 0.3).any()
    da = trf.decode_detections(a[0][0], a[1][0], a[2][0], img.shape[:2], scale)
    db = trf.decode_detections(b[0][0], b[1][0], b[2][0], img.shape[:2], scale)
    if not near:                       # the same boxes; two of close scores may swap places
        assert len(da[1]) == len(db[1]) > 0
        np.testing.assert_allclose(db[0][np.lexsort(db[0].T)], da[0][np.lexsort(da[0].T)],
                                   atol=1e-2)


@pytest.mark.cuda
def test_bisenet_on_the_card_ragged_batch():
    """A batch of three 300x300 photos resized into the 512 parse: the
    card's fp32 logits (TF32 off) within 1e-4 relative L2 of the CPU's,
    labels equal where the CPU's top-two logits differ by more than twice
    the measured error."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the fp32 card run against the CPU)")
    from adaprompt_tpu_torch.models import bisenet as tbis
    from adaprompt_tpu_torch.utils.resize import pil_bilinear
    torch.backends.cudnn.allow_tf32 = False
    cpu, card = _card_pair(tbis.BiSeNet, 12)
    rng = np.random.default_rng(12)
    imgs = np.stack([pil_bilinear(rng.integers(0, 256, (300, 300, 3), dtype=np.uint8), 512, 512)
                     for _ in range(3)])
    x = torch.from_numpy(tbis.preprocess(imgs))
    with torch.no_grad():
        lc, lg = cpu(x).numpy(), card(x.cuda()).cpu().numpy()
    assert _rel(lg, lc) <= 1e-4
    top2 = np.sort(lc, axis=-1)
    clear = top2[..., -1] - top2[..., -2] > 2 * np.abs(lg - lc).max()
    np.testing.assert_array_equal(tbis.parse_faces(card, imgs)[clear],
                                  tbis.parse_faces(cpu, imgs)[clear])
