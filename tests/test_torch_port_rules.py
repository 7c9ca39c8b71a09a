"""Rules of the PyTorch port: it imports neither jax nor adaprompt_tpu, its
entry points default to CUDA and raise without it, and a kernel wrapper
takes its plain version only for CPU tensors. The kernels themselves are
compared with their plain versions on the card (marker `cuda`)."""

import math
import os
import subprocess
import sys

import pytest
import torch

import adaprompt_tpu_torch
from adaprompt_tpu_torch import pipeline as tpipe
from adaprompt_tpu_torch.ops import attention as tattn, conv_halo as tch, geglu as tgeglu
from adaprompt_tpu_torch.ops import kernel_wrappers
from adaprompt_tpu_torch.ops.quant import quantize_weight

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
    from adaprompt_tpu_torch.models.arcface import ArcFace
    from adaprompt_tpu_torch.train.trainer import (AdaPromptTrainer, TrainerConfig,
                                                   synthetic_raw_batches)
    return {"AdaFacePipeline": lambda: AdaFacePipeline.random_init(0),
            "AdaPromptTrainer": lambda: AdaPromptTrainer.random_init(
                0, synthetic_raw_batches(0), TrainerConfig(seed=0)),
            "ArcFace": lambda: ArcFace.random_init(0),
            "profile_step": _profile_step_main}


@pytest.mark.parametrize("name", ["AdaFacePipeline", "AdaPromptTrainer", "ArcFace",
                                  "profile_step"])
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
@pytest.mark.parametrize("b,n,c,h", [(2, 100, 64, 2), (1, 512, 320, 8), (1, 70, 1280, 8)])
def test_fused_cross_kernel_ragged_shapes(b, n, c, h):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(n + c)
    rn = lambda *s: torch.randn(*s, device="cuda", generator=g)
    args = (rn(b, n, c).bfloat16(), (rn(c, c) / c ** 0.5).bfloat16(),
            rn(b, 77, h, c // h).bfloat16(), rn(b, 77, h, c // h).bfloat16(),
            (rn(c, c) / c ** 0.5).bfloat16(), rn(c) / 8, (c // h) ** -0.5, h)
    _assert_near(tattn.fused_cross_attention(*args),
                 tattn.fused_cross_attention_reference(*args), 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("m,c", [(50, 320), (33, 640), (96, 16)])
def test_geglu_kernel_ragged_shapes(m, c):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(m + c)
    rn = lambda *s: torch.randn(*s, device="cuda", generator=g)
    f = 4 * c
    args = (rn(m, c).bfloat16(), (rn(2 * f, c) / c ** 0.5).bfloat16(), rn(2 * f) / 8,
            (rn(c, f) / f ** 0.5).bfloat16(), rn(c) / 8)
    _assert_near(tgeglu.geglu(*args), tgeglu.geglu_reference(*args), 1e-2)


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


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,h", [(2, 100, 64, 2), (1, 512, 320, 8), (3, 33, 640, 8),
                                     (1, 70, 1280, 8)])
def test_int8_fused_cross_kernel_ragged_shapes(b, n, c, h):
    """Ragged row tiles, padded head dims and keys; bf16 against the plain
    version (x and o quantized per row, int8 projections)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(n + c)
    rn = lambda *s: torch.randn(*s, device="cuda", generator=g)
    args = _int8_cross_args(rn(b, n, c).bfloat16(), rn(c, c) / c ** 0.5,
                            rn(b, 77, h, c // h).bfloat16(), rn(b, 77, h, c // h).bfloat16(),
                            rn(c, c) / c ** 0.5, rn(c) / 8)
    before = tattn.fused_cross_attention_int8.launches
    _assert_near(tattn.fused_cross_attention_int8(*args, (c // h) ** -0.5, h),
                 tattn.fused_cross_attention_int8_reference(*args, (c // h) ** -0.5, h), 2e-2)
    assert tattn.fused_cross_attention_int8.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("m,c", [(50, 320), (33, 640), (96, 32), (8, 64), (4096, 640)])
def test_int8_geglu_kernel_ragged_shapes(m, c):
    """Ragged row tiles at both shared-memory tilings (32 rows up to C=320,
    16 rows at C=640); bf16 against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(m + c)
    rn = lambda *s: torch.randn(*s, device="cuda", generator=g)
    f = 4 * c
    args = _int8_geglu_args(rn(m, c).bfloat16(), rn(2 * f, c) / c ** 0.5, rn(2 * f) / 8,
                            rn(c, f) / f ** 0.5, rn(c) / 8)
    before = tgeglu.geglu_int8.launches
    _assert_near(tgeglu.geglu_int8(*args), tgeglu.geglu_int8_reference(*args), 2e-2)
    assert tgeglu.geglu_int8.launches == before + 1


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
          (2, 12, 12, 64, 48), (1, 16, 16, 1280, 64), (1, 5, 40, 8, 136)]


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


@pytest.mark.cuda
@pytest.mark.parametrize("gn_shift", [0.0, 3.0])
@pytest.mark.parametrize("b,h,w,c,o", [(2, 8, 8, 32, 32), (3, 7, 33, 96, 72), (2, 12, 12, 64, 48),
                                       (1, 21, 13, 160, 40), (1, 16, 16, 1280, 64)])
def test_gn_silu_conv_kernel_ragged_shapes(b, h, w, c, o, gn_shift):
    """The fused kernel on ragged tiles; gn_shift=3 makes an unmasked border
    (silu(b) instead of 0 outside the image) miss the bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    x, wt, bias, gs, gb = _card_case(h + w + c + o + 1, b, h, w, c, o, gn_shift)
    before = tch.gn_silu_conv3x3_halo.launches
    out = tch.gn_silu_conv3x3_halo(x, gs, gb, wt, bias)
    assert tch.gn_silu_conv3x3_halo.launches == before + 1
    _assert_near(out, tch.gn_silu_conv3x3_halo_reference(x, gs, gb, wt, bias), 2e-2)


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


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,d,biased", [(1, 300, 203, 3, 64, True),
                                                (2, 100, 1000, 2, 128, False),
                                                (2, 512, 512, 8, 40, True),
                                                (1, 1024, 1024, 8, 80, False),
                                                (2, 64, 64, 2, 16, False)])
def test_int8_flash_kernel_ragged_shapes(b, sq, sk, h, d, biased):
    """The int8-QK kernel against its plain version, both from the operands
    the same PyTorch code makes on the card: head dims padded to the int8
    depth (64 -> 64, 128, 40 -> 64, 80 -> 96, 16 -> 32), a key count off a
    multiple of 4 (byte loads), ragged tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(sq + sk + d)
    q = torch.randn(b, sq, h, d, device="cuda", generator=g).bfloat16()
    k = (torch.randn(b, sk, h, d, device="cuda", generator=g) + 0.7).bfloat16()
    v = torch.randn(b, sk, h, d, device="cuda", generator=g).bfloat16()
    bias = None
    if biased:
        bias = torch.where(torch.rand(b, sk, device="cuda", generator=g) < 0.6, 0.0,
                           tattn.NEG_BIG)
    before = tattn.flash_attention_int8.launches
    out = tattn.flash_attention_int8(q, k, v, bias)
    assert tattn.flash_attention_int8.launches == before + 1 and out.shape == q.shape
    _assert_near(out, tattn.flash_attention_int8_reference(q, k, v, bias), 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,h,biased", [(2, 100, 64, 2, True), (1, 1000, 320, 8, True),
                                            (2, 512, 640, 8, False), (1, 77, 1280, 8, False)])
def test_fused_self_attention_kernel_ragged_shapes(b, n, c, h, biased):
    """Row tiles of 32 (C <= 640) and 16, ragged N, padded head dims."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(n + c)
    rn = lambda *s: torch.randn(*s, device="cuda", generator=g)
    w = lambda: (rn(c, c) / c ** 0.5).bfloat16()
    bias = None
    if biased:
        bias = torch.where(torch.rand(b, n, device="cuda", generator=g) < 0.6, 0.0, tattn.NEG_BIG)
    args = (rn(b, n, c).bfloat16(), w(), w(), w(), w(), rn(c) / 8, (c // h) ** -0.5, h, bias)
    before = tattn.fused_self_attention.launches
    out = tattn.fused_self_attention(*args)
    assert tattn.fused_self_attention.launches == before + 1
    _assert_near(out, tattn.fused_self_attention_reference(*args), 2e-2)


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
