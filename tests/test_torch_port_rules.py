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
from adaprompt_tpu_torch.ops import attention as tattn, geglu as tgeglu, kernel_wrappers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
    assert int(n) >= 14          # every module of the package was imported
    assert bad == "[]", bad


def test_random_init_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpipe.StableDiffusionPipeline.random_init(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpipe.resolve_device("cuda")
    assert tpipe.resolve_device("cpu").type == "cpu"


def _small_inputs(device, dtype):
    g = torch.Generator(device=device).manual_seed(0)
    rn = lambda *s: torch.randn(*s, generator=g, device=device).to(dtype)
    flash = (rn(2, 512, 2, 40), rn(2, 512, 2, 40), rn(2, 512, 2, 40))
    return {
        "flash": flash,
        # q, k, v, key_bias, out, lse, dout
        "flash_bwd": flash + (None, rn(2, 512, 2, 40), rn(4, 512, 1).float(), rn(2, 512, 2, 40)),
        "cross": (rn(2, 512, 64), rn(64, 64) / 8, rn(2, 77, 2, 32), rn(2, 77, 2, 32),
                  rn(64, 64) / 8, rn(64).float() / 8),
        "geglu": (rn(96, 64), rn(512, 64) / 8, rn(512).float() / 8, rn(64, 256) / 16,
                  rn(64).float() / 8),
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
    assert {n: w.launches for n, w in kernel_wrappers().items()} == before
    meta = {k: [None if a is None else a.to("meta") for a in v] for k, v in x.items()}
    with pytest.raises(TypeError, match="CUDA"):
        tattn.flash_attention_fwd(*meta["flash"], None, 40 ** -0.5)
    with pytest.raises(TypeError, match="CUDA"):
        tattn.flash_attention_bwd(*meta["flash_bwd"], 40 ** -0.5)
    with pytest.raises(TypeError, match="CUDA"):
        tattn.fused_cross_attention(*meta["cross"], 32 ** -0.5, 2)
    with pytest.raises(TypeError, match="CUDA"):
        tgeglu.geglu(*meta["geglu"])


def test_fused_cross_attention_refuses_gradients_off_the_cpu():
    """The fused cross-attention kernel is forward-only (as the JAX
    package's): off the CPU it raises rather than cut the autograd graph."""
    x = [a.to("meta") for a in _small_inputs("cpu", torch.float32)["cross"]]
    x[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        tattn.fused_cross_attention(*x, 32 ** -0.5, 2)
    with torch.no_grad(), pytest.raises(TypeError, match="CUDA"):
        tattn.fused_cross_attention(*x, 32 ** -0.5, 2)


def test_kernel_sources_and_wrappers_exist():
    from adaprompt_tpu_torch.ops import cuda_build
    for name in cuda_build.SOURCES:
        assert (cuda_build.CSRC / f"{name}.cu").is_file()
    assert set(kernel_wrappers()) == {"flash_attention_fwd", "flash_attention_bwd",
                                      "fused_cross_attention", "geglu_fwd"}
    assert adaprompt_tpu_torch.__version__


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
    out, lse = tattn.flash_attention_fwd(*x["flash"], None, 40 ** -0.5)
    args = x["flash"] + (None, out, lse, x["flash_bwd"][-1], 40 ** -0.5)
    for got, ref in zip(tattn.flash_attention_bwd(*args),
                        tattn.flash_attention_bwd_reference(*args)):
        _assert_near(got, ref, 1e-2)
    after = {n: w.launches for n, w in kernel_wrappers().items()}
    assert after == {n: before[n] + (2 if n == "flash_attention_fwd" else 1) for n in after}


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,d,biased", [(1, 300, 200, 3, 64, True),
                                                (2, 100, 77, 2, 80, True),
                                                (1, 129, 1000, 1, 128, False),
                                                (2, 64, 64, 4, 8, False)])
def test_flash_kernel_ragged_shapes(b, sq, sk, h, d, biased):
    """Ragged q and key tiles, padded head dims, key bias; out and lse."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(sq + sk)
    q = torch.randn(b, sq, h, d, device="cuda", generator=g).bfloat16()
    k, v = (torch.randn(b, sk, h, d, device="cuda", generator=g).bfloat16() for _ in range(2))
    bias = None
    if biased:
        bias = torch.where(torch.rand(b, sk, device="cuda", generator=g) < 0.6, 0.0,
                           tattn.NEG_BIG)
    out, lse = tattn.flash_attention_fwd(q, k, v, bias, d ** -0.5)
    ref, lse_ref = tattn.attention_reference(q, k, v, bias, d ** -0.5)
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


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,d,biased", [(1, 300, 200, 3, 64, True),
                                                (2, 100, 77, 2, 80, True),
                                                (1, 129, 1000, 1, 128, False),
                                                (2, 64, 64, 4, 8, False),
                                                (2, 512, 512, 8, 40, True)])
def test_flash_backward_kernel_ragged_shapes(b, sq, sk, h, d, biased):
    """Ragged q and key tiles, padded head dims, key bias: dq, dk, dv
    against the plain version (P and dS are rounded to bf16 in the kernel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(sq + sk + d)
    rn = lambda s: torch.randn(*s, device="cuda", generator=g).bfloat16()
    q, k, v, dout = rn((b, sq, h, d)), rn((b, sk, h, d)), rn((b, sk, h, d)), rn((b, sq, h, d))
    bias = None
    if biased:
        bias = torch.where(torch.rand(b, sk, device="cuda", generator=g) < 0.6, 0.0,
                           tattn.NEG_BIG)
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
