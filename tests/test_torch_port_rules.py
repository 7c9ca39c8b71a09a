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
                                      "gn_silu_conv3x3_halo", "conv3x3_halo", "conv3x3_im2col"}
    assert set(cuda_build.SOURCES) == {"flash_attention", "flash_attention_bwd",
                                       "fused_cross_attention", "geglu",
                                       "fused_cross_attention_int8", "geglu_int8", "conv_halo"}
    src = (cuda_build.CSRC / "conv_halo.cu").read_text()
    for fn in ("gn_silu_conv3x3_halo_fwd", "conv3x3_halo_fwd", "conv3x3_im2col_fwd"):
        assert f'extern "C" int {fn}(' in src
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
