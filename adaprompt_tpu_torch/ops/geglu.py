"""Fused GEGLU feed-forward: proj -> split -> a * gelu(gate) -> out.

Port of `adaprompt_tpu/ops/geglu.py`. Two kernel wrappers, each with a
launch count, each taking its plain version for CPU tensors only and for
CUDA tensors launching its kernel or raising:
  * `geglu_fwd` (CUDA: csrc/geglu.cu; replaces `_geglu_kernel`), bfloat16,
    plain version `geglu_reference`. One C call runs two kernels, x.W1^T ->
    g and g.W2^T -> out, with g [M, F] bf16 in a scratch that the wrapper
    allocates; it counts one launch. `geglu` is the differentiable op: an
    autograd Function whose forward is `geglu_fwd` and whose backward
    recomputes through `geglu_reference` under autograd, as the JAX
    package's `_geglu_bwd` does (its backward is XLA, not a kernel);
  * `geglu_int8` (CUDA: csrc/geglu_int8.cu; replaces `_geglu_i8_kernel`),
    the w8a8 variant of the `quant="int8"` serving path, forward only,
    plain version `geglu_int8_reference`. One C call runs four kernels, x
    quantized, x_q.W1_q^T -> g in fp32, g quantized, g_q.W2_q^T -> out, in
    one workspace that the wrapper allocates; it counts one launch.

Weights are in PyTorch's layout: w1 [2F, C], w2 [C, F].
"""

from __future__ import annotations

import ctypes
import functools

import torch

from adaprompt_tpu_torch.ops import cuda_build
from adaprompt_tpu_torch.ops.layers import gelu
from adaprompt_tpu_torch.ops.quant import int8_matmul, quantize_acts


def geglu_reference(x, w1, b1, w2, b2):
    """Plain version: h = x.W1^T + b1 in fp32, g = a * gelu_erf(gate) in fp32,
    g rounded to x's dtype, then g.W2^T + b2 in fp32, cast to x's dtype."""
    h = x.float() @ w1.float().t() + b1.float()
    a, gate = h.chunk(2, dim=-1)
    g = (a * gelu(gate)).to(x.dtype)
    return (g.float() @ w2.float().t() + b2.float()).to(x.dtype)


def fused_eligible(x, w1) -> bool:
    """The JAX package's rule, kept exactly so both packages fuse the same
    layers: both weight matrices within 10 MB, rows a multiple of 8, 2F a
    multiple of 256. In bf16 that admits the SD-1.5 C=320 and C=640 layers
    and not C=1280. The 10 MB cap is the TPU's VMEM budget, not a limit of
    the CUDA kernel; it is to be revisited for the H100."""
    f2, c = w1.shape
    m = x.numel() // x.shape[-1]
    weights_bytes = (c * f2 + (f2 // 2) * c) * x.element_size()
    return weights_bytes <= 10_000_000 and m % 8 == 0 and f2 % 256 == 0


def geglu_fwd(x, w1, b1, w2, b2):
    """Fused GEGLU forward: x [..., C]; w1 [2F, C]; b1 [2F]; w2 [C, F]; b2 [C]."""
    if x.device.type == "cpu":
        return geglu_reference(x, w1, b1, w2, b2)
    shape = x.shape
    c = shape[-1]
    f2 = w1.shape[0]
    f = f2 // 2
    if w1.shape != (f2, c) or w2.shape != (c, f) or f2 % 2:
        raise ValueError(f"geglu kernel: shapes x{tuple(shape)} w1{tuple(w1.shape)} "
                         f"w2{tuple(w2.shape)}")
    if c % 16 or f % 64:
        raise ValueError(f"geglu kernel: needs C % 16 == 0 and F % 64 == 0 (C={c}, F={f})")
    m = x.numel() // c
    x2, w1, w2 = cuda_build.kernel_operands("geglu kernel", x.reshape(m, c), w1, w2)
    b1 = b1.to(device=x.device, dtype=torch.float32).contiguous()
    b2 = b2.to(device=x.device, dtype=torch.float32).contiguous()
    g = torch.empty((m, f), dtype=x2.dtype, device=x2.device)   # the kernels' scratch
    out = torch.empty_like(x2)
    fn = cuda_build.function("geglu", "geglu_fwd",
                             [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    cuda_build.check(fn(x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                        b2.data_ptr(), g.data_ptr(), out.data_ptr(), m, c, f,
                        torch.cuda.current_stream(x.device).cuda_stream),
                     "geglu_fwd")
    geglu_fwd.launches += 1
    return out.reshape(shape)


geglu_fwd.launches = 0


class _Geglu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return geglu_fwd(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = geglu_reference(*inputs)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, g.to(out.dtype)))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def geglu(x, w1, b1, w2, b2):
    """Fused GEGLU, differentiable in every input: x [..., C]; w1 [2F, C];
    b1 [2F]; w2 [C, F]; b2 [C]."""
    return _Geglu.apply(x, w1, b1, w2, b2)


# ---------------------------------------------------------------------------
# w8a8 fused GEGLU (forward only; the quant="int8" serving path)
# ---------------------------------------------------------------------------

def fused_int8_eligible(x, w1) -> bool:
    """The JAX package's rule for its int8 kernel, kept exactly: int8
    weights (1 byte each) within 8 MB, rows a multiple of 8, 2F a multiple
    of 256. That admits the SD-1.5 C=320 and C=640 layers and not C=1280."""
    f2, c = w1.shape
    m = x.numel() // x.shape[-1]
    weights_bytes = c * f2 + (f2 // 2) * c
    return weights_bytes <= 8_000_000 and m % 8 == 0 and f2 % 256 == 0


def geglu_int8_reference(x, w1_q, w1_s, b1, w2_q, w2_s, b2):
    """Plain version of the w8a8 kernel, rounding where the TPU kernel does:
    x quantized per row; h = int(x_q . W1_q^T) * xs * s1 + b1 in fp32;
    g = a * gelu_erf(gate) in fp32, quantized per row from its fp32 value;
    out = int(g_q . W2_q^T) * gs * s2 + b2, cast to x's dtype. The integer
    products are exact (`quant.int8_matmul`)."""
    x_q, xs = quantize_acts(x)
    h = int8_matmul(x_q, w1_q) * xs * w1_s + b1.float()
    a, gate = h.chunk(2, dim=-1)
    g_q, gs = quantize_acts(a * gelu(gate))
    out = int8_matmul(g_q, w2_q) * gs * w2_s + b2.float()
    return out.to(x.dtype)


def geglu_int8(x, w1_q, w1_s, b1, w2_q, w2_s, b2):
    """w8a8 fused GEGLU forward: x [..., C]; (w1_q int8 [2F, C], w1_s f32
    [2F]) and (w2_q int8 [C, F], w2_s f32 [C]) from `quant.quantize_weight`;
    b1 [2F]; b2 [C]. Forward only (rounding has no gradient). On the card one
    C call runs four kernels (x quantized, x_q.W1_q^T -> fp32 g and its
    per-row partial maxima, g quantized, g_q.W2_q^T -> out) in a workspace
    that the wrapper allocates; it counts one launch."""
    if x.device.type == "cpu":
        return geglu_int8_reference(x, w1_q, w1_s, b1, w2_q, w2_s, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1_s, b1, w2_s, b2)):
        raise RuntimeError("int8 geglu kernel: forward only (as the JAX package's)")
    shape = x.shape
    c = shape[-1]
    f2 = w1_q.shape[0]
    f = f2 // 2
    if (w1_q.shape != (f2, c) or w2_q.shape != (c, f) or w1_s.shape != (f2,)
            or w2_s.shape != (c,) or f2 % 2):
        raise ValueError(f"int8 geglu kernel: shapes x{tuple(shape)} w1{tuple(w1_q.shape)} "
                         f"w2{tuple(w2_q.shape)}")
    if c % 16 or f % 64:
        raise ValueError(f"int8 geglu kernel: needs C % 16 == 0 and F % 64 == 0 (C={c}, F={f})")
    m = x.numel() // c
    (x2,) = cuda_build.kernel_operands("int8 geglu kernel", x.reshape(m, c))
    w1_q, w2_q = cuda_build.kernel_operands("int8 geglu kernel", w1_q, w2_q, dtype=torch.int8)
    w1_s, b1, w2_s, b2 = (t.to(device=x.device, dtype=torch.float32).contiguous()
                          for t in (w1_s, b1, w2_s, b2))
    work = torch.empty(_int8_workspace_bytes(m, c, f), dtype=torch.uint8, device=x2.device)
    out = torch.empty_like(x2)
    geglu_int8_kernel_call(x2, w1_q, w1_s, b1, w2_q, w2_s, b2, work, out)
    geglu_int8.launches += 1
    return out.reshape(shape)


def geglu_int8_kernel_call(x2, w1_q, w1_s, b1, w2_q, w2_s, b2, work, out):
    """The int8 kernels' C call on operands as `geglu_int8` validates them
    (x2 [M, C] bf16; float32 scales and biases; `work`, a uint8 workspace of
    `_int8_workspace_bytes(M, C, F)`, and out [M, C] allocated). Not counted:
    the wrapper counts its calls."""
    m, c = x2.shape
    fn = cuda_build.function("geglu_int8", "geglu_int8_fwd",
                             [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    cuda_build.check(fn(x2.data_ptr(), w1_q.data_ptr(), w1_s.data_ptr(), b1.data_ptr(),
                        w2_q.data_ptr(), w2_s.data_ptr(), b2.data_ptr(), out.data_ptr(),
                        work.data_ptr(), m, c, w2_q.shape[1],
                        torch.cuda.current_stream(x2.device).cuda_stream),
                     "geglu_int8_fwd")


@functools.lru_cache(maxsize=None)
def _int8_workspace_bytes(m, c, f) -> int:
    """The bytes of scratch `geglu_int8_fwd` takes at these shapes (x_q, g in
    fp32, g's partial row maxima, g_q and the two row scales), as the C side
    lays them out; asked of it once a shape."""
    fn = cuda_build.function("geglu_int8", "geglu_int8_workspace",
                             [ctypes.c_int] * 3 + [ctypes.c_void_p])
    nbytes = ctypes.c_longlong()
    cuda_build.check(fn(m, c, f, ctypes.addressof(nbytes)), "geglu_int8_workspace")
    return nbytes.value


geglu_int8.launches = 0
