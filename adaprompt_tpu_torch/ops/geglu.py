"""Fused GEGLU feed-forward: proj -> split -> a * gelu(gate) -> out.

Port of `adaprompt_tpu/ops/geglu.py`. `geglu` is the kernel wrapper (CUDA:
csrc/geglu.cu; replaces `_geglu_kernel`), with a launch count; it takes its
plain version, `geglu_reference`, for CPU tensors only, and for CUDA tensors
launches the kernel (bfloat16) or raises. Forward only: the recompute
backward of the JAX package comes with the training slice.

Weights are in PyTorch's layout: w1 [2F, C], w2 [C, F].
"""

from __future__ import annotations

import ctypes

import torch

from adaprompt_tpu_torch.ops import cuda_build
from adaprompt_tpu_torch.ops.layers import gelu


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


def geglu(x, w1, b1, w2, b2):
    """Fused GEGLU: x [..., C]; w1 [2F, C]; b1 [2F]; w2 [C, F]; b2 [C]."""
    if x.device.type == "cpu":
        return geglu_reference(x, w1, b1, w2, b2)
    shape = x.shape
    c = shape[-1]
    f2 = w1.shape[0]
    f = f2 // 2
    if w1.shape != (f2, c) or w2.shape != (c, f) or f2 % 2:
        raise ValueError(f"geglu kernel: shapes x{tuple(shape)} w1{tuple(w1.shape)} "
                         f"w2{tuple(w2.shape)}")
    if c % 16 or c > 640 or f % 64:
        raise ValueError(f"geglu kernel: needs C % 16 == 0, C <= 640 and F % 64 == 0 "
                         f"(C={c}, F={f})")
    m = x.numel() // c
    x2, w1, w2 = cuda_build.kernel_operands("geglu kernel", x.reshape(m, c), w1, w2)
    b1 = b1.to(device=x.device, dtype=torch.float32).contiguous()
    b2 = b2.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(x2)
    fn = cuda_build.function("geglu", "geglu_fwd",
                             [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    cuda_build.check(fn(x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                        b2.data_ptr(), out.data_ptr(), m, c, f,
                        torch.cuda.current_stream(x.device).cuda_stream),
                     "geglu_fwd")
    geglu.launches += 1
    return out.reshape(shape)


geglu.launches = 0
