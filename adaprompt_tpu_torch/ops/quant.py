"""Symmetric int8 quantization for the w8a8 serving path (`quant="int8"`).

Port of `adaprompt_tpu/ops/quant.py::quantize_weight` and `quantize_acts`.
Weights here are in PyTorch's [out, in] layout, so the per-output-channel
scale reduces over dim 1 (the JAX package's [in, out] weights reduce over
axis 0). Both functions compute scale = max|w| / 127 + 1e-8 in float32, in
that order, then round w / scale (a true division) half to even
(`torch.round`, as `jnp.round`) and clip to +-127, so the two packages give
equal int8 values from equal inputs.

The int8 weights are made once per `generate` (`UNet.quantize_int8`), as the
JAX package's scan hoists the quantization out of its loop; the activations
are quantized per row inside the kernels (csrc/fused_cross_attention_int8.cu,
csrc/geglu_int8.cu) and inside their plain versions. `int8_linear` and
`int8_matmul_2operand` are the JAX package's plain w8a8 building blocks,
plain PyTorch here too; no model calls them, as in the JAX package (its UNet
keeps the projections in the compute dtype).
"""

from __future__ import annotations

import torch

INT8_MAX = 127.0


def _scale(absmax: torch.Tensor, eps: float) -> torch.Tensor:
    """absmax / 127 + eps with a true division on every device: PyTorch's
    CUDA kernels compute a division by a Python scalar as a multiplication
    by its reciprocal, which can be an ulp off (and off the kernels'
    __fdiv_rn)."""
    return absmax / torch.full_like(absmax, INT8_MAX) + eps


def quantize_weight(w: torch.Tensor, eps: float = 1e-8):
    """Per-output-channel quantization of a [N, K] ([out, in]) weight.

    Returns (w_q int8 [N, K], scale float32 [N]) with w ~= w_q * scale[:, None]."""
    w32 = w.float()
    scale = _scale(w32.abs().amax(dim=1), eps)
    w_q = torch.round(w32 / scale[:, None]).clamp(-INT8_MAX, INT8_MAX).to(torch.int8)
    return w_q, scale


def quantize_acts(x: torch.Tensor, eps: float = 1e-8):
    """Per-row quantization of [..., M, K].

    Returns (x_q int8, scale float32 [..., M, 1]) with x ~= x_q * scale."""
    x32 = x.float()
    scale = _scale(x32.abs().amax(dim=-1, keepdim=True), eps)
    x_q = torch.round(x32 / scale).clamp(-INT8_MAX, INT8_MAX).to(torch.int8)
    return x_q, scale


def int8_matmul(a_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """a_q [..., K] . w_q [N, K]^T for int8 operands, exact, as float32.

    The int32 sums can exceed 2^24 (127^2 * 2560 ~ 4.1e7), beyond float32's
    exact integers, so the product runs in float64, where every such sum is
    exact on the CPU and on the card alike; the cast to float32 then rounds
    as `jnp.dot(..., preferred_element_type=int32).astype(float32)` does."""
    return (a_q.double() @ w_q.double().t()).float()


def int8_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
                out_dtype=None) -> torch.Tensor:
    """y = x . w^T (+ b) as int8 x int8 -> int32, dequantized.

    x: [..., M, K]; w: [N, K] ([out, in]), quantized here per output channel;
    x per row. Returns [..., M, N] in `out_dtype` (default: x's dtype)."""
    w_q, w_scale = quantize_weight(w)
    x_q, x_scale = quantize_acts(x)
    y = int8_matmul(x_q, w_q) * x_scale * w_scale
    if b is not None:
        y = y + b.float()
    return y.to(out_dtype or x.dtype)


def int8_matmul_2operand(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Batched a . b with both operands quantized on the fly: a [..., M, K]
    per row, b [..., K, N] per column (over K), sharing the leading batch
    dims (the attention p.v product: per channel of the output).
    Returns [..., M, N] in `out_dtype` (default: a's dtype)."""
    a_q, a_scale = quantize_acts(a)
    b32 = b.float()
    b_scale = _scale(b32.abs().amax(dim=-2, keepdim=True), 1e-8)
    b_q = torch.round(b32 / b_scale).clamp(-INT8_MAX, INT8_MAX).to(torch.int8)
    y = (a_q.double() @ b_q.double()).float() * a_scale * b_scale
    return y.to(out_dtype or a.dtype)
