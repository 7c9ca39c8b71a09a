"""Attention ops of the port.

Port of `adaprompt_tpu/ops/attention.py`. `dot_product_attention` is the
shared attention primitive; q/k/v are [B, S, H, D] as in the JAX package.

Four kernels live here, each beside its plain PyTorch version and with a
launch count on its wrapper:
  * `flash_attention_fwd` — flash attention forward with an optional
    additive per-key bias, returning the output and the per-row logsumexp
    (CUDA: csrc/flash_attention.cu; replaces `_fwd_kernel`);
  * `flash_attention_bwd` — its recomputation backward from that logsumexp
    (CUDA: csrc/flash_attention_bwd.cu; replaces `_dq_kernel` and
    `_dkv_kernel`);
  * `fused_cross_attention` — q-projection, attention over a small
    precomputed K/V and out-projection in one kernel, forward only (CUDA:
    csrc/fused_cross_attention.cu; replaces `_fused_cross_kernel`);
  * `fused_cross_attention_int8` — its w8a8 variant for the `quant="int8"`
    serving path, with int8 q- and out-projections, forward only (CUDA:
    csrc/fused_cross_attention_int8.cu; replaces `_fused_cross_i8_kernel`).
`flash_attention` ties the first two together as an autograd Function, as
the JAX package's `custom_vjp` does. A wrapper takes its plain version for
CPU tensors only. For CUDA tensors it launches the kernel or raises; the
kernels take bfloat16 activations (and the int8 kernel int8 weights).

Masking: `mask` is an additive mask broadcastable to [B, H, Sq, Sk] (plain
path only); `key_bias` is an additive [B, Sk] bias (NEG_BIG on dropped keys),
which both paths take and which gets no gradient.
"""

from __future__ import annotations

import ctypes
import math

import torch

from adaprompt_tpu_torch.ops import cuda_build
from adaprompt_tpu_torch.ops.quant import int8_matmul, quantize_acts

_FLASH_MIN_Q = 512
_FLASH_MIN_K = 256
NEG_BIG = -1e9      # masked-key bias; finite so exp arithmetic stays NaN-free

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def causal_mask(seq_len: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Additive causal mask [1, 1, S, S] (0 on/below diagonal, -inf above)."""
    mask = torch.full((seq_len, seq_len), -math.inf, dtype=dtype, device=device)
    return torch.triu(mask, diagonal=1)[None, None]


def dot_product_attention(q, k, v, mask=None, key_bias=None, scale=None,
                          use_flash: bool | None = None) -> torch.Tensor:
    """Multi-head attention: q [B, Sq, H, D], k [B, Sk, H, D], v [B, Sk, H, Dv]
    -> [B, Sq, H, Dv]. Dispatch as the JAX package: the flash kernel when
    Sq >= 512, Sk >= 256 and there is no full mask."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if use_flash is None:
        use_flash = (mask is None and q.shape[1] >= _FLASH_MIN_Q
                     and k.shape[1] >= _FLASH_MIN_K)
    if use_flash:
        if mask is not None:
            raise ValueError("use_flash=True cannot honor a full additive "
                             "mask; pass key_bias instead")
        return flash_attention(q, k, v, key_bias, scale)
    return attention_reference(q, k, v, key_bias, scale, mask)[0]


# ---------------------------------------------------------------------------
# Kernel 1: flash attention forward
# ---------------------------------------------------------------------------

def attention_reference(q, k, v, key_bias, scale, mask=None):
    """Plain attention, and the plain version of the flash kernel: fp32
    logits and softmax, probabilities cast to v's dtype.
    Returns (out [B,Sq,H,Dv], lse [B*H,Sq,1] float32)."""
    b, sq, h, _ = q.shape
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits + mask.float()
    if key_bias is not None:
        logits = logits + key_bias.float()[:, None, None, :]
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None]).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out, lse.reshape(b * h, sq, 1)


def flash_attention_fwd(q, k, v, key_bias, scale):
    """Flash attention forward with an optional [B, Sk] key bias.

    Returns (out [B, Sq, H, D] in q's dtype, lse [B*H, Sq, 1] float32)."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, key_bias, scale)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if k.shape != (b, sk, h, d) or v.shape != (b, sk, h, d):
        raise ValueError(f"flash kernel: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} (needs Dv == D)")
    if d % 8 or d > 128:
        raise ValueError(f"flash kernel: head dim {d} must be a multiple of 8, <= 128")
    q, k, v = cuda_build.kernel_operands("flash kernel", q, k, v)
    bias = None
    if key_bias is not None:
        bias = key_bias.to(device=q.device, dtype=torch.float32).contiguous()
        if bias.shape != (b, sk):
            raise ValueError(f"flash kernel: key_bias {tuple(bias.shape)} != {(b, sk)}")
    out = torch.empty_like(q)
    lse = torch.empty((b * h, sq, 1), device=q.device, dtype=torch.float32)
    fn = cuda_build.function("flash_attention", "flash_attention_fwd",
                             [_P] * 6 + [_I] * 5 + [_F, _P])
    cuda_build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        bias.data_ptr() if bias is not None else None,
                        out.data_ptr(), lse.data_ptr(), b, sq, sk, h, d,
                        float(scale), torch.cuda.current_stream(q.device).cuda_stream),
                     "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


# ---------------------------------------------------------------------------
# Kernel 2: flash attention backward, and the autograd Function over both
# ---------------------------------------------------------------------------

def flash_attention_bwd_reference(q, k, v, key_bias, out, lse, dout, scale):
    """Plain version of the backward kernel: the same formulas in fp32 from
    the same saved tensors (p recomputed from lse).
    Returns (dq, dk, dv), each in q's dtype."""
    b, sq, h, _ = q.shape
    qf, kf, vf, of, gf = (x.float() for x in (q, k, v, out, dout))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    p = torch.exp(s - lse.reshape(b, h, sq, 1))
    delta = (gf * of).sum(-1).permute(0, 2, 1)[..., None]          # [B, H, Sq, 1]
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q, k, v, key_bias, out, lse, dout, scale):
    """Flash attention backward: q/k/v/out/dout [B, S, H, D], lse [B*H, Sq, 1]
    float32 from `flash_attention_fwd`. Returns (dq, dk, dv); the key bias
    gets no gradient. delta = rowsum(dout * out) is a small torch reduction,
    as the JAX package leaves it to XLA."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, key_bias, out, lse, dout, scale)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if (k.shape != (b, sk, h, d) or v.shape != k.shape or out.shape != q.shape
            or dout.shape != q.shape or lse.shape != (b * h, sq, 1)):
        raise ValueError(f"flash backward kernel: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} out{tuple(out.shape)} dout{tuple(dout.shape)} "
                         f"lse{tuple(lse.shape)}")
    if d % 8 or d > 128:
        raise ValueError(f"flash backward kernel: head dim {d} must be a multiple of 8, <= 128")
    q, k, v, dout = cuda_build.kernel_operands("flash backward kernel", q, k, v, dout)
    bias = None
    if key_bias is not None:
        bias = key_bias.to(device=q.device, dtype=torch.float32).contiguous()
        if bias.shape != (b, sk):
            raise ValueError(f"flash backward kernel: key_bias {tuple(bias.shape)} != {(b, sk)}")
    lse = lse.to(torch.float32).contiguous()
    delta = (dout.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()   # [B, H, Sq]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fn = cuda_build.function("flash_attention_bwd", "flash_attention_bwd",
                             [_P] * 10 + [_I] * 5 + [_F, _P])
    cuda_build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        bias.data_ptr() if bias is not None else None,
                        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, sk, h, d,
                        float(scale), torch.cuda.current_stream(q.device).cuda_stream),
                     "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Forward runs `flash_attention_fwd` and saves out and lse; backward
    runs `flash_attention_bwd` (the JAX package's custom_vjp pair)."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, scale):
        out, lse = flash_attention_fwd(q, k, v, key_bias, scale)
        ctx.save_for_backward(q, k, v, key_bias, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_bias, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, key_bias, out, lse,
                                         dout.contiguous(), ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, key_bias, scale):
    """Flash attention with an optional [B, Sk] key bias, differentiable in
    q, k and v. Returns [B, Sq, H, D]."""
    return _FlashAttention.apply(q, k, v, key_bias, scale)


# ---------------------------------------------------------------------------
# Kernel 3: fused cross-attention over a precomputed small K/V
# ---------------------------------------------------------------------------

def fused_cross_attention_reference(x, wq, k, v, wo, bo, scale, num_heads):
    """Plain version of the fused kernel, rounding where the TPU kernel does:
    q to x's dtype, probabilities to x's dtype, the head concat to x's dtype."""
    b, n, c = x.shape
    hd = c // num_heads
    q = (x.float() @ wq.float().t()).to(x.dtype).reshape(b, n, num_heads, hd)
    s = torch.einsum("bnhd,bshd->bhns", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(x.dtype)
    o = torch.einsum("bhns,bshd->bnhd", p.float(), v.float())
    o = o.reshape(b, n, c).to(x.dtype)
    return (o.float() @ wo.float().t() + bo.float()).to(x.dtype)


def fused_cross_attention(x, wq, k, v, wo, bo, scale, num_heads):
    """x [B, N, C] (pre-normed); wq, wo [C, C] ([out, in]); k/v [B, S, H, hd]
    (from precompute_cross_kv); bo [C]. Returns [B, N, C]: the attention
    output after the out-projection (add the residual outside)."""
    if x.device.type == "cpu":
        return fused_cross_attention_reference(x, wq, k, v, wo, bo, scale, num_heads)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, wq, k, v, wo, bo)):
        raise RuntimeError("fused cross kernel: forward only (as the JAX package's); "
                           "training never hoists the cross-attention K/V")
    b, n, c = x.shape
    s = k.shape[1]
    hd = c // num_heads
    if (c % num_heads or wq.shape != (c, c) or wo.shape != (c, c)
            or k.shape != (b, s, num_heads, hd) or v.shape != k.shape):
        raise ValueError(f"fused cross kernel: shapes x{tuple(x.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} wq{tuple(wq.shape)} with {num_heads} heads")
    if c % 16:
        raise ValueError(f"fused cross kernel: C={c} must be a multiple of 16")
    x, wq, k, v, wo = cuda_build.kernel_operands("fused cross kernel", x, wq, k, v, wo)
    bo32 = bo.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(x)
    fn = cuda_build.function("fused_cross_attention", "fused_cross_attention_fwd",
                             [_P] * 7 + [_I] * 5 + [_F, _P])
    cuda_build.check(fn(x.data_ptr(), wq.data_ptr(), k.data_ptr(), v.data_ptr(),
                        wo.data_ptr(), bo32.data_ptr(), out.data_ptr(),
                        b, n, c, num_heads, s, float(scale),
                        torch.cuda.current_stream(x.device).cuda_stream),
                     "fused_cross_attention_fwd")
    fused_cross_attention.launches += 1
    return out


fused_cross_attention.launches = 0


# ---------------------------------------------------------------------------
# Kernel 4: w8a8 fused cross-attention (the quant="int8" serving path)
# ---------------------------------------------------------------------------

def fused_cross_attention_int8_reference(x, wq_q, wq_s, k, v, wo_q, wo_s, bo, scale, num_heads):
    """Plain version of the w8a8 kernel, rounding where the TPU kernel does:
    x quantized per row; q = int(x_q . Wq_q^T) * xs * sq cast to x's dtype;
    per head softmax(q_h . k_h^T * scale) in fp32, probabilities cast to x's
    dtype, o_h = p . v_h in fp32; the head concat o stays fp32 and is
    quantized per row across all heads; out = int(o_q . Wo_q^T) * os * so +
    bo, cast to x's dtype. The integer products are exact
    (`quant.int8_matmul`)."""
    b, n, c = x.shape
    hd = c // num_heads
    x_q, xs = quantize_acts(x)
    q = (int8_matmul(x_q, wq_q) * xs * wq_s).to(x.dtype).reshape(b, n, num_heads, hd)
    s = torch.einsum("bnhd,bshd->bhns", q.float(), k.float()) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (p / p.sum(dim=-1, keepdim=True)).to(x.dtype)
    o = torch.einsum("bhns,bshd->bnhd", p.float(), v.float()).reshape(b, n, c)
    o_q, os_ = quantize_acts(o)
    return (int8_matmul(o_q, wo_q) * os_ * wo_s + bo.float()).to(x.dtype)


def fused_cross_attention_int8(x, wq_q, wq_s, k, v, wo_q, wo_s, bo, scale, num_heads):
    """x [B, N, C] (pre-normed); (wq_q, wq_s) and (wo_q, wo_s) the int8
    [C, C] ([out, in]) weights and float32 [C] scales of
    `quant.quantize_weight`; k/v [B, S, H, hd] (from precompute_cross_kv);
    bo [C]. Returns [B, N, C]: the attention output after the
    out-projection (add the residual outside). Forward only."""
    if x.device.type == "cpu":
        return fused_cross_attention_int8_reference(x, wq_q, wq_s, k, v, wo_q, wo_s, bo, scale,
                                                    num_heads)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, wq_s, k, v, wo_s, bo)):
        raise RuntimeError("int8 fused cross kernel: forward only (as the JAX package's); "
                           "training never hoists the cross-attention K/V")
    b, n, c = x.shape
    s = k.shape[1]
    hd = c // num_heads
    if (c % num_heads or wq_q.shape != (c, c) or wo_q.shape != (c, c)
            or wq_s.shape != (c,) or wo_s.shape != (c,)
            or k.shape != (b, s, num_heads, hd) or v.shape != k.shape):
        raise ValueError(f"int8 fused cross kernel: shapes x{tuple(x.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} wq{tuple(wq_q.shape)} with {num_heads} heads")
    if c % 32 or c > 1280 or hd % 8:
        raise ValueError(f"int8 fused cross kernel: C={c} must be a multiple of 32, <= 1280, "
                         f"with a head dim ({hd}) a multiple of 8")
    x, k, v = cuda_build.kernel_operands("int8 fused cross kernel", x, k, v)
    wq_q, wo_q = cuda_build.kernel_operands("int8 fused cross kernel", wq_q, wo_q,
                                            dtype=torch.int8)
    wq_s, wo_s, bo32 = (t.to(device=x.device, dtype=torch.float32).contiguous()
                        for t in (wq_s, wo_s, bo))
    out = torch.empty_like(x)
    fn = cuda_build.function("fused_cross_attention_int8", "fused_cross_attention_int8_fwd",
                             [_P] * 9 + [_I] * 5 + [_F, _P])
    cuda_build.check(fn(x.data_ptr(), wq_q.data_ptr(), wq_s.data_ptr(), k.data_ptr(),
                        v.data_ptr(), wo_q.data_ptr(), wo_s.data_ptr(), bo32.data_ptr(),
                        out.data_ptr(), b, n, c, num_heads, s, float(scale),
                        torch.cuda.current_stream(x.device).cuda_stream),
                     "fused_cross_attention_int8_fwd")
    fused_cross_attention_int8.launches += 1
    return out


fused_cross_attention_int8.launches = 0
