"""Attention ops of the port.

Port of `adaprompt_tpu/ops/attention.py`. `dot_product_attention` is the
shared attention primitive; q/k/v are [B, S, H, D] as in the JAX package.

Two kernels live here, each beside its plain PyTorch version and with a
launch count on its wrapper:
  * `flash_attention_fwd` — flash attention forward with an optional
    additive per-key bias, returning the output and the per-row logsumexp
    (CUDA: csrc/flash_attention.cu; replaces `_fwd_kernel`);
  * `fused_cross_attention` — q-projection, attention over a small
    precomputed K/V and out-projection in one kernel (CUDA:
    csrc/fused_cross_attention.cu; replaces `_fused_cross_kernel`).
A wrapper takes its plain version for CPU tensors only. For CUDA tensors it
launches the kernel or raises; the kernels take bfloat16.

Masking: `mask` is an additive mask broadcastable to [B, H, Sq, Sk] (plain
path only); `key_bias` is an additive [B, Sk] bias (NEG_BIG on dropped keys),
which both paths take.
"""

from __future__ import annotations

import ctypes
import math

import torch

from adaprompt_tpu_torch.ops import cuda_build

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
        return flash_attention_fwd(q, k, v, key_bias, scale)[0]
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
# Kernel 2: fused cross-attention over a precomputed small K/V
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
