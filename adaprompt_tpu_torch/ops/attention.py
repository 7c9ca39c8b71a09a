"""Attention ops of the port.

Port of `adaprompt_tpu/ops/attention.py`. `dot_product_attention` is the
shared attention primitive; q/k/v are [B, S, H, D] as in the JAX package.

Eight kernels live here, each beside its plain PyTorch version and with a
launch count on its wrapper:
  * `flash_attention_fwd` — flash attention forward with an optional
    additive per-key bias, returning the output and the per-row logsumexp
    (CUDA: csrc/flash_attention.cu; replaces `_fwd_kernel`);
  * `flash_attention_fwd_ilv` — the same function as two online-softmax
    chains over alternating key tiles (CUDA: csrc/flash_attention_ilv.cu;
    replaces `_fwd_kernel_ilv`);
  * `flash_attention_fwd_nomax` — the same function with the row max
    replaced by a cap on the row's scores, |q-hat_i| max_k |k_k| + 1 (CUDA:
    csrc/flash_attention_nomax.cu; replaces `_fwd_kernel_nomax`);
  * `flash_attention_bwd` — the recomputation backward from the logsumexp
    (CUDA: csrc/flash_attention_bwd.cu; replaces `_dq_kernel` and
    `_dkv_kernel`);
  * `fused_cross_attention` — q-projection, attention over a small
    precomputed K/V and out-projection in one kernel, forward only (CUDA:
    csrc/fused_cross_attention.cu; replaces `_fused_cross_kernel`);
  * `fused_cross_attention_int8` — its w8a8 variant for the `quant="int8"`
    serving path, with int8 q- and out-projections, forward only (CUDA:
    csrc/fused_cross_attention_int8.cu; replaces `_fused_cross_i8_kernel`);
  * `flash_attention_int8` — flash attention with per-token int8 Q and K,
    forward only, wired into no model as in the JAX package (CUDA:
    csrc/flash_attention_int8.cu; replaces `_fwd_kernel_i8`);
  * `fused_self_attention` — q-projection, attention over all N keys of a
    packed K|V and out-projection in one kernel, forward only, wired into no
    model as in the JAX package (CUDA: csrc/fused_self_attention.cu; replaces
    `_fused_self_kernel`).
`flash_attention` ties a forward kernel and the backward together as an
autograd Function, as the JAX package's `custom_vjp` does. `FlashVariant`
picks the forward kernel and the exp2 form of forward and backward; it takes
the place of the JAX package's `_EXP2`, `_ILV` and `_NOMAX` module switches
(the port reads no environment variable). Each of the four flash wrappers
counts its exp2-form launches in `exp2_launches` besides `launches`. A
wrapper takes its plain version for CPU tensors only. For CUDA tensors it
launches the kernel or raises; the kernels take bfloat16 activations (and
the int8 kernels int8 operands).

Masking: `mask` is an additive mask broadcastable to [B, H, Sq, Sk] (plain
path only); `key_bias` is an additive [B, Sk] bias (NEG_BIG on dropped keys),
which both paths take and which gets no gradient.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from adaprompt_tpu_torch.ops import cuda_build
from adaprompt_tpu_torch.ops.quant import int8_matmul, quantize_acts

_FLASH_MIN_Q = 512
_FLASH_MIN_K = 256
NEG_BIG = -1e9      # masked-key bias; finite so exp arithmetic stays NaN-free
LOG2E = 1.4426950408889634
ILV_BLOCK_K = 64    # the two-chain kernel's key tile: chains take alternate tiles of this size

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@dataclasses.dataclass(frozen=True)
class FlashVariant:
    """Which form of the flash kernels self-attention takes (all off: the
    one-chain natural-log kernels). `nomax` wins over `ilv`, as in the JAX
    package; `exp2` combines with each forward kernel and with the backward.
    The saved lse is the natural-log one under every variant, so any forward
    pairs with any backward."""
    exp2: bool = False
    ilv: bool = False
    nomax: bool = False

    @property
    def forward(self) -> str:
        """The forward kernel taken: "nomax", "ilv" or "base"."""
        return "nomax" if self.nomax else "ilv" if self.ilv else "base"


def causal_mask(seq_len: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Additive causal mask [1, 1, S, S] (0 on/below diagonal, -inf above)."""
    mask = torch.full((seq_len, seq_len), -math.inf, dtype=dtype, device=device)
    return torch.triu(mask, diagonal=1)[None, None]


def dot_product_attention(q, k, v, mask=None, key_bias=None, scale=None,
                          use_flash: bool | None = None,
                          variant: FlashVariant = FlashVariant()) -> torch.Tensor:
    """Multi-head attention: q [B, Sq, H, D], k [B, Sk, H, D], v [B, Sk, H, Dv]
    -> [B, Sq, H, Dv]. Dispatch as the JAX package: the flash kernel when
    Sq >= 512, Sk >= 256 and there is no full mask; `variant` picks its form."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if use_flash is None:
        use_flash = (mask is None and q.shape[1] >= _FLASH_MIN_Q
                     and k.shape[1] >= _FLASH_MIN_K)
    if use_flash:
        if mask is not None:
            raise ValueError("use_flash=True cannot honor a full additive "
                             "mask; pass key_bias instead")
        return flash_attention(q, k, v, key_bias, scale, variant)
    return attention_reference(q, k, v, key_bias, scale, mask)[0]


# ---------------------------------------------------------------------------
# Kernel 1: flash attention forward
# ---------------------------------------------------------------------------

def _flash_scores(q, k, key_bias, scale, exp2=False, round_q=False):
    """fp32 scores [B, H, Sq, Sk] as the flash kernels form them, and q-hat.
    Plainly: q.k^T * scale + key_bias, the scale applied to the fp32 product.
    Under `exp2` the scores are in the log2 domain: q-hat = q * scale*log2(e)
    rounded to q's dtype before the product, bias * log2(e). Under `round_q`
    (the no-max kernel, whose cap needs q-hat) q-hat = q * scale rounded."""
    fold = LOG2E if exp2 else 1.0
    if exp2 or round_q:
        q_hat = (q.float() * (scale * fold)).to(q.dtype)
        s = torch.einsum("bqhd,bkhd->bhqk", q_hat.float(), k.float())
    else:
        q_hat = q
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if key_bias is not None:
        s = s + (key_bias.float() * fold)[:, None, None, :]
    return s, q_hat


def _softmax_chain(s, v, exp2):
    """One online-softmax chain over all the keys of s [B, H, Sq, Sk'] as the
    kernels end it: (m, l, acc) with p = exp(s - m) summed in fp32 and
    rounded to v's dtype for p.v, acc [B, H, Sq, D] in fp32."""
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m) if exp2 else torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    return m, l, acc


def _finish(q, m, l, acc, exp2):
    """(out [B, Sq, H, D] in q's dtype, natural-log lse [B*H, Sq, 1])."""
    b, h, sq, _ = acc.shape
    lse = (m / LOG2E if exp2 else m) + torch.log(l)
    return (acc / l).permute(0, 2, 1, 3).to(q.dtype), lse.reshape(b * h, sq, 1)


def attention_reference(q, k, v, key_bias, scale, mask=None, exp2=False):
    """Plain attention, and the plain version of the flash kernel: fp32
    logits and softmax, probabilities cast to v's dtype. With `exp2` it
    repeats the exp2 form's arithmetic instead (`_flash_scores`, exp2, the
    sum divided out after p.v). A batch row whose key bias drops every key
    (NEG_BIG throughout) weighs its keys equally, as the JAX package's
    `jax.nn.softmax` and the kernels do: there fp32 loses log(sum) against
    the bias in lse, so exp(logits - lse) would sum to ~Sk, and such rows
    take the normalized softmax instead.
    Returns (out [B,Sq,H,Dv], lse [B*H,Sq,1] float32, natural log)."""
    if exp2:
        if mask is not None:
            raise ValueError("the exp2 form takes a key_bias, not a full mask")
        s, _ = _flash_scores(q, k, key_bias, scale, exp2=True)
        return _finish(q, *_softmax_chain(s, v, True), True)
    b, sq, h, _ = q.shape
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits + mask.float()
    if key_bias is not None:
        logits = logits + key_bias.float()[:, None, None, :]
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    if key_bias is not None:
        dropped = (key_bias.float() <= NEG_BIG / 2).all(dim=-1)[:, None, None, None]
        probs = torch.where(dropped, torch.softmax(logits, dim=-1), probs)
    probs = probs.to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out, lse.reshape(b * h, sq, 1)


def _flash_operands(what, q, k, v, key_bias):
    """Validated bf16 CUDA operands of a flash kernel and its dimensions."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if k.shape != (b, sk, h, d) or v.shape != (b, sk, h, d):
        raise ValueError(f"{what}: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} (needs Dv == D)")
    if d % 8 or d > 128:
        raise ValueError(f"{what}: head dim {d} must be a multiple of 8, <= 128")
    q, k, v = cuda_build.kernel_operands(what, q, k, v)
    bias = None
    if key_bias is not None:
        bias = key_bias.to(device=q.device, dtype=torch.float32).contiguous()
        if bias.shape != (b, sk):
            raise ValueError(f"{what}: key_bias {tuple(bias.shape)} != {(b, sk)}")
    return q, k, v, bias, (b, sq, sk, h, d)


def _count(wrapper, exp2):
    wrapper.launches += 1
    wrapper.exp2_launches += bool(exp2)


def _launch_flash_fwd(wrapper, what, lib, q, k, v, key_bias, scale, exp2):
    """Launch the forward kernel `wrapper.__name__` of csrc/`lib`.cu (the
    one-chain and two-chain kernels share their C interface) and count it."""
    q, k, v, bias, (b, sq, sk, h, d) = _flash_operands(what, q, k, v, key_bias)
    out = torch.empty_like(q)
    lse = torch.empty((b * h, sq, 1), device=q.device, dtype=torch.float32)
    fn = cuda_build.function(lib, wrapper.__name__, [_P] * 6 + [_I] * 5 + [_F, _I, _P])
    cuda_build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        bias.data_ptr() if bias is not None else None,
                        out.data_ptr(), lse.data_ptr(), b, sq, sk, h, d, float(scale),
                        int(exp2), torch.cuda.current_stream(q.device).cuda_stream),
                     wrapper.__name__)
    _count(wrapper, exp2)
    return out, lse


def flash_attention_fwd(q, k, v, key_bias, scale, variant: FlashVariant = FlashVariant()):
    """Flash attention forward with an optional [B, Sk] key bias, through the
    forward kernel that `variant` picks (the one-chain kernel here, else
    `flash_attention_fwd_nomax` or `flash_attention_fwd_ilv`).

    Returns (out [B, Sq, H, D] in q's dtype, lse [B*H, Sq, 1] float32)."""
    if variant.nomax:
        return flash_attention_fwd_nomax(q, k, v, key_bias, scale, variant.exp2)
    if variant.ilv:
        return flash_attention_fwd_ilv(q, k, v, key_bias, scale, variant.exp2)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, key_bias, scale, exp2=variant.exp2)
    return _launch_flash_fwd(flash_attention_fwd, "flash kernel", "flash_attention",
                             q, k, v, key_bias, scale, variant.exp2)


flash_attention_fwd.launches = 0
flash_attention_fwd.exp2_launches = 0


# ---------------------------------------------------------------------------
# Kernel 1b: the two-chain flash forward
# ---------------------------------------------------------------------------

def attention_reference_ilv(q, k, v, key_bias, scale, exp2=False, block_k=ILV_BLOCK_K):
    """Plain version of the two-chain kernel: one online-softmax chain over
    the even key blocks (of `block_k` keys), one over the odd ones, merged on
    their joint max. Any number of blocks: with one block the second chain is
    empty (m = -inf, l = 0, acc = 0) and merges with weight 0.
    Returns (out, lse) as `attention_reference`."""
    s, _ = _flash_scores(q, k, key_bias, scale, exp2=exp2)
    odd = (torch.arange(s.shape[-1], device=s.device) // block_k) % 2 == 1
    m_a, l_a, acc_a = _softmax_chain(s[..., ~odd], v[:, ~odd], exp2)
    if bool(odd.any()):
        m_b, l_b, acc_b = _softmax_chain(s[..., odd], v[:, odd], exp2)
    else:
        m_b, l_b, acc_b = (torch.full_like(m_a, -math.inf), torch.zeros_like(l_a),
                           torch.zeros_like(acc_a))
    expf = torch.exp2 if exp2 else torch.exp
    m = torch.maximum(m_a, m_b)
    w_a, w_b = expf(m_a - m), expf(m_b - m)
    return _finish(q, m, l_a * w_a + l_b * w_b, acc_a * w_a + acc_b * w_b, exp2)


def flash_attention_fwd_ilv(q, k, v, key_bias, scale, exp2=False):
    """The two-chain flash forward (same contract as `flash_attention_fwd`):
    right for every Sk, odd tile counts included."""
    if q.device.type == "cpu":
        return attention_reference_ilv(q, k, v, key_bias, scale, exp2)
    return _launch_flash_fwd(flash_attention_fwd_ilv, "two-chain flash kernel",
                             "flash_attention_ilv", q, k, v, key_bias, scale, exp2)


flash_attention_fwd_ilv.launches = 0
flash_attention_fwd_ilv.exp2_launches = 0


# ---------------------------------------------------------------------------
# Kernel 1c: the no-max flash forward
# ---------------------------------------------------------------------------

def nomax_key_max(k):
    """max_k |k_k| of each (batch, head), [B*H] float32: the factor of the
    no-max kernel's row caps, which the kernel completes with the row norms
    of its own q-hat. The plain version of the kernel call's pre-pass over K."""
    return torch.linalg.vector_norm(k, dim=-1, dtype=torch.float32).amax(dim=1).reshape(-1)


def nomax_cap(q_hat, k):
    """The row cap of the no-max kernel, [B, H, Sq, 1] float32: by
    Cauchy-Schwarz every score q-hat_i . k_k is at most |q-hat_i| max_k |k_k|;
    +1 absorbs the roundings (it shrinks every p alike, which the normalized
    output does not see). The kernel forms the same from q-hat as it stages
    it and `nomax_key_max`."""
    b, _, h, _ = k.shape
    qn = torch.linalg.vector_norm(q_hat.float(), dim=-1).permute(0, 2, 1)[..., None]
    return qn * nomax_key_max(k).reshape(b, h, 1, 1) + 1.0


def attention_reference_nomax(q, k, v, key_bias, scale, exp2=False):
    """Plain version of the no-max kernel: p = exp(q-hat.k^T + bias - cap)
    with no row max, l = sum p clamped at 1e-30 (a row that underflows
    everywhere gives zeros, not 0/0), lse = cap + log l.
    Returns (out, lse) as `attention_reference`."""
    s, q_hat = _flash_scores(q, k, key_bias, scale, exp2=exp2, round_q=True)
    cap = nomax_cap(q_hat, k)
    p = torch.exp2(s - cap) if exp2 else torch.exp(s - cap)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    return _finish(q, cap, l, acc, exp2)


def nomax_kernel_call(q, k, v, bias, kmax, out, lse, scale, exp2):
    """The no-max kernel's C call on bf16 CUDA operands as
    `flash_attention_fwd_nomax` validates them: a pre-pass over K writes
    max_k |k_k| into kmax ([B*H] float32), then the attention kernel fills out
    and lse. Not counted: the wrapper counts its calls."""
    b, sq, h, d = q.shape
    fn = cuda_build.function("flash_attention_nomax", "flash_attention_fwd_nomax",
                             [_P] * 7 + [_I] * 5 + [_F, _I, _P])
    cuda_build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        bias.data_ptr() if bias is not None else None, kmax.data_ptr(),
                        out.data_ptr(), lse.data_ptr(), b, sq, k.shape[1], h, d,
                        float(scale * (LOG2E if exp2 else 1.0)), int(exp2),
                        torch.cuda.current_stream(q.device).cuda_stream),
                     "flash_attention_fwd_nomax")


def flash_attention_fwd_nomax(q, k, v, key_bias, scale, exp2=False):
    """The no-max flash forward (same contract as `flash_attention_fwd`).
    The kernel's call forms q-hat, the row norms and max_k |k_k| itself."""
    if q.device.type == "cpu":
        return attention_reference_nomax(q, k, v, key_bias, scale, exp2)
    q, k, v, bias, (b, sq, sk, h, d) = _flash_operands("no-max flash kernel", q, k, v, key_bias)
    kmax = torch.empty(b * h, device=q.device, dtype=torch.float32)
    out = torch.empty_like(q)
    lse = torch.empty((b * h, sq, 1), device=q.device, dtype=torch.float32)
    nomax_kernel_call(q, k, v, bias, kmax, out, lse, scale, exp2)
    _count(flash_attention_fwd_nomax, exp2)
    return out, lse


flash_attention_fwd_nomax.launches = 0
flash_attention_fwd_nomax.exp2_launches = 0


def flash_attention_fwd_reference(q, k, v, key_bias, scale, variant: FlashVariant = FlashVariant()):
    """The plain version of the forward kernel that `variant` picks, on
    whatever device the tensors lie (what `flash_attention_fwd` runs for CPU
    tensors)."""
    ref = {"base": attention_reference, "ilv": attention_reference_ilv,
           "nomax": attention_reference_nomax}[variant.forward]
    return ref(q, k, v, key_bias, scale, exp2=variant.exp2)


# ---------------------------------------------------------------------------
# Kernel 2: flash attention backward, and the autograd Function over both
# ---------------------------------------------------------------------------

def flash_attention_bwd_reference(q, k, v, key_bias, out, lse, dout, scale, exp2=False):
    """Plain version of the backward kernel: the same formulas in fp32 from
    the same saved tensors (p recomputed from lse). With `exp2`, the exp2
    form's fold: scores from the rounded q-hat in the log2 domain, bias and
    lse times log2(e), p = exp2(s - lse), and dk = dS^T.q-hat / log2(e)
    (q-hat carries scale*log2(e)).
    Returns (dq, dk, dv), each in q's dtype."""
    b, sq, h, _ = q.shape
    kf, vf, of, gf = (x.float() for x in (k, v, out, dout))
    s, q_hat = _flash_scores(q, k, key_bias, scale, exp2=exp2)
    lse = lse.reshape(b, h, sq, 1)
    p = torch.exp2(s - lse * LOG2E) if exp2 else torch.exp(s - lse)
    delta = (gf * of).sum(-1).permute(0, 2, 1)[..., None]          # [B, H, Sq, 1]
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q_hat.float()) * (1.0 / LOG2E if exp2 else scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_delta(out, dout):
    """delta = rowsum(dout * out) in fp32, [B*H, Sq] float32 (heads folded
    into the batch, as lse): the plain version of the backward kernel call's
    pre-pass, which the call computes itself on the card."""
    b, sq, h, _ = out.shape
    return (dout.float() * out.float()).sum(-1).permute(0, 2, 1).reshape(b * h, sq)


def flash_bwd_kernel_call(q, k, v, bias, out, lse, dout, ld, dq_acc, dq, dk, dv, scale, exp2):
    """The backward kernel's C call on bf16 CUDA operands as
    `flash_attention_bwd` validates them: a pre-pass writes (lse*log2(e),
    delta) into ld ([B*H, Sq, 2] float32) and zeroes dq_acc ([B, Sq, H, D]
    float32), the kernel adds dQ into dq_acc and writes dk and dv, and an
    epilogue writes dq. Not counted: the wrapper counts its calls."""
    b, sq, h, d = q.shape
    fn = cuda_build.function("flash_attention_bwd", "flash_attention_bwd",
                             [_P] * 12 + [_I] * 5 + [_F, _I, _P])
    cuda_build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        bias.data_ptr() if bias is not None else None,
                        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), ld.data_ptr(),
                        dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                        b, sq, k.shape[1], h, d, float(scale), int(exp2),
                        torch.cuda.current_stream(q.device).cuda_stream),
                     "flash_attention_bwd")


def flash_attention_bwd(q, k, v, key_bias, out, lse, dout, scale,
                        variant: FlashVariant = FlashVariant()):
    """Flash attention backward: q/k/v/out/dout [B, S, H, D], lse [B*H, Sq, 1]
    float32 (natural log) from any flash forward. Returns (dq, dk, dv); the
    key bias gets no gradient. On the card the kernel's call forms delta =
    rowsum(dout * out) itself (`flash_bwd_delta` is its plain version). Of
    `variant` only `exp2` matters here (the kernel's exp2 form): there is one
    backward for every forward kernel."""
    exp2 = variant.exp2
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, key_bias, out, lse, dout, scale, exp2)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if (k.shape != (b, sk, h, d) or v.shape != k.shape or out.shape != q.shape
            or dout.shape != q.shape or lse.shape != (b * h, sq, 1)):
        raise ValueError(f"flash backward kernel: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} out{tuple(out.shape)} dout{tuple(dout.shape)} "
                         f"lse{tuple(lse.shape)}")
    if d % 8 or d > 128:
        raise ValueError(f"flash backward kernel: head dim {d} must be a multiple of 8, <= 128")
    q, k, v, out, dout = cuda_build.kernel_operands("flash backward kernel", q, k, v, out, dout)
    bias = None
    if key_bias is not None:
        bias = key_bias.to(device=q.device, dtype=torch.float32).contiguous()
        if bias.shape != (b, sk):
            raise ValueError(f"flash backward kernel: key_bias {tuple(bias.shape)} != {(b, sk)}")
    lse = lse.to(torch.float32).contiguous()
    ld = torch.empty((b * h, sq, 2), device=q.device, dtype=torch.float32)
    dq_acc = torch.empty((b, sq, h, d), device=q.device, dtype=torch.float32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    flash_bwd_kernel_call(q, k, v, bias, out, lse, dout, ld, dq_acc, dq, dk, dv, scale, exp2)
    _count(flash_attention_bwd, exp2)
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.exp2_launches = 0


class _FlashAttention(torch.autograd.Function):
    """Forward runs `flash_attention_fwd` (the kernel `variant` picks) and
    saves out and the natural-log lse; backward runs `flash_attention_bwd`,
    in its exp2 form under `variant.exp2` (the JAX package's custom_vjp
    pair)."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, scale, variant):
        out, lse = flash_attention_fwd(q, k, v, key_bias, scale, variant)
        ctx.save_for_backward(q, k, v, key_bias, out, lse)
        ctx.scale = scale
        ctx.variant = variant
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_bias, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, key_bias, out, lse,
                                         dout.contiguous(), ctx.scale, ctx.variant)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, key_bias, scale, variant: FlashVariant = FlashVariant()):
    """Flash attention with an optional [B, Sk] key bias, differentiable in
    q, k and v, in the form `variant` picks. Returns [B, Sq, H, D]."""
    return _FlashAttention.apply(q, k, v, key_bias, scale, variant)


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


# ---------------------------------------------------------------------------
# Kernel 5: int8-QK flash attention (forward only; wired into no model)
# ---------------------------------------------------------------------------

def int8_qk_operands(q, k, v):
    """The int8 kernel's operands from q/k/v [B, S, H, D], made in PyTorch as
    the JAX package leaves them to XLA: K mean-centred over the keys per
    (batch, head) (softmax cannot see a per-query constant), Q and K
    quantized per token (`quantize_acts`, the JAX package's `_quant_rows`),
    heads folded into the batch, K transposed.
    Returns (q_q [BH,Sq,D] int8, q_s [BH,Sq,1] f32, k_qT [BH,D,Sk] int8,
    k_s [BH,1,Sk] f32, v [BH,Sk,D])."""
    fold = lambda x: x.permute(0, 2, 1, 3).reshape(x.shape[0] * x.shape[2], x.shape[1], x.shape[3])
    k = k - k.mean(dim=1, keepdim=True)
    q_q, q_s = quantize_acts(fold(q))
    k_q, k_s = quantize_acts(fold(k))
    return (q_q.contiguous(), q_s.contiguous(), k_q.transpose(1, 2).contiguous(),
            k_s.transpose(1, 2).contiguous(), fold(v).contiguous())


def flash_attention_int8_reference(q, k, v, key_bias=None, scale=None):
    """Plain version of the int8-QK kernel from the same operands
    (`int8_qk_operands`): the exact integer q_q.k_q^T times (q_s*scale), then
    times k_s, plus the bias; fp32 softmax with p rounded to v's dtype for
    p.v and the sum divided out after. Returns [B, Sq, H, D] in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    b, sq, h, d = q.shape
    q_q, q_s, k_qt, k_s, vf = int8_qk_operands(q, k, v)
    # the integer sums stay below 127^2 * 128 < 2^24, so the fp32 product is exact
    s = (q_q.float() @ k_qt.float()) * (q_s * scale) * k_s                # [BH, Sq, Sk]
    if key_bias is not None:
        s = (s.reshape(b, h, sq, -1) + key_bias.float()[:, None, None, :]).reshape(b * h, sq, -1)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    out = (p.to(vf.dtype).float() @ vf.float()) / p.sum(dim=-1, keepdim=True)
    return out.reshape(b, h, sq, d).permute(0, 2, 1, 3).to(q.dtype)


def flash_attention_int8(q, k, v, key_bias=None, scale=None):
    """Forward-only flash attention with int8 q.k^T: q/k/v [B, S, H, D],
    optional [B, Sk] key bias; returns [B, Sq, H, D]. No lse, no gradient."""
    if q.device.type == "cpu":
        return flash_attention_int8_reference(q, k, v, key_bias, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("int8 flash kernel: forward only (as the JAX package's): "
                           "rounding has no gradient")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if k.shape != (b, sk, h, d) or v.shape != (b, sk, h, d):
        raise ValueError(f"int8 flash kernel: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} (needs Dv == D)")
    if d % 8 or d > 128:
        raise ValueError(f"int8 flash kernel: head dim {d} must be a multiple of 8, <= 128")
    q, k, v = cuda_build.kernel_operands("int8 flash kernel", q, k, v)
    q_q, q_s, k_qt, k_s, vf = int8_qk_operands(q, k, v)
    bias = None
    if key_bias is not None:
        bias = key_bias.to(device=q.device, dtype=torch.float32).contiguous()
        if bias.shape != (b, sk):
            raise ValueError(f"int8 flash kernel: key_bias {tuple(bias.shape)} != {(b, sk)}")
    out = torch.empty((b * h, sq, d), device=q.device, dtype=q.dtype)
    fn = cuda_build.function("flash_attention_int8", "flash_attention_int8_fwd",
                             [_P] * 7 + [_I] * 5 + [_F, _P])
    cuda_build.check(fn(q_q.data_ptr(), q_s.data_ptr(), k_qt.data_ptr(), k_s.data_ptr(),
                        vf.data_ptr(), bias.data_ptr() if bias is not None else None,
                        out.data_ptr(), b, sq, sk, h, d, float(scale),
                        torch.cuda.current_stream(q.device).cuda_stream),
                     "flash_attention_int8_fwd")
    flash_attention_int8.launches += 1
    return out.reshape(b, h, sq, d).permute(0, 2, 1, 3)


flash_attention_int8.launches = 0


# ---------------------------------------------------------------------------
# Kernel 6: fused self-attention (forward only; wired into no model)
# ---------------------------------------------------------------------------

def packed_kv(x, wk, wv):
    """x . [Wk | Wv]^T rounded to x's dtype: K in columns [0, C), V in
    [C, 2C) of [B, N, 2C]. One plain product outside the kernel, as in the
    JAX package."""
    return x @ torch.cat([wk, wv], dim=0).t()


def fused_self_attention_reference(x, wq, wk, wv, wo, bo, scale, num_heads, key_bias=None):
    """Plain version of the fused self-attention kernel, rounding where it
    does: q and K|V to x's dtype, per head p = exp(s - max) rounded to x's
    dtype for p.v with the sum divided out after (the TPU kernel divides p
    first: the same function up to rounding), the head concat to x's dtype."""
    b, n, c = x.shape
    hd = c // num_heads
    q = (x.float() @ wq.float().t()).to(x.dtype).reshape(b, n, num_heads, hd)
    kv = packed_kv(x, wk, wv)
    k, v = (t.reshape(b, n, num_heads, hd) for t in (kv[..., :c], kv[..., c:]))
    s = torch.einsum("bnhd,bshd->bhns", q.float(), k.float()) * scale
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bhns,bshd->bhnd", p.to(x.dtype).float(), v.float()) / p.sum(-1, keepdim=True)
    o = o.permute(0, 2, 1, 3).reshape(b, n, c).to(x.dtype)
    return (o.float() @ wo.float().t() + bo.float()).to(x.dtype)


def fused_self_attention(x, wq, wk, wv, wo, bo, scale, num_heads, key_bias=None):
    """x [B, N, C] (pre-normed); wq, wk, wv, wo [C, C] ([out, in]); bo [C];
    optional [B, N] key bias. Returns [B, N, C]: self-attention over all N
    tokens after the out-projection (add the residual outside). Forward only."""
    if x.device.type == "cpu":
        return fused_self_attention_reference(x, wq, wk, wv, wo, bo, scale, num_heads, key_bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, wq, wk, wv, wo, bo)):
        raise RuntimeError("fused self-attention kernel: forward only (as the JAX package's)")
    b, n, c = x.shape
    if c % num_heads or any(w.shape != (c, c) for w in (wq, wk, wv, wo)) or bo.shape != (c,):
        raise ValueError(f"fused self-attention kernel: shapes x{tuple(x.shape)} "
                         f"wq{tuple(wq.shape)} wk{tuple(wk.shape)} wv{tuple(wv.shape)} "
                         f"wo{tuple(wo.shape)} with {num_heads} heads")
    hd = c // num_heads
    if c % 16 or hd % 8 or c > 1280:
        raise ValueError(f"fused self-attention kernel: C={c} must be a multiple of 16, <= 1280, "
                         f"with a head dim ({hd}) a multiple of 8")
    x, wq, wk, wv, wo = cuda_build.kernel_operands("fused self-attention kernel",
                                                   x, wq, wk, wv, wo)
    kv = packed_kv(x, wk, wv).contiguous()
    bo32 = bo.to(device=x.device, dtype=torch.float32).contiguous()
    bias = None
    if key_bias is not None:
        bias = key_bias.to(device=x.device, dtype=torch.float32).contiguous()
        if bias.shape != (b, n):
            raise ValueError(f"fused self-attention kernel: key_bias {tuple(bias.shape)} "
                             f"!= {(b, n)}")
    out = torch.empty_like(x)
    fn = cuda_build.function("fused_self_attention", "fused_self_attention_fwd",
                             [_P] * 7 + [_I] * 4 + [_F, _P])
    cuda_build.check(fn(x.data_ptr(), wq.data_ptr(), kv.data_ptr(), wo.data_ptr(),
                        bo32.data_ptr(), bias.data_ptr() if bias is not None else None,
                        out.data_ptr(), b, n, c, num_heads, float(scale),
                        torch.cuda.current_stream(x.device).cuda_stream),
                     "fused_self_attention_fwd")
    fused_self_attention.launches += 1
    return out


fused_self_attention.launches = 0
