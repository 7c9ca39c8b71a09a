"""Port attention ops vs the JAX package: the plain versions of the flash
forward, flash backward and fused cross-attention kernels against the
Pallas kernels in interpret mode, autograd through the port's
flash_attention against jax.grad, and dot_product_attention with a causal
mask. float32; tolerances below."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from adaprompt_tpu.ops import attention as jattn
from adaprompt_tpu_torch.ops import attention as tattn
from torch_port_helpers import assert_close, t
from torch_port_helpers import torch_threads  # noqa: F401

FLASH_ATOL = 2e-5    # fp32 online softmax (Pallas) vs a one-pass softmax


def _qkv(rng, b, s, h, d):
    return [rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("d,s", [(40, 256), (80, 128)])
@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_forward_matches_pallas(d, s, with_bias):
    rng = np.random.default_rng(d + s + with_bias)
    b, h = 2, 2
    q, k, v = _qkv(rng, b, s, h, d)
    bias = None
    if with_bias:
        keep = rng.random((b, s)) < 0.7
        bias = ((keep.astype(np.float32) - 1.0) * -jattn.NEG_BIG).astype(np.float32)
    scale = d ** -0.5
    out_j, lse_j = jattn._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         None if bias is None else jnp.asarray(bias),
                                         scale, interpret=True)
    out_t, lse_t = tattn.flash_attention_fwd(t(q), t(k), t(v),
                                             None if bias is None else t(bias), scale)
    assert out_t.shape == (b, s, h, d) and lse_t.shape == (b * h, s, 1)
    assert_close(out_t, out_j, atol=FLASH_ATOL)
    assert_close(lse_t, lse_j, atol=FLASH_ATOL)


def test_flash_attention_matches_public_jax_op():
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 1, 256, 2, 40)
    out_j = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                                  40 ** -0.5, True)
    assert_close(tattn.flash_attention_fwd(t(q), t(k), t(v), None, 40 ** -0.5)[0], out_j,
                 atol=FLASH_ATOL)


@pytest.mark.parametrize("exp2", [False, True])
def test_fully_masked_rows_match_jax(exp2):
    """Key bias that masks every key of one batch row (an image masked out
    whole) and the first 64-key tile of the other: the plain version of the
    flash forward weighs the masked keys of the first equally (the mean of
    v), as the Pallas kernel (interpret mode) and JAX's softmax do, and
    agrees with both on the other row; the lse of the masked row is JAX's."""
    rng = np.random.default_rng(11)
    b, s, h, d = 2, 256, 2, 16
    q, k, v = _qkv(rng, b, s, h, d)
    bias = _bias(rng, b, s)
    bias[0, :64] = jattn.NEG_BIG
    bias[1] = jattn.NEG_BIG
    scale = d ** -0.5
    out_j, lse_j = jattn._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(bias), scale, interpret=True)
    xla_j = jattn._attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                                 jnp.asarray(bias), scale)
    out_t, lse_t = tattn.attention_reference(t(q), t(k), t(v), t(bias), scale, exp2=exp2)
    assert_close(out_t, out_j, atol=FLASH_ATOL)
    assert_close(out_t, xla_j, atol=FLASH_ATOL)
    assert_close(lse_t, lse_j, atol=FLASH_ATOL)
    np.testing.assert_allclose(out_t[1].numpy(), np.broadcast_to(v[1].mean(0), (s, h, d)),
                               atol=1e-5)


def _bias(rng, b, s):
    keep = rng.random((b, s)) < 0.7
    return ((keep.astype(np.float32) - 1.0) * -jattn.NEG_BIG).astype(np.float32)


@pytest.mark.parametrize("d,s", [(40, 256), (80, 128)])
@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_backward_matches_pallas(d, s, with_bias):
    """flash_attention_bwd's plain version against _flash_bwd_impl in
    interpret mode, from the same saved out and lse."""
    rng = np.random.default_rng(d + s + 2 * with_bias)
    b, h = 2, 2
    q, k, v = _qkv(rng, b, s, h, d)
    g = rng.standard_normal((b, s, h, d)).astype(np.float32)
    bias = _bias(rng, b, s) if with_bias else None
    scale = d ** -0.5
    jb = None if bias is None else jnp.asarray(bias)
    out, lse = jattn._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb, scale,
                                     interpret=True)
    grads_j = jattn._flash_bwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb, out, lse,
                                    jnp.asarray(g), scale, interpret=True)
    grads_t = tattn.flash_attention_bwd(t(q), t(k), t(v), None if bias is None else t(bias),
                                        t(out), t(lse), t(g), scale)
    for a, ref in zip(grads_t, grads_j[:3]):
        assert a.shape == (b, s, h, d)
        assert_close(a, ref, atol=FLASH_ATOL)      # fp32; blockwise vs one-pass sums


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_delta_matches_jax(dtype):
    """`flash_bwd_delta`, the plain version of the backward kernel call's
    pre-pass, against the delta of `_flash_bwd_impl` (rowsum of dO*O over the
    folded heads, in fp32) on the same numpy inputs, in f32 and in bf16
    (both cast to fp32 before the product, so bf16 products are exact): they
    differ only in the order of a 40-term fp32 sum, hence atol 1e-5 on
    values of order 10."""
    rng = np.random.default_rng(5)
    b, s, h, d = 2, 77, 3, 40
    out, g = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(2))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                      torch.bfloat16)
    fold = lambda x: jattn._fold_heads(jnp.asarray(x, jdt)).astype(jnp.float32)
    delta_j = jnp.sum(fold(g) * fold(out), axis=-1)
    delta_t = tattn.flash_bwd_delta(t(out).to(tdt), t(g).to(tdt))
    assert delta_t.dtype == torch.float32 and delta_t.shape == (b * h, s)
    assert_close(delta_t, delta_j, atol=1e-5)


@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_attention_autograd_matches_jax_grad(with_bias):
    """The port's autograd Function (forward + backward wrappers) against
    jax.grad through the JAX package's custom_vjp (Pallas, interpret mode)."""
    rng = np.random.default_rng(11 + with_bias)
    b, s, h, d = 1, 256, 2, 40
    q, k, v = _qkv(rng, b, s, h, d)
    w = rng.standard_normal((b, s, h, d)).astype(np.float32)
    bias = _bias(rng, b, s) if with_bias else None
    jb = None if bias is None else jnp.asarray(bias)
    loss = lambda q_, k_, v_: jnp.sum(jattn.flash_attention(q_, k_, v_, jb, d ** -0.5, True) * w)
    grads_j = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (t(a).requires_grad_(True) for a in (q, k, v))
    out = tattn.flash_attention(qt, kt, vt, None if bias is None else t(bias), d ** -0.5)
    (out * t(w)).sum().backward()
    for a, ref in zip((qt.grad, kt.grad, vt.grad), grads_j):
        assert_close(a, ref, atol=FLASH_ATOL)


@pytest.mark.parametrize("c,heads,n", [(64, 4, 128), (80, 2, 64)])
def test_fused_cross_matches_pallas(c, heads, n):
    rng = np.random.default_rng(c + n)
    b, s = 2, 77
    hd = c // heads
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    wq = (rng.uniform(-1, 1, (c, c)) / np.sqrt(c)).astype(np.float32)     # JAX [in, out]
    wo = (rng.uniform(-1, 1, (c, c)) / np.sqrt(c)).astype(np.float32)
    bo = rng.uniform(-0.1, 0.1, (c,)).astype(np.float32)
    k = rng.standard_normal((b, s, heads, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, heads, hd)).astype(np.float32)
    scale = hd ** -0.5
    out_j = jattn.fused_cross_attention(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(k),
                                        jnp.asarray(v), jnp.asarray(wo), jnp.asarray(bo),
                                        scale, heads, interpret=True)
    out_t = tattn.fused_cross_attention(t(x), t(wq.T), t(k), t(v), t(wo.T), t(bo),
                                        scale, heads)
    assert_close(out_t, out_j, atol=2e-5)   # fp32; different summation order


@pytest.mark.parametrize("c,heads,n", [(80, 2, 128), (160, 2, 64), (80, 2, 100)])
def test_fused_cross_bf16_matches_pallas(c, heads, n):
    """The plain version the kernel is held to on the card, in bf16 against
    the Pallas kernel (interpret mode) in bf16: both round q, the normalized
    probabilities and the concatenated o to bf16, so they agree to within one
    bf16 step of the output's magnitude (2**-8 max|ref|); head dims 40 and
    80, N = 100 ragged."""
    rng = np.random.default_rng(c + n + 1)
    b, s = 2, 77
    hd = c // heads
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    x = bf(rng.standard_normal((b, n, c)))
    wq = bf(rng.uniform(-1, 1, (c, c)) / np.sqrt(c))     # JAX [in, out]
    wo = bf(rng.uniform(-1, 1, (c, c)) / np.sqrt(c))
    bo = rng.uniform(-0.1, 0.1, (c,)).astype(np.float32)
    k = bf(rng.standard_normal((b, s, heads, hd)))
    v = bf(rng.standard_normal((b, s, heads, hd)))
    scale = hd ** -0.5
    j16 = lambda a: jnp.asarray(a, jnp.bfloat16)
    out_j = jattn.fused_cross_attention(j16(x), j16(wq), j16(k), j16(v), j16(wo),
                                        jnp.asarray(bo), scale, heads, interpret=True)
    t16 = lambda a: t(a).to(torch.bfloat16)
    out_t = tattn.fused_cross_attention(t16(x), t16(wq.T), t16(k), t16(v), t16(wo.T), t(bo),
                                        scale, heads)
    assert out_t.dtype == torch.bfloat16
    ref = np.asarray(out_j.astype(jnp.float32))
    diff = np.abs(out_t.float().numpy() - ref).max()
    assert diff <= 2.0 ** -8 * np.abs(ref).max(), diff


@pytest.mark.parametrize("with_key_bias", [False, True])
def test_dot_product_attention_causal_matches_jax(with_key_bias):
    rng = np.random.default_rng(3)
    b, s, h, d = 2, 77, 4, 16
    q, k, v = _qkv(rng, b, s, h, d)
    kb = rng.uniform(-1, 0, (b, s)).astype(np.float32) if with_key_bias else None
    out_j = jattn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        mask=jattn.causal_mask(s),
                                        key_bias=None if kb is None else jnp.asarray(kb))
    out_t = tattn.dot_product_attention(t(q), t(k), t(v), mask=tattn.causal_mask(s),
                                        key_bias=None if kb is None else t(kb))
    assert_close(out_t, out_j, atol=1e-5)
    np.testing.assert_array_equal(tattn.causal_mask(5).numpy(), np.asarray(jattn.causal_mask(5)))


@pytest.mark.parametrize("sq,sk,masked,flash", [(512, 256, False, True),
                                                 (511, 256, False, False),
                                                 (512, 255, False, False),
                                                 (512, 512, True, False)])
def test_dispatch_rule_matches_jax(monkeypatch, sq, sk, masked, flash):
    """The flash wrapper is taken exactly where the JAX rule takes its
    kernel (Sq >= 512, Sk >= 256, no full mask), and both agree."""
    rng = np.random.default_rng(sq + sk)
    q = rng.standard_normal((1, sq, 1, 8)).astype(np.float32)
    k, v = (rng.standard_normal((1, sk, 1, 8)).astype(np.float32) for _ in range(2))
    kb = np.where(rng.random((1, sk)) < 0.5, 0.0, tattn.NEG_BIG).astype(np.float32)
    mask = np.zeros((1, 1, sq, sk), np.float32) if masked else None
    calls = []
    real = tattn.flash_attention
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a: calls.append(1) or real(*a))
    out_j = jattn._attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 None if mask is None else jnp.asarray(mask),
                                 jnp.asarray(kb), 8 ** -0.5)
    out_t = tattn.dot_product_attention(t(q), t(k), t(v), key_bias=t(kb),
                                        mask=None if mask is None else t(mask))
    assert bool(calls) == flash
    assert_close(out_t, out_j, atol=1e-5)
