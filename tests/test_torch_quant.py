"""The port's int8 (w8a8) serving ops vs the JAX package, in float32 on the
CPU: weight and activation quantization, the plain versions of the w8a8
fused cross-attention (B5) and fused GEGLU (B6) kernels against the Pallas
kernels in interpret mode, and the int8 fusion rule."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from adaprompt_tpu.ops import attention as jattn, geglu as jgeglu, quant as jquant
from adaprompt_tpu_torch.ops import attention as tattn, geglu as tgeglu, quant as tquant
from torch_port_helpers import t

# One flipped int8 level of g or o moves an output by at most 1/127 of its
# row's max (through a product that sums it once); the bound leaves room for
# a few. The two sides can flip a level where their float32 paths differ by
# an ulp: the TPU kernels divide by 127 inside a jit, which XLA computes to
# within 1 ulp of the true quotient (test_scales_inside_jit_within_one_ulp),
# and B6's GELU is exact erf here, the A&S approximation there.
KERNEL_REL_TOL = 1e-2


def _with_half_levels(rng, rows, cols):
    """Random rows, each with one entry of exactly +-127 (so the scale is
    127/127 + 1e-8 = 1.0 in float32) and others on exact .5 levels."""
    a = rng.standard_normal((rows, cols)).astype(np.float32) * 30
    a[:, 0] = np.where(rng.random(rows) < 0.5, 127.0, -127.0)
    half = rng.integers(-126, 126, (rows, cols // 2)) + 0.5
    a[:, 1:1 + cols // 2] = half.astype(np.float32)
    return a


def test_quantize_weight_matches_jax():
    """Equal int8 values and equal scales, .5 levels rounding half to even;
    port weights are [out, in], JAX weights [in, out]."""
    rng = np.random.default_rng(0)
    w = np.concatenate([_with_half_levels(rng, 16, 64),
                        rng.standard_normal((48, 64)).astype(np.float32) * 0.05])
    wq_t, s_t = tquant.quantize_weight(t(w))
    wq_j, s_j = jquant.quantize_weight(jnp.asarray(w.T))
    assert wq_t.dtype == torch.int8 and wq_t.shape == (64, 64) and s_t.shape == (64,)
    np.testing.assert_array_equal(wq_t.numpy(), np.asarray(wq_j).T)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert (s_t[:16] == 1.0).all()
    np.testing.assert_array_equal(wq_t[:16, 1:33].numpy(), np.round(w[:16, 1:33]))   # half to even


@pytest.mark.parametrize("shape", [(5, 40), (2, 7, 64)])
def test_quantize_acts_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    x = rng.standard_normal(shape).astype(np.float32) * 3
    flat = x.reshape(-1, shape[-1])
    flat[: flat.shape[0] // 2] = _with_half_levels(rng, flat.shape[0] // 2, shape[-1])
    x = flat.reshape(shape)
    xq_t, s_t = tquant.quantize_acts(t(x))
    xq_j, s_j = jquant.quantize_acts(jnp.asarray(x))
    assert xq_t.dtype == torch.int8 and s_t.shape == shape[:-1] + (1,)
    np.testing.assert_array_equal(xq_t.numpy(), np.asarray(xq_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def test_scales_inside_jit_within_one_ulp():
    """Under jit, XLA does not compute max / 127 as a true division (the
    kernels' scales are computed inside one): the port's true-division
    scales agree with it to 1 ulp."""
    w = np.random.default_rng(1).standard_normal((320, 640)).astype(np.float32)
    _, s_j = jax.jit(jquant.quantize_weight)(jnp.asarray(w))
    _, s_t = tquant.quantize_weight(t(w.T))
    np.testing.assert_array_max_ulp(s_t.numpy(), np.asarray(s_j), maxulp=1)


def test_int8_matmul_is_exact_past_float32_integers():
    """Sums beyond 2^24 stay exact before the final cast (as an int32 sum)."""
    a = torch.full((2, 2560), 127, dtype=torch.int8)
    w = torch.full((3, 2560), 127, dtype=torch.int8)
    w[1, 0] = 126
    out = tquant.int8_matmul(a, w)
    exact = np.array([127 * 127 * 2560, 127 * 127 * 2559 + 127 * 126, 127 * 127 * 2560])
    np.testing.assert_array_equal(out[0].numpy(), exact.astype(np.float32))


def _rel_err(port, ref):
    ref = np.asarray(ref, np.float64)
    return np.abs(port.numpy().astype(np.float64) - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("m,c", [(64, 64), (40, 32), (200, 64)])
def test_geglu_int8_matches_pallas(m, c):
    """B6's plain version against `_geglu_i8_kernel` in interpret mode, on
    row counts `fused_int8_eligible` admits (multiples of 8, ragged for the
    Pallas block of 512). Measured: rel error <= 3.4e-7 (no level flipped)."""
    rng = np.random.default_rng(m + c)
    f = 4 * c
    x = rng.standard_normal((m, c)).astype(np.float32)
    w1 = (rng.uniform(-1, 1, (c, 2 * f)) / np.sqrt(c)).astype(np.float32)   # JAX [in, out]
    b1 = rng.uniform(-0.1, 0.1, 2 * f).astype(np.float32)
    w2 = (rng.uniform(-1, 1, (f, c)) / np.sqrt(f)).astype(np.float32)
    b2 = rng.uniform(-0.1, 0.1, c).astype(np.float32)
    assert jgeglu.fused_int8_eligible(jnp.asarray(x), jnp.asarray(w1))
    ref = jgeglu.geglu_int8(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)), interpret=True)
    out = tgeglu.geglu_int8(t(x), *tquant.quantize_weight(t(w1.T)), t(b1),
                            *tquant.quantize_weight(t(w2.T)), t(b2))
    assert out.shape == (m, c)
    assert _rel_err(out, ref) <= KERNEL_REL_TOL


@pytest.mark.parametrize("b,n,c,s,heads", [(1, 64, 32, 16, 4), (2, 48, 64, 77, 2),
                                           (2, 96, 64, 77, 8), (2, 40, 96, 77, 8)])
def test_fused_cross_attention_int8_matches_pallas(b, n, c, s, heads):
    """B5's plain version against `_fused_cross_i8_kernel` in interpret
    mode: int8 q- and out-projections, fp32 head concat quantized per row;
    also at C=96 with 8 heads (hd=12, a head dim the kernels take without
    16-byte K/V loads). Measured: rel error <= 9.4e-7 (no level flipped)."""
    rng = np.random.default_rng(n + c + s)
    hd = c // heads
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    wq, wo = ((rng.standard_normal((c, c)) * 0.2).astype(np.float32) for _ in range(2))
    bo = (rng.standard_normal(c) * 0.1).astype(np.float32)
    k, v = (rng.standard_normal((b, s, heads, hd)).astype(np.float32) for _ in range(2))
    scale = hd ** -0.5
    ref = jattn.fused_cross_attention_int8(*(jnp.asarray(a) for a in (x, wq, k, v, wo, bo)),
                                           scale, heads, interpret=True)
    out = tattn.fused_cross_attention_int8(t(x), *tquant.quantize_weight(t(wq.T)), t(k), t(v),
                                           *tquant.quantize_weight(t(wo.T)), t(bo), scale, heads)
    assert out.shape == (b, n, c)
    assert _rel_err(out, ref) <= KERNEL_REL_TOL


@pytest.mark.parametrize("c", [32, 320, 640, 1280])
@pytest.mark.parametrize("m", [8, 12, 2 * 2048, 4 * 1024 + 4])
def test_fused_int8_eligible_matches_jax(c, m):
    xj, w1j = jnp.zeros((m, c)), jnp.zeros((c, 8 * c))
    xt, w1t = torch.zeros((m, c)), torch.zeros((8 * c, c))
    assert tgeglu.fused_int8_eligible(xt, w1t) == jgeglu.fused_int8_eligible(xj, w1j)
    assert tgeglu.fused_int8_eligible(xt, w1t) == (c != 1280 and m % 8 == 0)
