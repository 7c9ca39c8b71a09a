"""Port GEGLU vs the JAX package: the plain version of the fused kernel
against the Pallas kernel in interpret mode (A&S erf, |err| < 1.5e-7) and
against geglu_reference (exact erf), in float32; autograd through the
port's geglu against jax.grad of the JAX op; and the fusion rule."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from adaprompt_tpu.ops import geglu as jgeglu
from adaprompt_tpu_torch.ops import geglu as tgeglu
from torch_port_helpers import assert_close, t


def _weights(rng, c, f):
    w1 = (rng.uniform(-1, 1, (c, 2 * f)) / np.sqrt(c)).astype(np.float32)   # JAX [in, out]
    b1 = rng.uniform(-0.1, 0.1, (2 * f,)).astype(np.float32)
    w2 = (rng.uniform(-1, 1, (f, c)) / np.sqrt(f)).astype(np.float32)
    b2 = rng.uniform(-0.1, 0.1, (c,)).astype(np.float32)
    return w1, b1, w2, b2


@pytest.mark.parametrize("m,c", [(64, 32), (128, 64), (40, 48), (200, 320)])
def test_geglu_matches_pallas_and_reference(m, c):
    """(200, 320): a main-path width (F = 1280) with a row count that is not a
    multiple of the CUDA kernel's 128-row tile."""
    rng = np.random.default_rng(m + c)
    f = 4 * c
    x = rng.standard_normal((m, c)).astype(np.float32)
    w1, b1, w2, b2 = _weights(rng, c, f)
    jargs = [jnp.asarray(a) for a in (x, w1, b1, w2, b2)]
    out_kernel = jgeglu.geglu(*jargs, True)
    out_ref = jgeglu.geglu_reference(*jargs)
    out_t = tgeglu.geglu(t(x), t(w1.T), t(b1), t(w2.T), t(b2))
    assert_close(out_t, out_kernel, atol=1e-5)   # A&S erf vs exact erf, fp32 sums
    assert_close(out_t, out_ref, atol=1e-5)


def test_geglu_keeps_leading_dims():
    rng = np.random.default_rng(1)
    c, f = 32, 128
    x = rng.standard_normal((2, 16, c)).astype(np.float32)
    w1, b1, w2, b2 = _weights(rng, c, f)
    out_j = jgeglu.geglu(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)), True)
    out_t = tgeglu.geglu(t(x), t(w1.T), t(b1), t(w2.T), t(b2))
    assert out_t.shape == (2, 16, c)
    assert_close(out_t, out_j, atol=1e-5)


@pytest.mark.parametrize("m,c", [(64, 32), (40, 48)])
def test_geglu_autograd_matches_jax_grad(m, c):
    """Every input's gradient: the port recomputes through geglu_reference
    under autograd, the JAX package through its XLA reference (custom_vjp)."""
    rng = np.random.default_rng(m * c)
    f = 4 * c
    x = rng.standard_normal((2, m // 2, c)).astype(np.float32)
    w1, b1, w2, b2 = _weights(rng, c, f)
    w = rng.standard_normal((2, m // 2, c)).astype(np.float32)
    loss = lambda *a: jnp.sum(jgeglu.geglu(*a, True) * w)
    grads_j = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (x, w1, b1, w2, b2)))
    args = [t(a).requires_grad_(True) for a in (x, w1.T, b1, w2.T, b2)]
    (tgeglu.geglu(*args) * t(w)).sum().backward()
    want = [grads_j[0], grads_j[1].T, grads_j[2], grads_j[3].T, grads_j[4]]
    for a, ref in zip(args, want):
        assert_close(a.grad, ref, atol=1e-4)     # fp32 sums over M and F, erf variants


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("c", [320, 640, 1280])
def test_fused_eligible_matches_jax(c, dtype):
    """Same rule as the JAX package at the three SD-1.5 widths, so the launch
    counts match: bf16 fuses C=320 and C=640, fp32 only C=320."""
    m = 2 * 4096 // (c // 320) ** 2
    xj = jnp.zeros((m, c), getattr(jnp, dtype))
    w1j = jnp.zeros((c, 8 * c), getattr(jnp, dtype))
    xt = torch.zeros((m, c), dtype=getattr(torch, dtype))
    w1t = torch.zeros((8 * c, c), dtype=getattr(torch, dtype))
    assert tgeglu.fused_eligible(xt, w1t) == jgeglu.fused_eligible(xj, w1j)
    assert tgeglu.fused_eligible(xt, w1t) == (c == 320 or (c == 640 and dtype == "bfloat16"))
