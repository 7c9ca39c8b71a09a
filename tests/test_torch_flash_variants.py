"""The port's flash variants and its last two attention kernels vs the JAX
package (CPU, float32 unless a test says bfloat16, the port's plain
versions against the Pallas kernels in interpret mode): the two-chain
forward (`_ILV`), the no-max forward (`_NOMAX`), the exp2 forms of forward
and backward (`_EXP2`), the int8-QK flash attention, the fused
self-attention (and its library yardstick), `int8_linear` and
`int8_matmul_2operand` (tests/test_torch_flash_slice.py holds the slice as
a whole).

The JAX package picks its flash variant with module globals read at trace
time; a test sets them, clears JAX's compilation caches and restores them in
a `finally` (this file runs in a process of its own under `--dist loadfile`)."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaprompt_tpu.ops import attention as jattn, geglu as jgeglu, quant as jquant
from adaprompt_tpu_torch.ops import attention as tattn, quant as tquant
from adaprompt_tpu_torch.ops.attention import FlashVariant
from torch_port_helpers import assert_close, t
from torch_port_helpers import torch_threads  # noqa: F401

VARIANTS = {"ilv": FlashVariant(ilv=True), "nomax": FlashVariant(nomax=True),
            "exp2": FlashVariant(exp2=True), "ilv+exp2": FlashVariant(ilv=True, exp2=True),
            "nomax+exp2": FlashVariant(nomax=True, exp2=True)}


@contextlib.contextmanager
def jax_flash(variant: FlashVariant = FlashVariant(), min_tokens=None):
    """The JAX package's flash switches set as `variant`; with `min_tokens`,
    its models also reach the Pallas flash and GEGLU kernels on the CPU, in
    interpret mode, from that many query and key tokens on. Self-attention
    only, as at full width, where the 77-key cross-attention stays below the
    flash rule: at 77 keys the JAX two-chain guard ends with 77 blocks of
    one key and drops the last."""
    saved = {n: getattr(jattn, n) for n in ("_EXP2", "_ILV", "_NOMAX", "_FLASH_MIN_Q",
                                            "_FLASH_MIN_K", "pallas_ok", "flash_attention")}
    geglu = jgeglu.geglu
    try:
        jattn._EXP2, jattn._NOMAX = variant.exp2, variant.nomax
        jattn._ILV = "1" if variant.ilv else ""
        if min_tokens is not None:
            jattn._FLASH_MIN_Q = jattn._FLASH_MIN_K = min_tokens
            jattn.pallas_ok = lambda: True
            flash = saved["flash_attention"]
            jattn.flash_attention = lambda q, k, v, kb, scale: (
                flash(q, k, v, kb, scale, True) if q.shape[1] == k.shape[1]
                else jattn._attention_xla(q, k, v, None, kb, scale))
            jgeglu.geglu = lambda x, w1, b1, w2, b2: geglu(x, w1, b1, w2, b2, True)
        jax.clear_caches()
        yield
    finally:
        for n, v in saved.items():
            setattr(jattn, n, v)
        jgeglu.geglu = geglu
        jax.clear_caches()


def _qkv(rng, b, s, h, d, sk=None):
    return [rng.standard_normal((b, n, h, d)).astype(np.float32) for n in (s, sk or s, sk or s)]


def _bias(rng, b, s, keep=0.7):
    return ((rng.random((b, s)) < keep).astype(np.float32) - 1.0) * -jattn.NEG_BIG


# -- B12, B13 and the exp2 forms: the plain versions against Pallas -----------------

@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_flash_variant_forward_matches_pallas(name, with_bias):
    """out and lse of each variant's plain version against `_flash_fwd_impl`
    under the same switches (interpret mode), Sk = 512. fp32: out 2e-4 (the
    bound of the JAX package's own no-max test), lse 1e-4; the exp2 form of
    the one-chain kernel 2e-5 (its own test's bound)."""
    variant = VARIANTS[name]
    rng = np.random.default_rng(len(name) + with_bias)
    b, s, h, d = 2, 512, 2, 40
    q, k, v = _qkv(rng, b, s, h, d)
    bias = _bias(rng, b, s) if with_bias else None
    jb = None if bias is None else jnp.asarray(bias)
    with jax_flash(variant):
        out_j, lse_j = jattn._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb,
                                             d ** -0.5, interpret=True)
    out_t, lse_t = tattn.flash_attention_fwd(t(q), t(k), t(v), None if bias is None else t(bias),
                                             d ** -0.5, variant)
    assert out_t.shape == (b, s, h, d) and lse_t.shape == (b * h, s, 1)
    tol = 2e-5 if name == "exp2" else 2e-4
    assert_close(out_t, out_j, atol=tol)
    assert_close(lse_t, lse_j, atol=min(tol, 1e-4))
    # and against exact attention: every variant computes the same function
    ref, lse_ref = tattn.attention_reference(t(q), t(k), t(v), None if bias is None else t(bias),
                                             d ** -0.5)
    assert_close(out_t, ref, atol=2e-4)
    assert_close(lse_t, lse_ref, atol=1e-4)


@pytest.mark.parametrize("sk,block_k", [(576, 64), (40, 64), (65, 64), (512, 512), (300, 100)])
@pytest.mark.parametrize("exp2", [False, True])
def test_two_chain_is_right_at_any_tile_count(sk, block_k, exp2):
    """The port's two-chain version keeps every key at an odd tile count (9
    tiles of 64 at Sk = 576), with one tile only (the second chain empty:
    m = -inf, acc = 0, no NaN) and with a ragged last tile, where the JAX
    guard halves its block once and can drop the last one."""
    rng = np.random.default_rng(sk + block_k)
    q, k, v = _qkv(rng, 2, 96, 2, 16, sk=sk)
    bias = t(_bias(rng, 2, sk))
    out, lse = tattn.attention_reference_ilv(t(q), t(k), t(v), bias, 0.25, exp2, block_k)
    ref, lse_ref = tattn.attention_reference(t(q), t(k), t(v), bias, 0.25)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(lse).all())
    assert_close(out, ref, atol=2e-5)
    assert_close(lse, lse_ref, atol=2e-5)


@pytest.mark.parametrize("exp2", [False, True])
def test_nomax_underflow_gives_finite_zeros(exp2):
    """A row whose scores all sit far below its cap: finite zeros, not NaN,
    as the JAX kernel's guard (tests/test_attention.py)."""
    b, s, h, d = 1, 512, 1, 40
    q = np.full((b, s, h, d), 60.0, np.float32)
    with jax_flash(FlashVariant(nomax=True, exp2=exp2)):
        out_j, lse_j = jattn._flash_fwd_impl(jnp.asarray(q), jnp.asarray(-q), jnp.ones_like(q),
                                             None, d ** -0.5, interpret=True)
    out_t, lse_t = tattn.flash_attention_fwd(t(q), t(-q), torch.ones(b, s, h, d), None, d ** -0.5,
                                             FlashVariant(nomax=True, exp2=exp2))
    assert bool(torch.isfinite(out_t).all()) and bool(torch.isfinite(lse_t).all())
    assert float(out_t.abs().max()) <= 1e-20 and float(np.abs(np.asarray(out_j)).max()) <= 1e-20
    assert_close(lse_t, lse_j, atol=1e-2, rtol=1e-6)       # |lse| ~ 2.3e4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("exp2", [False, True])
def test_nomax_key_max_and_cap_match_jax(exp2, dtype, monkeypatch):
    """The no-max kernel's cap, piece by piece. `nomax_key_max` (the plain
    version of the kernel call's pre-pass over K) against the JAX package's
    kn, max_k |k_k| per (batch, head), taken from the K operand that its
    `_flash_fwd_impl` hands to the Pallas call; |q-hat_i| kmax + 1 formed as
    the kernel forms it (q-hat = q*scale, times log2(e) under exp2, rounded to
    q's dtype; squares summed in fp32) against the cap JAX hands to the
    kernel and against the port's `nomax_cap`, to fp32 rounding (1e-6); in
    float32 the plain version still matches the Pallas kernel (interpret
    mode) at the bounds of `test_flash_variant_forward_matches_pallas`."""
    rng = np.random.default_rng(41 + exp2)
    b, s, h, d = 2, 256, 2, 40
    q, k, v = _qkv(rng, b, s, h, d)
    k[1] *= 3.0                                            # the batches' key norms differ
    bias = _bias(rng, b, s)
    calls = []
    pallas_call = jattn.pl.pallas_call

    def recording(*args, **kwargs):
        call = pallas_call(*args, **kwargs)
        return lambda *operands: calls.append(operands) or call(*operands)

    monkeypatch.setattr(jattn.pl, "pallas_call", recording)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    with jax_flash(FlashVariant(nomax=True, exp2=exp2)):
        out_j, lse_j = jattn._flash_fwd_impl(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                             jnp.asarray(bias), d ** -0.5, interpret=True)
    (_, kf, _, _, cap_j), = calls
    kn_j = jnp.max(jnp.linalg.norm(kf.astype(jnp.float32), axis=-1), axis=-1)   # [b*h]
    qt, kt, vt = (t(a).to(tdt) for a in (q, k, v))
    kmax = tattn.nomax_key_max(kt)
    assert kmax.shape == (b * h,) and kmax.dtype == torch.float32
    np.testing.assert_allclose(kmax.numpy(), np.asarray(kn_j), rtol=1e-6)
    q_hat = (qt.float() * (d ** -0.5 * (tattn.LOG2E if exp2 else 1.0))).to(tdt)
    cap = (q_hat.float() ** 2).sum(-1).sqrt().permute(0, 2, 1) * kmax.reshape(b, h, 1) + 1.0
    np.testing.assert_allclose(cap.reshape(b * h, s, 1).numpy(), np.asarray(cap_j), rtol=1e-6)
    np.testing.assert_allclose(cap[..., None].numpy(), tattn.nomax_cap(q_hat, kt).numpy(),
                               rtol=1e-6)
    if dtype == "float32":
        out_t, lse_t = tattn.attention_reference_nomax(qt, kt, vt, t(bias), d ** -0.5, exp2)
        assert_close(out_t, out_j, atol=2e-4)
        assert_close(lse_t, lse_j, atol=1e-4)


@pytest.mark.parametrize("with_bias", [False, True])
def test_exp2_backward_matches_pallas(with_bias):
    """The backward's plain version under exp2 against `_flash_bwd_impl` with
    `_EXP2` set, from the same saved out and lse."""
    rng = np.random.default_rng(21 + with_bias)
    b, s, h, d = 2, 256, 2, 40
    q, k, v = _qkv(rng, b, s, h, d)
    g = rng.standard_normal((b, s, h, d)).astype(np.float32)
    bias = _bias(rng, b, s) if with_bias else None
    jb = None if bias is None else jnp.asarray(bias)
    with jax_flash(FlashVariant(exp2=True)):
        out, lse = jattn._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb,
                                         d ** -0.5, interpret=True)
        grads_j = jattn._flash_bwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb, out,
                                        lse, jnp.asarray(g), d ** -0.5, interpret=True)
    grads_t = tattn.flash_attention_bwd(t(q), t(k), t(v), None if bias is None else t(bias),
                                        t(out), t(lse), t(g), d ** -0.5, FlashVariant(exp2=True))
    for a, ref in zip(grads_t, grads_j[:3]):
        assert_close(a, ref, atol=2e-5)


@pytest.mark.parametrize("name", ["exp2", "ilv", "nomax+exp2"])
def test_variant_autograd_matches_jax_grad(name):
    """The port's autograd Function under a variant (any forward pairs with
    the backward through the natural-log lse) against jax.grad through the
    JAX custom_vjp under the same switches; 2e-4, the JAX exp2 test's bound."""
    variant = VARIANTS[name]
    rng = np.random.default_rng(31)
    b, s, h, d = 1, 512, 2, 40
    q, k, v = _qkv(rng, b, s, h, d)
    w = rng.standard_normal((b, s, h, d)).astype(np.float32)
    bias = _bias(rng, b, s, 0.8)
    loss = lambda q_, k_, v_: jnp.sum(jattn.flash_attention(
        q_, k_, v_, jnp.asarray(bias), d ** -0.5, True) * w)
    with jax_flash(variant):
        grads_j = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (t(a).requires_grad_(True) for a in (q, k, v))
    out = tattn.flash_attention(qt, kt, vt, t(bias), d ** -0.5, variant)
    (out * t(w)).sum().backward()
    for a, ref in zip((qt.grad, kt.grad, vt.grad), grads_j):
        assert_close(a, ref, atol=2e-4)


def test_variant_rules():
    """nomax wins over ilv; the default is all off; dot_product_attention
    hands the variant to the flash path only."""
    assert FlashVariant() == FlashVariant(False, False, False)
    assert FlashVariant(ilv=True, nomax=True).forward == "nomax"
    assert FlashVariant(ilv=True).forward == "ilv" and FlashVariant(exp2=True).forward == "base"
    rng = np.random.default_rng(0)
    q, k, v = (t(a) for a in _qkv(rng, 1, 512, 1, 8))
    both = FlashVariant(ilv=True, nomax=True)
    a = tattn.dot_product_attention(q, k, v, variant=both)
    assert torch.equal(a, tattn.attention_reference_nomax(q, k, v, None, 8 ** -0.5)[0])
    small = tattn.dot_product_attention(q[:, :100], k, v, variant=both)      # below the flash rule
    assert torch.equal(small, tattn.attention_reference(q[:, :100], k, v, None, 8 ** -0.5)[0])
    with pytest.raises(dataclasses.FrozenInstanceError):
        both.exp2 = True


# -- B10: int8-QK flash attention ------------------------------------------------------

def _int8_inputs(with_bias):
    rng = np.random.default_rng(5)
    b, s, h, d = 1, 256, 2, 40
    q, k, v = _qkv(rng, b, s, h, d)
    k = k + 0.7                                            # a nonzero key mean
    bias = None
    if with_bias:
        bias = np.zeros((b, s), np.float32)
        bias[:, s // 2:] = jattn.NEG_BIG
    return q, k, v, bias, d ** -0.5


def test_int8_qk_operands_match_jax():
    """K centring and the per-token quantization against the JAX package's:
    scales to 1e-6 relative; int8 levels equal wherever JAX's value before
    rounding is not within 1e-3 of a tie (the key means differ in the last
    float32 digits between the two sums), and never more than one level off."""
    q, k, v, _, _ = _int8_inputs(False)
    q_q, q_s, k_qt, k_s, vf = tattn.int8_qk_operands(t(q), t(k), t(v))
    kc = jnp.asarray(k) - jnp.mean(jnp.asarray(k), axis=1, keepdims=True)
    for got_q, got_s, x in ((q_q, q_s, jattn._fold_heads(jnp.asarray(q))),
                            (k_qt.transpose(1, 2), k_s.transpose(1, 2), jattn._fold_heads(kc))):
        ref_q, ref_s = jattn._quant_rows(x)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), rtol=1e-6)
        pre = np.asarray(x) / np.asarray(ref_s)
        near_tie = np.abs(np.abs(pre - np.floor(pre)) - 0.5) < 1e-3
        diff = np.abs(got_q.numpy().astype(np.int32) - np.asarray(ref_q).astype(np.int32))
        assert diff.max() <= 1 and not diff[~near_tie].any()
        assert got_q.dtype == torch.int8
    assert k_qt.shape == (2, 40, 256) and k_s.shape == (2, 1, 256) and vf.shape == (2, 256, 40)
    # the quantization itself, on identical inputs, is exact
    x = np.asarray(jattn._fold_heads(kc))
    ref_q, ref_s = jattn._quant_rows(jnp.asarray(x))
    got_q, got_s = tquant.quantize_acts(t(x))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))


@pytest.mark.parametrize("with_bias", [False, True])
def test_int8_flash_matches_pallas_and_exact_attention(with_bias):
    """B10's plain version against `flash_attention_int8(interpret=True)`,
    2e-4 in fp32, and against exact attention at the JAX test's own bound
    (max error < 0.06, mean < 0.01)."""
    q, k, v, bias, scale = _int8_inputs(with_bias)
    jb = None if bias is None else jnp.asarray(bias)
    out_j = jattn.flash_attention_int8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb, scale,
                                       interpret=True)
    out_t = tattn.flash_attention_int8(t(q), t(k), t(v), None if bias is None else t(bias), scale)
    assert out_t.shape == q.shape
    assert_close(out_t, out_j, atol=2e-4)
    exact = np.asarray(jattn._attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                                            jb, scale))
    err = np.abs(out_t.numpy() - exact)
    assert err.max() < 0.06 and err.mean() < 0.01
    assert_close(tattn.flash_attention_int8(t(q), t(k), t(v)),              # scale defaults
                 tattn.flash_attention_int8(t(q), t(k), t(v), None, scale), atol=0)


# -- B11: fused self-attention ---------------------------------------------------------

@pytest.mark.parametrize("with_bias", [False, True])
def test_fused_self_attention_matches_pallas(with_bias):
    """B11's plain version against `fused_self_attention(interpret=True)`,
    3e-4 (the JAX test's bound against the unfused chain)."""
    rng = np.random.default_rng(7)
    b, n, c, h = 2, 512, 128, 4
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    wq, wk, wv, wo = ((rng.standard_normal((c, c)) * 0.05).astype(np.float32) for _ in range(4))
    bo = (rng.standard_normal(c) * 0.05).astype(np.float32)
    bias = _bias(rng, b, n, 0.8) if with_bias else None
    scale = (c // h) ** -0.5
    out_j = jattn.fused_self_attention(*(jnp.asarray(a) for a in (x, wq, wk, wv, wo, bo)), scale,
                                       h, key_bias=None if bias is None else jnp.asarray(bias),
                                       interpret=True)
    out_t = tattn.fused_self_attention(t(x), t(wq.T), t(wk.T), t(wv.T), t(wo.T), t(bo), scale, h,
                                       None if bias is None else t(bias))     # [out, in] weights
    assert_close(out_t, out_j, atol=3e-4)


@pytest.mark.parametrize("with_bias", [False, True])
def test_fused_self_attention_matches_pallas_bf16(with_bias):
    """B11's plain version against `fused_self_attention(interpret=True)` in
    bf16, the kernels' type, on the same bf16 operands: within 2e-2 of
    max|JAX| (chip_smoke's bound for the kernel against the plain version).
    The two round p at other places (JAX normalizes p before rounding it, the
    port's online form after), so they agree to bf16 roundings only."""
    rng = np.random.default_rng(11)
    b, n, c, h = 2, 256, 128, 4
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    wq, wk, wv, wo = ((rng.standard_normal((c, c)) * 0.05).astype(np.float32) for _ in range(4))
    bo = (rng.standard_normal(c) * 0.05).astype(np.float32)
    bias = _bias(rng, b, n, 0.8) if with_bias else None
    scale = (c // h) ** -0.5
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    out_j = jattn.fused_self_attention(*(jb(a) for a in (x, wq, wk, wv, wo)), jnp.asarray(bo),
                                       scale, h,
                                       key_bias=None if bias is None else jnp.asarray(bias),
                                       interpret=True)
    out_t = tattn.fused_self_attention(tb(x), tb(wq.T.copy()), tb(wk.T.copy()),
                                       tb(wv.T.copy()), tb(wo.T.copy()), t(bo), scale, h,
                                       None if bias is None else t(bias))
    assert out_t.dtype == torch.bfloat16 and out_t.shape == (b, n, c)
    ref = np.asarray(out_j.astype(jnp.float32))
    err = np.abs(out_t.float().numpy() - ref).max()
    assert err <= 2e-2 * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("with_bias", [False, True])
def test_mha_library_call_computes_fused_self_attention(with_bias):
    """B11's library yardstick (`chip_smoke.mha_library`: one
    `F.multi_head_attention_forward` call) computes B11's function: in fp32
    it equals the plain version to 1e-5 of max|plain|, with a NEG_BIG key
    bias as its float key_padding_mask too."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    rng = np.random.default_rng(3)
    b, n, c, h = 2, 100, 64, 4
    x = t(rng.standard_normal((b, n, c)))
    wq, wk, wv, wo = (t(rng.standard_normal((c, c)) / 8) for _ in range(4))
    bo = t(rng.standard_normal(c) / 8)
    bias = t(_bias(rng, b, n, 0.7)) if with_bias else None
    args = (x, wq, wk, wv, wo, bo, (c // h) ** -0.5, h, bias)
    ref = tattn.fused_self_attention_reference(*args)
    with torch.no_grad():
        lib = chip_smoke.mha_library(*args)()
    assert lib.shape == ref.shape
    assert (lib - ref).abs().max() <= 1e-5 * ref.abs().max()
    with pytest.raises(ValueError, match="hd"):
        chip_smoke.mha_library(*args[:6], 0.5, h, bias)


# -- int8_linear, int8_matmul_2operand ---------------------------------------------------

def test_int8_linear_and_2operand_match_jax():
    """Exact integer products, the same scales and roundings: equal to 1e-6
    relative of the output's size."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 8, 256)).astype(np.float32)
    x[0, 3] *= 1000.0                                      # an outlier token
    w = rng.standard_normal((256, 64)).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    for bias in (None, b):
        y_j = jquant.int8_linear(jnp.asarray(x), jnp.asarray(w),
                                 None if bias is None else jnp.asarray(bias))
        y_t = tquant.int8_linear(t(x), t(w.T), None if bias is None else t(bias))
        assert_close(y_t, y_j, atol=1e-6 * float(np.abs(np.asarray(y_j)).max()))
    assert tquant.int8_linear(t(x), t(w.T), out_dtype=torch.float64).dtype == torch.float64
    p = rng.random((2, 3, 16, 128)).astype(np.float32)
    v = rng.standard_normal((2, 3, 128, 40)).astype(np.float32)
    y_j = jquant.int8_matmul_2operand(jnp.asarray(p), jnp.asarray(v))
    y_t = tquant.int8_matmul_2operand(t(p), t(v))
    assert y_t.shape == (2, 3, 16, 40)
    assert_close(y_t, y_j, atol=1e-6 * float(np.abs(np.asarray(y_j)).max()))
    exact = p @ v
    assert np.abs(y_t.numpy() - exact).max() < 0.02 * np.abs(exact).max()
