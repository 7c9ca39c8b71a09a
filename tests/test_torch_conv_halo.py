"""The port's 3x3 conv wrappers (ops/conv_halo.py) against the JAX package.

The JAX package's own tests skip its three Pallas conv kernels on the CPU
(interpret mode diverges on their manual DMA) and hold them to a plain
reference: `ops.layers.group_norm(..., "silu")` + `lax.conv_general_dilated`
with float32 accumulation + bias. The port's plain versions, which its
wrappers run on CPU tensors, are held to that same reference here: in
float32 to 1e-4 of the reference's largest value (summation order), in
bfloat16 to 2e-2 of it (the JAX GroupNorm normalizes in bf16, the port's
fused form in float32, so the two round at different places). The CUDA
kernels themselves are compared with the plain versions on the card, in
tests/test_torch_port_rules.py (marker `cuda`)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaprompt_tpu.ops import conv_halo as jch
from adaprompt_tpu.ops.layers import group_norm as jgroup_norm
from adaprompt_tpu_torch.ops import conv_halo as tch

SHAPES = [(8, 32, 32), (12, 64, 48), (8, 64, 32), (12, 32, 48)]     # (H = W, C, O), B = 2
TOL = {"float32": 1e-4, "bfloat16": 2e-2}                          # of max|reference|


def _inputs(seed, hw, c, o, gn_shift=0.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, hw, hw, c)) * 1.5 + 0.5).astype(np.float32)
    w = (rng.standard_normal((3, 3, c, o)) / math.sqrt(9 * c)).astype(np.float32)   # HWIO
    b = (rng.standard_normal(o) * 0.1).astype(np.float32)
    gs = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    gb = (0.1 * rng.standard_normal(c) + gn_shift).astype(np.float32)
    return x, w, b, gs, gb


def _jax_conv(h, w, b):
    y = jax.lax.conv_general_dilated(h, w, (1, 1), ((1, 1), (1, 1)),
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                     preferred_element_type=jnp.float32)
    return np.asarray((y.astype(h.dtype) + b).astype(jnp.float32))


def _torch_args(dtype, x, w, b):
    dt = getattr(torch, dtype)
    return (torch.from_numpy(x).to(dt), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).to(dt),
            torch.from_numpy(b))


def _assert_within(got, ref, tol):
    err = np.abs(got.float().numpy() - ref).max()
    assert np.isfinite(err) and err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw,c,o", SHAPES)
@pytest.mark.parametrize("fn", ["conv3x3_halo", "conv3x3_im2col"])
def test_plain_convs_match_jax_reference(fn, hw, c, o, dtype):
    x, w, b, _, _ = _inputs(hw + c + o, hw, c, o)
    jdt = getattr(jnp, dtype)
    ref = _jax_conv(jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(b, jdt))
    before = getattr(tch, fn).launches
    got = getattr(tch, fn)(*_torch_args(dtype, x, w, b))
    assert got.shape == (2, hw, hw, o) and got.dtype == getattr(torch, dtype)
    assert getattr(tch, fn).launches == before            # the plain version, no launch
    _assert_within(got, ref, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gn_shift", [0.0, 3.0])
@pytest.mark.parametrize("hw,c,o", SHAPES)
def test_plain_gn_silu_conv_matches_jax_reference(hw, c, o, gn_shift, dtype):
    """gn_shift=3 puts silu(bias) ~ 3 where a border padded BEFORE the
    activation would sit, so the SAME padding must pad the activated tensor."""
    x, w, b, gs, gb = _inputs(hw + c + o + 1, hw, c, o, gn_shift)
    jdt = getattr(jnp, dtype)
    h = jgroup_norm(jnp.asarray(x, jdt), jnp.asarray(gs, jdt), jnp.asarray(gb, jdt),
                    num_groups=32, eps=1e-5, activation="silu")
    ref = _jax_conv(h, jnp.asarray(w, jdt), jnp.asarray(b, jdt))
    tx, tw, tb = _torch_args(dtype, x, w, b)
    got = tch.gn_silu_conv3x3_halo(tx, torch.from_numpy(gs), torch.from_numpy(gb), tw, tb)
    assert got.shape == (2, hw, hw, o) and got.dtype == tx.dtype
    _assert_within(got, ref, TOL[dtype])


def test_padding_before_the_activation_would_fail_the_bound():
    """The case above is sharp: GroupNorm-SiLU of a zero-padded x (the
    border then holds silu(b) instead of 0) misses the bound many times over."""
    hw, c, o = 8, 32, 32
    x, w, b, gs, gb = _inputs(7, hw, c, o, gn_shift=3.0)
    tx, tw, tb = _torch_args("float32", x, w, b)
    good = tch.gn_silu_conv3x3_halo_reference(tx, torch.from_numpy(gs), torch.from_numpy(gb),
                                              tw, tb)
    ab = tch.gn_affine(tx, torch.from_numpy(gs), torch.from_numpy(gb))
    xp = torch.nn.functional.pad(tx, (0, 0, 1, 1, 1, 1))
    seg = xp * ab[:, 0, None, None, :] + ab[:, 1, None, None, :]
    act = (seg * torch.sigmoid(seg)).permute(0, 3, 1, 2)
    wrong = torch.nn.functional.conv2d(act, tw, tb).permute(0, 2, 3, 1)
    assert wrong.shape == good.shape
    border_err = (wrong - good).abs().max().item()
    assert border_err > 10 * TOL["bfloat16"] * good.abs().max().item()
    inner = (wrong - good)[:, 1:-1, 1:-1].abs().max().item()
    assert inner <= 1e-4 * good.abs().max().item()         # only the border differs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rep", [10, 20, 30])
def test_gn_affine_and_packing_match_jax(rep, dtype):
    """The per-(batch, channel) affine and the taps-outermost weight are the
    JAX function's own intermediates (conv_halo.py: gn_ab, kernel.reshape(9,
    c, o)), at 10, 20 and 30 channels a group (SD-1.5's C = 320, 640, 960).
    The shift is taken in JAX's order, gb - (mean*inv)*gs, so the two differ
    by the statistics' summation order only: 3e-6 absolute, no relative slack."""
    hw, c, o = 8, 32 * rep, 48
    x, w, b, gs, gb = _inputs(3 + rep, hw, c, o, gn_shift=0.5)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xg = xj.reshape(2, hw, hw, 32, rep)
    mean = jnp.mean(xg, axis=(1, 2, 4), dtype=jnp.float32)
    var = jnp.mean(jnp.square(xg.astype(jnp.float32) - mean[:, None, None, :, None]),
                   axis=(1, 2, 4))
    inv = jax.lax.rsqrt(var + 1e-5)
    a_c = jnp.repeat(inv, rep, axis=1) * gs[None]
    b_c = gb[None] - jnp.repeat(mean * inv, rep, axis=1) * gs[None]
    tx = torch.from_numpy(np.asarray(xj.astype(jnp.float32)).copy()).to(getattr(torch, dtype))
    got = tch.gn_affine(tx, torch.from_numpy(gs), torch.from_numpy(gb))
    assert got.shape == (2, 2, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.stack([a_c, b_c], axis=1), atol=3e-6, rtol=0)
    packed = tch.pack_conv_weight(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
    np.testing.assert_array_equal(packed.numpy(), w.reshape(9, c, o))
    assert packed.is_contiguous()


# every ResBlock conv shape of the SD-1.5 UNet at 64x64 latents (H, C, O)
SD15_RESBLOCK_SHAPES = [(64, 320, 320), (32, 320, 640), (32, 640, 640), (16, 640, 1280),
                        (16, 1280, 1280), (8, 1280, 1280), (8, 2560, 1280), (16, 2560, 1280),
                        (16, 1920, 1280), (32, 1920, 640), (32, 1280, 640), (32, 960, 640),
                        (64, 960, 320), (64, 640, 320)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fused_conv_eligible_matches_jax(monkeypatch, dtype):
    """The same convs take the fused kernel in both packages. The JAX rule
    also asks for a TPU backend; here it is told it has one."""
    monkeypatch.setattr(jch.jax, "default_backend", lambda: "tpu")
    assert set(tch._FUSED_TABLE) == set(jch._FUSED_TABLE)
    picked = []
    for h, c, o in SD15_RESBLOCK_SHAPES:
        want = jch.fused_conv_eligible(jax.ShapeDtypeStruct((2, h, h, c), getattr(jnp, dtype)), o)
        got = tch.fused_conv_eligible(torch.empty((2, h, h, c), dtype=getattr(torch, dtype),
                                                  device="meta"), o)
        assert got == want, (h, c, o)
        picked.append(got)
    assert sum(picked) == (3 if dtype == "bfloat16" else 0)
    bf = torch.bfloat16
    assert not tch.fused_conv_eligible(torch.empty((2, 64, 32, 320), dtype=bf, device="meta"), 320)
    assert not tch.fused_conv_eligible(torch.empty((64, 64, 320), dtype=bf, device="meta"), 320)


def test_chip_smoke_times_every_resblock_shape():
    """chip_smoke.py and tools/gn_conv_tiles.py time the fused conv at the
    same 14 ResBlock shapes as this file lists, the fused table's three among
    them at B=4."""
    import chip_smoke
    assert list(chip_smoke.SD15_RESBLOCK_SHAPES) == SD15_RESBLOCK_SHAPES
    assert {s[1:] for s in chip_smoke.GN_CONV_SHAPES} == set(tch._FUSED_TABLE)
    assert {s[0] for s in chip_smoke.GN_CONV_SHAPES} == {4}
