"""The port's serving stack vs the JAX package (float32, CPU): the
segmented DeepCache / CFG-tail loop, DDIM and DPM-Solver++(2M) under it,
the tiny UNet's DeepCache passes, ToMe and int8 path, and the whole slice,
`_generate_fast` with dpmpp, FastConfig and quant="int8".

On the CPU the JAX package's quant="int8" UNet is its float UNet (its int8
kernels need `pallas_ok()`); the `jax_int8_kernels` fixture patches the JAX
modules' attributes so that it reaches the Pallas kernels in interpret
mode, as tests/test_quant.py runs them. Nothing in the JAX package changes.
"""

import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from adaprompt_tpu import pipeline as jpipe
from adaprompt_tpu.models import unet as junet
from adaprompt_tpu.ops import attention as jattn, geglu as jgeglu
from adaprompt_tpu.sampling import ddim as jddim, dpm as jdpm, fastloop as jfast
from adaprompt_tpu_torch import pipeline as tpipe
from adaprompt_tpu_torch.models import unet as tunet_mod
from adaprompt_tpu_torch.ops import attention as tattn, geglu as tgeglu, tome as ttome
from adaprompt_tpu_torch.sampling import ddim as tddim, dpm as tdpm, fastloop as tfast
from torch_port_helpers import (JAX_UNET, TORCH_UNET, assert_close, merge_gaps, port_module, t,
                                tiny_models)
from torch_port_helpers import torch_threads  # noqa: F401

LOOPS = [(20, 3, 0.3), (12, 4, 0.35), (8, 1, 0.0), (7, 2, 0.0), (10, 3, 0.5)]
# tiny UNet at a 16x32 latent: its 512-token level merges (r = 256)
HW = (16, 32)
TOME = dict(tome_min_tokens=512)


# -- toy eps-models shared by both frameworks ------------------------------------

def _toy(lib):
    """(model_full, model_shallow, plain model_fn) on a batch whose cond rows
    (the first b) and uncond rows (the rest) differ, in numpy-equal
    arithmetic for jax.numpy and torch."""
    tanh = jnp.tanh if lib is jnp else torch.tanh

    def w_for(x):
        n = x.shape[0]
        w = np.where(np.arange(n) < (n // 2 if n > 2 else n), 0.5, -0.8).astype(np.float32)
        return (jnp.asarray(w) if lib is jnp else torch.from_numpy(w))[:, None, None, None]

    def tcol(tt):
        tt = tt.astype(jnp.float32) if lib is jnp else tt.float()
        return (tt / 1000.0)[:, None, None, None]

    def full(x, tt):
        cache = tanh(w_for(x) * x)
        return cache + tcol(tt), cache

    def shallow(x, tt, cache):
        return 0.5 * cache + 0.5 * tanh(0.3 * x) + tcol(tt)

    return full, shallow, lambda x, tt: full(x, tt)[0]


def _x_T(b=2, seed=0):
    return np.random.default_rng(seed).standard_normal((b, 4, 4, 4)).astype(np.float32)


@pytest.mark.parametrize("steps,interval,tail", LOOPS)
@pytest.mark.parametrize("sampler", ["ddim", "dpmpp"])
def test_fast_samplers_match_jax(sampler, steps, interval, tail):
    """ddim_sample_fast / dpmpp_sample_fast (through fast_cached_loop) on a
    toy model, dividing and non-dividing segments, with and without a CFG
    tail."""
    x_T = _x_T()
    jf, js, _ = _toy(jnp)
    tf_, ts_, _ = _toy(torch)
    jfn = jdpm.dpmpp_sample_fast if sampler == "dpmpp" else jddim.ddim_sample_fast
    tfn = tdpm.dpmpp_sample_fast if sampler == "dpmpp" else tddim.ddim_sample_fast
    kw = dict(num_steps=steps, guidance_scale=(4.0, 1.0), cache_interval=interval,
              cfg_tail_frac=tail)
    z_j = jfn(jf, js, jnp.asarray(x_T), **kw)
    z_t = tfn(tf_, ts_, torch.from_numpy(x_T), **kw)
    assert_close(z_t, z_j, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("steps,interval,tail", LOOPS)
def test_fast_cached_loop_schedule(steps, interval, tail):
    """The port's loop calls the model as the JAX loop's semantics say: each
    segment opens with a full pass, then full where j % interval == 0; the
    first n_cfg steps on the doubled batch. Its result equals JAX's
    fast_cached_loop with the same update."""
    x_T = _x_T()
    calls = []
    tf_, ts_, _ = _toy(torch)
    full = lambda x, tt: (calls.append(("full", x.shape[0])), tf_(x, tt))[1]
    shallow = lambda x, tt, c: (calls.append(("shallow", x.shape[0])), ts_(x, tt, c))[1]
    g, n_cfg = tfast.cfg_tail(np.linspace(4, 1, steps).astype(np.float32), tail)
    arrs = (np.arange(steps)[::-1] * 50 + 1, g)
    upd_t = lambda carry, e, ps: (carry[0] - 0.1 * e,)
    (z_t,) = tfast.fast_cached_loop(full, shallow, (torch.from_numpy(x_T),), arrs, upd_t,
                                    cache_interval=interval, n_cfg=n_cfg)
    want = [("full" if j % interval == 0 else "shallow", 4) for j in range(n_cfg)]
    want += [("full" if j % interval == 0 else "shallow", 2) for j in range(steps - n_cfg)]
    assert calls == want
    jf, js, _ = _toy(jnp)
    (z_j,) = jfast.fast_cached_loop(jf, js, (jnp.asarray(x_T),), tuple(jnp.asarray(a) for a in arrs),
                                    lambda carry, e, ps: (carry[0] - 0.1 * e,),
                                    cache_interval=interval, n_cfg=n_cfg)
    assert_close(z_t, z_j, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("steps", [20, 8])
@pytest.mark.parametrize("use_cfg", [True, False])
def test_dpmpp_matches_jax(steps, use_cfg):
    """Second order, with lower_order_final at 8 steps, on both batches."""
    x_T = _x_T()
    z_j = jdpm.dpmpp_sample(_toy(jnp)[2], jnp.asarray(x_T), num_steps=steps, use_cfg=use_cfg)
    z_t = tdpm.dpmpp_sample(_toy(torch)[2], torch.from_numpy(x_T), num_steps=steps,
                            use_cfg=use_cfg)
    assert_close(z_t, z_j, atol=2e-5, rtol=2e-5)


def test_dpmpp_first_order_is_ddim_and_timesteps():
    """solver_order=1 equals DDIM step for step; an explicit timestep grid
    matches JAX's; dpmpp_sample_fast without caching or tail equals
    dpmpp_sample."""
    x_T = torch.from_numpy(_x_T())
    toy = _toy(torch)
    z1 = tdpm.dpmpp_sample(toy[2], x_T, num_steps=10, solver_order=1)
    assert_close(z1, tddim.ddim_sample(toy[2], x_T, num_steps=10), atol=1e-5, rtol=1e-5)
    grid = np.asarray([1, 41, 121, 301, 501, 761, 981])
    z_t = tdpm.dpmpp_sample(toy[2], x_T, timesteps=grid)
    z_j = jdpm.dpmpp_sample(_toy(jnp)[2], jnp.asarray(x_T.numpy()), timesteps=grid)
    assert_close(z_t, z_j, atol=2e-5, rtol=2e-5)
    z_fast = tdpm.dpmpp_sample_fast(toy[0], toy[1], x_T, num_steps=12)
    assert_close(z_fast, tdpm.dpmpp_sample(toy[2], x_T, num_steps=12), atol=1e-6)
    with pytest.raises(ValueError):
        tdpm.dpmpp_sample(toy[2], x_T, solver_order=3)


# -- the tiny UNet ---------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    return tiny_models(5)


@pytest.fixture
def jax_int8_kernels(monkeypatch):
    """Route the JAX UNet's quant="int8" dispatch to its Pallas kernels in
    interpret mode (and its flash path to XLA attention) on the CPU."""
    monkeypatch.setattr(jattn, "pallas_ok", lambda: True)
    monkeypatch.setattr(jattn, "flash_attention",
                        lambda q, k, v, kb, scale: jattn._attention_xla(q, k, v, None, kb, scale))
    monkeypatch.setattr(jattn, "fused_cross_attention_int8",
                        functools.partial(jattn.fused_cross_attention_int8, interpret=True))
    monkeypatch.setattr(jgeglu, "geglu_int8", functools.partial(jgeglu.geglu_int8, interpret=True))
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture
def tome_margins(monkeypatch):
    """Record the margin of every ToMe merge the port builds (merge_gaps)."""
    gaps = []
    build = ttome.build_merge

    def recording(x, h, w, ratio, *a, **kw):
        if h * w >= 512:
            gaps.append(merge_gaps(x, h, w, ratio))
        return build(x, h, w, ratio, *a, **kw)

    monkeypatch.setattr(ttome, "build_merge", recording)
    return gaps


def _unet_inputs(seed, b=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b,) + HW + (4,)).astype(np.float32)
    ts = np.asarray([981, 401, 21, 601][:b], np.int32)
    ctx = (rng.standard_normal((1, b, 77, 64)) * 0.5).astype(np.float32)
    return x, ts, ctx


def _both(models, x, ts, ctx, jcfg, tcfg, **kw):
    """eps (or (eps, cache)) of both UNets with hoisted cross-attention K/V."""
    (ju, _, _), (tu, _, _) = models
    out_j = junet.forward(ju, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
                          cross_kv=junet.precompute_cross_kv(ju, jnp.asarray(ctx), cfg=jcfg),
                          cfg=jcfg, **{k: v if not isinstance(v, np.ndarray) else jnp.asarray(v)
                                       for k, v in kw.items()})
    with torch.no_grad():
        out_t = tu(t(x), torch.from_numpy(ts), t(ctx), cross_kv=tu.precompute_cross_kv(t(ctx)),
                   cfg=tcfg, **{k: v if not isinstance(v, np.ndarray) else t(v)
                                for k, v in kw.items()})
    return out_j, out_t


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("depth", [1, 3])
def test_unet_deep_cache_matches_jax(models, depth):
    """A full pass returns the hidden state entering output block n_out-depth;
    a shallow pass from it runs input blocks [0:depth] and output blocks
    [n_out-depth:] only."""
    x, ts, ctx = _unet_inputs(depth)
    (eps_j, cache_j), (eps_t, cache_t) = _both(models, x, ts, ctx, JAX_UNET, TORCH_UNET,
                                               cache_depth=depth)
    assert_close(cache_t, cache_j, atol=2e-4, rtol=1e-4)
    assert_close(eps_t, eps_j, atol=2e-4, rtol=1e-4)
    x2 = x + 0.1 * np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
    (eps_j, same_j), (eps_t, same_t) = _both(models, x2, ts, ctx, JAX_UNET, TORCH_UNET,
                                             cache_depth=depth, cache=np.asarray(cache_j))
    assert same_t.shape == cache_t.shape
    assert float(np.abs(np.asarray(eps_j)).max()) > 1e-2
    assert_close(eps_t, eps_j, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("mlp", [False, True])
def test_unet_tome_matches_jax(models, tome_margins, mlp):
    """ToMe at the 512-token level (self-attention, and the feed-forward
    with tome_mlp); the merges have margin (asserted), so both packages make
    the same ones."""
    x, ts, ctx = _unet_inputs(43)
    jcfg = dataclasses.replace(JAX_UNET, tome_ratio=0.5, tome_mlp=mlp, **TOME)
    tcfg = dataclasses.replace(TORCH_UNET, tome_ratio=0.5, tome_mlp=mlp, **TOME)
    eps_j, eps_t = _both(models, x, ts, ctx, jcfg, tcfg)
    assert len(tome_margins) == 5 and min(min(g) for g in tome_margins) > 1e-5
    exact_j, _ = _both(models, x, ts, ctx, JAX_UNET, TORCH_UNET)
    assert _rel_l2(eps_j, exact_j) > 1e-3          # ToMe really changed the result
    assert_close(eps_t, eps_j, atol=2e-4, rtol=1e-4)


def test_unet_int8_matches_jax(models, jax_int8_kernels, monkeypatch):
    """quant="int8": B5 at the 5 transformer blocks of the 512-token level
    (hoisted K/V, >= 512 queries), B6 at all 16 (every width is eligible
    here), the other projections in float.

    Each int8 kernel call of the port's UNet agrees with the JAX kernel on
    the same inputs within the kernels' bound. The outputs of the two UNets
    agree to a relative L2 of 1e-2 only: quantization turns the fp32
    rounding differences between the packages into whole int8 levels that
    flip here and there, and each flip moves the next layers. The port's
    own int8 UNet moves by 3.2e-3 when its input moves by 1e-6 (the float
    UNet by 2.1e-6); port vs JAX measured 2.6e-3."""
    calls = {"cross": [], "ff": []}
    for key, name in (("cross", "fused_cross_attention_int8"), ("ff", "geglu_int8")):
        kernel = getattr(tunet_mod, name)
        monkeypatch.setattr(tunet_mod, name,
                            lambda *a, _k=kernel, _c=calls[key]: (_c.append(a), _k(*a))[1])
    x, ts, ctx = _unet_inputs(13)
    jcfg = dataclasses.replace(JAX_UNET, quant="int8")
    tcfg = dataclasses.replace(TORCH_UNET, quant="int8")
    eps_j, eps_t = _both(models, x, ts, ctx, jcfg, tcfg)
    assert len(calls["cross"]) == 5 and len(calls["ff"]) == 16
    tu = models[1][0]
    layers = {}
    for li in tu.l2ca:
        bp = tu._block(li)
        layers[id(bp["attn2"]["to_out"].bias)] = bp["attn2"]
        layers[id(bp["ff"]["out"].bias)] = bp["ff"]
    jnp_ = lambda a: jnp.asarray(a.numpy())
    for args in calls["cross"]:
        xi, bo = args[0], args[7]
        p = layers[id(bo)]
        ref = np.asarray(jattn.fused_cross_attention_int8(
            jnp_(xi), jnp_(p["to_q"].weight.T), jnp_(args[3]), jnp_(args[4]),
            jnp_(p["to_out"].weight.T), jnp_(bo), args[8], args[9]))
        out = tattn.fused_cross_attention_int8(*args).numpy()
        assert np.abs(out - ref).max() <= 1e-2 * np.abs(ref).max()
    for args in calls["ff"]:
        xi, b1, b2 = args[0], args[3], args[6]
        p = layers[id(b2)]
        ref = np.asarray(jgeglu.geglu_int8(jnp_(xi), jnp_(p["proj"].weight.T), jnp_(b1),
                                           jnp_(p["out"].weight.T), jnp_(b2)))
        out = tgeglu.geglu_int8(*args).numpy()
        assert np.abs(out - ref).max() <= 1e-2 * np.abs(ref).max()
    with torch.no_grad():           # the float UNet, on the port (JAX's is patched here)
        exact_t = tu(t(x), torch.from_numpy(ts), t(ctx), cross_kv=tu.precompute_cross_kv(t(ctx)))
    assert _rel_l2(eps_t, exact_t) > 1e-3          # the int8 kernels really ran
    assert _rel_l2(eps_t, eps_j) <= 1e-2


# -- the whole slice ---------------------------------------------------------------

def _contexts(seed, b):
    rng = np.random.default_rng(seed)
    cond = (rng.standard_normal((1, b, 77, 64)) * 0.5).astype(np.float32)
    uncond = (rng.standard_normal((1, b, 77, 64)) * 0.5).astype(np.float32)
    return cond, uncond


def _damp(tree, factor, path=()):
    """A JAX UNet tree with the int8-routed output projections (ff.out and
    attn2.to_out, kernel and bias) scaled by `factor`."""
    if isinstance(tree, dict):
        return {k: _damp(v, factor, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_damp(v, factor, path + (i,)) for i, v in enumerate(tree))
    if path[-3:-1] in (("ff", "out"), ("attn2", "to_out")):
        return tree * np.float32(factor)
    return tree


def test_generate_fast_int8_dpmpp_matches_jax(models, jax_int8_kernels, tome_margins,
                                              monkeypatch):
    """The slice: dpmpp with FastConfig() (ToMe 0.5 with the feed-forward,
    DeepCache 3/3, CFG tail 0.3) under quant="int8", 8 steps (6 with CFG:
    full, 2 shallow, full, 2 shallow; 2 cond-only: full, shallow), against
    JAX's _generate_fast_jit; relative L2 <= 1e-2 (measured 3.8e-5). Every
    ToMe merge has margin (asserted).

    Int8 rounding makes the sampler chaotic at these widths: with the tiny
    UNet as it is, a 1e-6 relative change of the context moves the port's
    own int8 latents by 8-9e-3 (its float latents by 9e-7), as far as the
    bound. So the int8-routed output projections are scaled by 0.1 in both
    packages, which brings that to <= 4e-4 while every int8 kernel still
    runs (the per-call kernel parity is test_unet_int8_matches_jax's)."""
    (ju, jv, _), (_, tv, _) = models
    jd = _damp(ju, 0.1)
    td = port_module(tunet_mod.UNet(TORCH_UNET), jd)
    launches = {"cross": 0, "ff": 0}
    for key, name in (("cross", "fused_cross_attention_int8"), ("ff", "geglu_int8")):
        kernel = getattr(tunet_mod, name)

        def counted(*a, _k=kernel, _key=key):
            launches[_key] += 1
            return _k(*a)

        monkeypatch.setattr(tunet_mod, name, counted)
    cond, uncond = _contexts(4, 1)
    x_T = np.random.default_rng(5).standard_normal((1,) + HW + (4,)).astype(np.float32)
    jcfg = dataclasses.replace(JAX_UNET, quant="int8", **TOME)
    tcfg = dataclasses.replace(TORCH_UNET, quant="int8", **TOME)
    z_j = jpipe._generate_fast_jit(jd, jv, jnp.asarray(cond), jnp.asarray(uncond),
                                   jnp.asarray(x_T), 8, (4.0, 1.0), True, jpipe.FastConfig(), jcfg,
                                   None, jpipe.SD15_SCHEDULE, jnp.float32, "dpmpp")
    args = (t(cond), t(uncond), t(x_T), 8, (4.0, 1.0), True, tpipe.FastConfig())
    z_t = tpipe._generate_fast(td, tv, *args, tcfg, tpipe.SD15_SCHEDULE, torch.float32, "dpmpp")
    # 8 UNet passes (3 full, 5 shallow); 5 transformer blocks at the 512-token
    # level in each, all of them in a shallow pass of depth 3
    assert len(tome_margins) == 40 and min(min(g) for g in tome_margins) > 1e-5
    assert launches == {"cross": 40, "ff": 3 * 16 + 5 * 5}
    assert z_t.shape == x_T.shape and np.isfinite(z_t.numpy()).all()
    assert _rel_l2(z_t, z_j) <= 1e-2
    z_float = tpipe._generate_fast(td, tv, *args, TORCH_UNET, tpipe.SD15_SCHEDULE,
                                   torch.float32, "dpmpp")
    assert _rel_l2(z_t, z_float) > 1e-4             # the int8 path changed the result
