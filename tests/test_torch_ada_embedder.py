"""The port's legacy Ada embedders (`adaprompt_tpu_torch/adaface/ada_embedder.py`)
against the JAX package's on shared weights and numpy inputs (tiny widths,
CPU, float32): the AttentionalPooler with and without an image mask,
fgbg-competitive or per stream; `ada_forward` at H = 1 and H = 2 with
pre_vecs and a bias, zero-shot and with the cached background, loaded by
both packages' `ada_from_torch` from one reference-layout state dict
(`tools/reference_layouts.ada_embedding_reference`) and by
`convert.from_jax_params` from JAX's own tree; the gradients through
`grad_scale` and into every weight; `reduce_fg_bg_cross_weights`; the
Embedding3d helpers. Tolerances are the JAX package's own test's."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaprompt_tpu.adaface import ada_embedder as jae
from adaprompt_tpu_torch import convert
from adaprompt_tpu_torch.adaface import ada_embedder as tae
from torch_port_helpers import named, torch_threads  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import reference_layouts as rl  # noqa: E402

ATOL, RTOL = 3e-5, 1e-4
B, HW, C, D_CTX = 2, 8, 64, 32
L = HW * HW


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=RTOL,
                               err_msg=what)


def _inputs(seed, d_ctx=D_CTX):
    """Layer features, the CA layer's to_k, the probes, a time embedding and
    a [B, 1, 16, 16] mask, as numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"x": f(B, L, C), "q": f(B, L, C), "to_k": f(C, d_ctx) * 0.2, "fg": f(d_ctx),
            "bg": f(B, d_ctx), "time": f(B, 1280),
            "mask": (rng.random((B, 1, 16, 16)) > 0.3).astype(np.float32)}


def _attn(inp, grad=False):
    """(port layer_attn with leaf tensors, JAX layer_attn)."""
    x, q = (torch.from_numpy(inp[k]).requires_grad_(grad) for k in ("x", "q"))
    t = {"x": x, "q": q, "to_k_w": torch.from_numpy(inp["to_k"]), "infeat_size": (HW, HW)}
    j = {"x": jnp.asarray(inp["x"]), "q": jnp.asarray(inp["q"]),
         "to_k_w": jnp.asarray(inp["to_k"].T), "infeat_size": (HW, HW)}
    return t, j


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("competitive", [True, False], ids=["joint", "per_stream"])
def test_attentional_pooler_matches_jax(masked, competitive):
    """fg/bg outputs and both attention maps, the pooler built by
    attn_pooler_init and read back by both from_torch's."""
    inp = _inputs(1)
    jcfg = jae.AttnPoolerConfig(feat_dim=C, is_fgbg_competitive=competitive)
    tcfg = tae.AttnPoolerConfig(feat_dim=C, is_fgbg_competitive=competitive)
    pooler = tae.attn_pooler_init(torch.Generator().manual_seed(3), tcfg)
    sd = {f"{n}.weight": w.detach()[..., None] for n, w in pooler.params().items()}
    jp = jae.attn_pooler_from_torch(sd)
    loaded = tae.attn_pooler_from_torch(sd, tcfg)
    t_attn, j_attn = _attn(inp)
    mask = inp["mask"] if masked else None
    want = jae.attn_pooler_forward(jp, jcfg, j_attn, jnp.asarray(inp["fg"]),
                                   jnp.asarray(inp["bg"]), None if mask is None
                                   else jnp.asarray(mask))
    for module in (pooler, loaded):
        got = module(t_attn, torch.from_numpy(inp["fg"]), torch.from_numpy(inp["bg"]),
                     None if mask is None else torch.from_numpy(mask))
        for k in ("fg_out", "bg_out", "attn_fg", "attn_bg"):
            _close(got[k], want[k], k)
    if masked:      # masked-out patches get no weight
        assert float(got["attn_fg"].detach().min()) == 0.0


def test_pooler_gradient_through_grad_scale_matches_jax():
    """The gradients into the layer features (scaled by infeat_grad_scale
    0.5), the probes and the three LoRA weights, against jax.grad."""
    inp = _inputs(2)
    cot = np.random.default_rng(5).standard_normal((2, B, C)).astype(np.float32)
    jcfg, tcfg = jae.AttnPoolerConfig(feat_dim=C), tae.AttnPoolerConfig(feat_dim=C)
    pooler = tae.attn_pooler_init(torch.Generator().manual_seed(4), tcfg)
    jp = {n: jnp.asarray(w.detach().numpy()) for n, w in pooler.params().items()}

    def jloss(p, x, q, fg, bg):
        out = jae.attn_pooler_forward(p, jcfg, {"x": x, "q": q, "to_k_w": jnp.asarray(
            inp["to_k"].T), "infeat_size": (HW, HW)}, fg, bg, jnp.asarray(inp["mask"]))
        return jnp.sum(out["fg_out"] * cot[0]) + jnp.sum(out["bg_out"] * cot[1])

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        jp, *(jnp.asarray(inp[k]) for k in ("x", "q", "fg", "bg")))
    t_attn, _ = _attn(inp, grad=True)
    fg, bg = (torch.from_numpy(inp[k]).requires_grad_(True) for k in ("fg", "bg"))
    out = pooler(t_attn, fg, bg, torch.from_numpy(inp["mask"]))
    ((out["fg_out"] * torch.from_numpy(cot[0])).sum()
     + (out["bg_out"] * torch.from_numpy(cot[1])).sum()).backward()
    for n, w in pooler.params().items():
        _close(w.grad, jg[0][n], n)
    for got, want, what in ((t_attn["x"].grad, jg[1], "x"), (t_attn["q"].grad, jg[2], "q"),
                            (fg.grad, jg[3], "fg"), (bg.grad, jg[4], "bg")):
        assert np.abs(np.asarray(want)).max() > 0
        _close(got, want, what)


# the AdaEmbedding configurations: one stream (H = 1), both with pre_vecs and a
# bias (H = 2, a type-2 embedding), zero-shot, and the cached background
CONFIGS = {
    "h1": dict(num_vectors=3, fg_emb_count=3, bg_emb_count=0, rank=6),
    "h2": dict(num_vectors=9, fg_emb_count=4, bg_emb_count=4, rank=12, num_init_vecs=2),
    "zero_shot": dict(num_vectors=4, fg_emb_count=2, bg_emb_count=2, rank=6, do_zero_shot=True),
    "cached_bg": dict(num_vectors=4, fg_emb_count=2, bg_emb_count=1, rank=6, use_cached_bg=True),
}


def _ada(name, seed=0):
    """(JAX config, port config, port module with random weights, bias
    randomized)."""
    kw = dict(CONFIGS[name], out_emb_dim=D_CTX, ca_infeat_dims=(C,) * 16)
    tcfg, jcfg = tae.AdaEmbedderConfig(**kw), jae.AdaEmbedderConfig(**kw)
    gen = torch.Generator().manual_seed(seed)
    n = kw.get("num_init_vecs", 0)
    init = torch.randn(n, D_CTX, generator=gen) if n else None
    ada = tae.ada_init(gen, tcfg, init)
    if hasattr(ada, "bias"):
        with torch.no_grad():
            ada.bias.normal_(0, 0.05, generator=gen)
    return jcfg, tcfg, ada


def _forward_args(inp, name, seed=6):
    rng = np.random.default_rng(seed)
    kw = CONFIGS[name]
    extra = {}
    if kw.get("do_zero_shot"):
        extra["zs_basis_vecs"] = rng.standard_normal(
            (B, kw["num_vectors"], kw["rank"], D_CTX)).astype(np.float32)
    if kw.get("use_cached_bg"):
        extra["cached_pooler_bg_out"] = rng.standard_normal((B, C)).astype(np.float32)
    return extra


@pytest.mark.parametrize("name", list(CONFIGS))
def test_ada_forward_matches_jax(name):
    """Both packages' ada_from_torch on one reference-layout state dict:
    the output vectors and the pooled bg at the first and the last CA layer,
    with the image mask; the configuration's properties equal."""
    jcfg, tcfg, ada = _ada(name)
    for prop in ("emb_infeat_types", "is_one_stream_only", "H", "td_frac"):
        assert getattr(tcfg, prop) == getattr(jcfg, prop), prop
    assert [tcfg.td(i) for i in range(16)] == [jcfg.td(i) for i in range(16)]
    assert tcfg.pooler_cfg(3).__dict__ == jcfg.pooler_cfg(3).__dict__
    sd = rl.ada_embedding_reference(ada)
    assert sd["poolers.0.lora_to_k.weight"].shape == (C // 8, C // 8, 1)
    jp = jae.ada_from_torch(sd, jcfg)
    loaded = tae.ada_from_torch(sd, tcfg)
    inp = _inputs(7)
    t_attn, j_attn = _attn(inp)
    extra = _forward_args(inp, name)
    for layer_idx in (1, 24):
        want, want_pooled = jae.ada_forward(
            jp, jcfg, layer_idx, j_attn, jnp.asarray(inp["time"]), jnp.asarray(inp["fg"]),
            jnp.asarray(inp["bg"]), jnp.asarray(inp["mask"]),
            **{k: jnp.asarray(v) for k, v in extra.items()})
        for module in (ada, loaded):
            got, pooled = module(layer_idx, t_attn, torch.from_numpy(inp["time"]),
                                 torch.from_numpy(inp["fg"]), torch.from_numpy(inp["bg"]),
                                 torch.from_numpy(inp["mask"]),
                                 **{k: torch.from_numpy(v) for k, v in extra.items()})
            assert got.shape == (B, tcfg.num_vectors, D_CTX)
            _close(got, want, f"{name} layer {layer_idx}")
            _close(pooled["bg_out"], want_pooled["bg_out"], "bg_out")


def test_ada_forward_refusals_match_jax():
    """Zero-shot without basis vectors, the cached background without its
    pooled output: the same ValueError in both packages."""
    inp = _inputs(8)
    t_attn, j_attn = _attn(inp)
    for name, msg in (("zero_shot", "zs_basis_vecs"), ("cached_bg", "cached_pooler_bg_out")):
        jcfg, tcfg, ada = _ada(name)
        jp = jae.ada_from_torch(rl.ada_embedding_reference(ada), jcfg)
        with pytest.raises(ValueError, match=msg):
            jae.ada_forward(jp, jcfg, 1, j_attn, jnp.asarray(inp["time"]),
                            jnp.asarray(inp["fg"]), jnp.asarray(inp["bg"]))
        with pytest.raises(ValueError, match=msg):
            ada(1, t_attn, torch.from_numpy(inp["time"]), torch.from_numpy(inp["fg"]),
                torch.from_numpy(inp["bg"]))


@pytest.mark.parametrize("name", ["h2", "zero_shot"])
def test_ada_from_jax_params_and_init_tree(name):
    """JAX's ada_init tree through convert.from_jax_params into AdaEmbedder
    (strict): the same leaves as the port's ada_init makes, and the same
    forward as JAX's on that tree."""
    kw = dict(CONFIGS[name], out_emb_dim=D_CTX, ca_infeat_dims=(C,) * 16)
    jcfg, tcfg = jae.AdaEmbedderConfig(**kw), tae.AdaEmbedderConfig(**kw)
    n = kw.get("num_init_vecs", 0)
    init = np.random.default_rng(2).standard_normal((n, D_CTX)).astype(np.float32)
    jp = jae.ada_init(jax.random.PRNGKey(3), jcfg, jnp.asarray(init) if n else None)
    jp = jax.tree.map(np.asarray, jp)
    ada = tae.AdaEmbedder(tcfg)
    ada.load_state_dict(convert.from_jax_params(jp), strict=True)
    mine = tae.ada_init(torch.Generator().manual_seed(0), tcfg,
                        torch.from_numpy(init) if n else None)
    assert {k: tuple(v.shape) for k, v in mine.state_dict().items()} == \
        {k: v.shape for k, v in named(jp).items()}
    inp = _inputs(9)
    t_attn, j_attn = _attn(inp)
    extra = _forward_args(inp, name)
    want, _ = jae.ada_forward(jax.tree.map(jnp.asarray, jp), jcfg, 5, j_attn,
                              jnp.asarray(inp["time"]), jnp.asarray(inp["fg"]),
                              jnp.asarray(inp["bg"]),
                              **{k: jnp.asarray(v) for k, v in extra.items()})
    got, _ = ada(5, t_attn, torch.from_numpy(inp["time"]), torch.from_numpy(inp["fg"]),
                 torch.from_numpy(inp["bg"]), **{k: torch.from_numpy(v) for k, v in extra.items()})
    _close(got, want, name)
    if not kw.get("do_zero_shot"):
        np.testing.assert_array_equal(mine.pre_vecs.detach().numpy()[1], init)
        assert not mine.basis_vecs.detach()[:, -1].any()


def test_ada_forward_gradients_match_jax():
    """The gradients of a weighted sum of the H = 2 embedder's output into
    every weight, the layer features and the time embedding, against
    jax.grad."""
    jcfg, tcfg, ada = _ada("h2", seed=1)
    jp = jae.ada_from_torch(rl.ada_embedding_reference(ada), jcfg)
    inp = _inputs(10)
    cot = np.random.default_rng(11).standard_normal((B, 9, D_CTX)).astype(np.float32)
    layer_idx = 7

    def jloss(p, x, q, time):
        out, _ = jae.ada_forward(p, jcfg, layer_idx, {"x": x, "q": q, "to_k_w": jnp.asarray(
            inp["to_k"].T), "infeat_size": (HW, HW)}, time, jnp.asarray(inp["fg"]),
            jnp.asarray(inp["bg"]), jnp.asarray(inp["mask"]))
        return jnp.sum(out * cot)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        jp, *(jnp.asarray(inp[k]) for k in ("x", "q", "time")))
    t_attn, _ = _attn(inp, grad=True)
    time = torch.from_numpy(inp["time"]).requires_grad_(True)
    out, _ = ada(layer_idx, t_attn, time, torch.from_numpy(inp["fg"]),
                 torch.from_numpy(inp["bg"]), torch.from_numpy(inp["mask"]))
    (out * torch.from_numpy(cot)).sum().backward()
    want = named(jg[0])
    got = {k: p.grad for k, p in ada.named_parameters()}
    ca = tae.LAYER_IDX2CA[layer_idx]
    for k, g in want.items():
        if got[k] is None:          # the other layers' weights take no gradient
            assert not np.abs(g).any(), k
            continue
        _close(got[k], g, k)
    assert np.abs(want[f"coeff_w.{ca}"]).max() > 0
    for g, w, what in ((t_attn["x"].grad, jg[1], "x"), (t_attn["q"].grad, jg[2], "q"),
                       (time.grad, jg[3], "time")):
        _close(g, w, what)


def test_reduce_fg_bg_cross_weights_matches_jax():
    """The same scaled coefficient maps from the same input (numpy float32
    in both); H = 1 leaves the tree as it is."""
    kw = dict(num_vectors=3, fg_emb_count=1, bg_emb_count=1, out_emb_dim=16, rank=4,
              ca_infeat_dims=(32,) * 16)
    jcfg, tcfg = jae.AdaEmbedderConfig(**kw), tae.AdaEmbedderConfig(**kw)
    rng = np.random.default_rng(12)
    ws = [rng.uniform(-0.1, 0.1, (12, 2 * 32 + 16)).astype(np.float32) for _ in range(16)]
    want = jae.reduce_fg_bg_cross_weights({"coeff_w": [jnp.asarray(w) for w in ws]}, jcfg)
    got = tae.reduce_fg_bg_cross_weights({"coeff_w": [torch.from_numpy(w) for w in ws]}, tcfg)
    for g, w in zip(got["coeff_w"], want["coeff_w"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    w0 = got["coeff_w"][0].numpy().reshape(3, 4, -1)
    assert np.abs(w0[0, :, 32:64]).mean() <= 0.011 * np.abs(w0[0, :, :32]).mean()
    one = tae.AdaEmbedderConfig(**dict(kw, fg_emb_count=3, bg_emb_count=0))
    params = {"coeff_w": [torch.from_numpy(w) for w in ws]}
    assert tae.reduce_fg_bg_cross_weights(params, one) is params


def test_embedding3d_matches_jax():
    init = np.random.default_rng(13).standard_normal((16, 9, 8)).astype(np.float32)
    for arg in (None, init, init[0, 0]):
        jt = jae.embedding3d_init(16, 9, 8, None if arg is None else jnp.asarray(arg))
        tt = tae.embedding3d_init(16, 9, 8, None if arg is None else torch.from_numpy(arg))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    jt, tt = jae.embedding3d_init(16, 9, 8, jnp.asarray(init)), torch.from_numpy(init.copy())
    np.testing.assert_array_equal(tae.embedding3d_lookup(tt, 3).numpy(),
                                  np.asarray(jae.embedding3d_lookup(jt, 3)))
    np.testing.assert_array_equal(tae.embedding3d_lookup(tt, 3, 2).numpy(),
                                  np.asarray(jae.embedding3d_lookup(jt, 3, 2)))
    new = np.ones((9, 8), np.float32)
    got = tae.embedding3d_cache_layer(tt, 5, torch.from_numpy(new))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jae.embedding3d_cache_layer(jt, 5, jnp.asarray(new))))
    np.testing.assert_array_equal(tt.numpy(), init)                  # out of place
