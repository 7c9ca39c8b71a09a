"""The modules of the port's recon iteration vs the JAX package (tiny
shapes, CPU, float32, same numpy-seeded inputs): the prompt splice and
spliced encode, the embedding noise, calc_ref_cosine_loss, the fg/bg
attention regularizers and the subject conv-attention. Values, and
gradients against jax.grad, each with its tolerance stated
(test_torch_recon_unet.py holds the UNet's capture and conv-attention)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaprompt_tpu.adaface import conditioner as jcond
from adaprompt_tpu.models import clip_text as jclip
from adaprompt_tpu.ops import conv_attn as jca
from adaprompt_tpu.train import fgbg as jfgbg, losses as jlosses
from adaprompt_tpu_torch.adaface import conditioner as tcond
from adaprompt_tpu_torch.models import clip_text as tclip
from adaprompt_tpu_torch.ops import conv_attn as tca
from adaprompt_tpu_torch.train import fgbg as tfgbg, losses as tlosses
from adaprompt_tpu_torch.utils.tokenizer import CLIPTokenizer as TorchTokenizer
from torch_port_helpers import JAX_TEXT, TORCH_TEXT, assert_close, port_module, randomized, t
from torch_port_helpers import torch_threads  # noqa: F401

VALUE_TOL = 1e-5       # fp32, the same formula in another summation order
GRAD_TOL = 1e-5        # of the gradient's largest entry


@pytest.fixture(scope="module")
def text():
    """The tiny CLIP text encoder in both packages, holding the same weights."""
    jt = randomized(jclip.init_params(jax.random.PRNGKey(3), JAX_TEXT), 4)
    return jt, port_module(tclip.CLIPTextModel(TORCH_TEXT, device="cpu"), jt)


def _leaf(a):
    return t(a).requires_grad_(True)


def _grad_close(got: torch.Tensor, want, tol=GRAD_TOL):
    want = np.asarray(want)
    assert np.abs(want).max() > 0
    assert_close(got, want, atol=tol * np.abs(want).max())


# -- prompt splicing -------------------------------------------------------------

@pytest.mark.parametrize("layers,per_layer", [(1, False), (16, False), (16, True)])
def test_splice_and_encode_spliced_match_jax(text, layers, per_layer):
    """splice_subject_embeddings and encode_spliced with M = 2 of B = 3
    prompts spliced (K = 4 vectors), L' = 1 or L; the encode's output and
    its gradient with respect to the subject vectors."""
    jt, tt = text
    rng = np.random.default_rng(1)
    ids = np.asarray(TorchTokenizer.fallback()(["a photo of z", "z in the rain", "a dog"]))
    bi, pos, k = np.asarray([0, 1]), np.asarray([3, 1]), 4
    subj = rng.standard_normal((2, layers if per_layer else 1, k, 64)).astype(np.float32) * 0.1
    w = np.asarray([0.2, 0.3, 0.5], np.float32)
    g = rng.standard_normal((layers, 3, 77, 64)).astype(np.float32)
    tok = rng.standard_normal((layers, 3, 77, 64)).astype(np.float32)

    spliced_j = jcond.splice_subject_embeddings(jnp.asarray(tok), jnp.asarray(subj), bi, pos, k)
    assert_close(tcond.splice_subject_embeddings(t(tok), t(subj), bi, pos, k), spliced_j, atol=0)

    def enc_j(s):
        return jcond.encode_spliced(jt, jnp.asarray(ids), [(s, bi, pos, k)], jnp.asarray(w),
                                    16, JAX_TEXT, layerwise=layers == 16)
    out_j = enc_j(jnp.asarray(subj))
    grad_j = jax.grad(lambda s: (enc_j(s) * jnp.asarray(g)).sum())(jnp.asarray(subj))
    s_t = _leaf(subj)
    out_t = tcond.encode_spliced(tt, torch.from_numpy(ids).long(),
                                 [(s_t, torch.from_numpy(bi), torch.from_numpy(pos), k)], t(w),
                                 16, layerwise=layers == 16)
    assert out_t.shape == (layers, 3, 77, 64)
    assert_close(out_t, out_j, atol=2e-5)
    (out_t * t(g)).sum().backward()
    _grad_close(s_t.grad, grad_j, 1e-4)


def test_embedding_noise_matches_jax():
    """add_noise_to_tensor (relative std without gradient) and
    add_noise_to_embedding (with gradient, a row mask), the standard-normal
    draw injected from jax.random; values and gradients."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 2, 4, 16)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    g = rng.standard_normal(x.shape).astype(np.float32)
    mask = np.asarray([1.0, 0.0, 1.0], np.float32)

    f_j = lambda v: jcond.add_noise_to_tensor(v, key, jnp.float32(0.03))
    e_j = lambda v: jcond.add_noise_to_embedding(v, key, (0.02, 0.04), 0.25, jnp.asarray(mask))
    for fn_j, fn_t in ((f_j, lambda v: tcond.add_noise_to_tensor(v, 0.03, noise=t(noise))),
                       (e_j, lambda v: tcond.add_noise_to_embedding(v, (0.02, 0.04), 0.25,
                                                                    t(mask), noise=t(noise)))):
        x_t = _leaf(x)
        out_t = fn_t(x_t)
        assert_close(out_t, fn_j(jnp.asarray(x)), atol=VALUE_TOL)
        (out_t * t(g)).sum().backward()
        _grad_close(x_t.grad, jax.grad(lambda v: (fn_j(v) * g).sum())(jnp.asarray(x)))
    # a generator's draw: the same relative std, noise of the input's shape
    gen = torch.Generator().manual_seed(0)
    out = tcond.add_noise_to_tensor(t(x), 0.03, gen=gen)
    assert out.shape == x.shape and 0 < (out - t(x)).abs().max() < 1


# -- calc_ref_cosine_loss ---------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(),
    dict(exponent=1.0, ref_grad_scale=1.0),
    dict(exponent=3.0, ref_grad_scale=0.5, do_demean_first=True),
    dict(aim_to_align=False, ref_grad_scale=0.1, first_n_dims_to_flatten=2),
    dict(emb_mask="emb", ref_grad_scale=1.0),
    dict(batch_mask="batch", margin=0.3, ref_grad_scale=1.0),
    dict(emb_mask="emb", batch_mask="batch", do_demean_first=True, margin=0.9),
], ids=["default", "exp1", "exp3-demean", "repel", "emb_mask", "batch-margin", "all"])
def test_calc_ref_cosine_loss_matches_jax(kw):
    """Every keyword; the loss and its gradients with respect to delta and
    ref_delta (the latter through grad_scale)."""
    rng = np.random.default_rng(3)
    delta = rng.standard_normal((3, 2, 5, 8)).astype(np.float32)
    ref = rng.standard_normal((3, 2, 5, 8)).astype(np.float32)
    delta[1, 0, 2] = 0.0                       # a zero row: _safe_norm's gradient
    extra = {}
    if kw.get("emb_mask"):
        extra["emb_mask"] = (rng.random((3, 2, 5, 1)) > 0.4).astype(np.float32)
    if kw.get("batch_mask"):
        extra["batch_mask"] = np.asarray([1.0, 0.0, 1.0], np.float32)
    kw = {**kw, **extra}
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    tkw = {k: t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    loss_j, grads_j = jax.value_and_grad(
        lambda d, r: jlosses.calc_ref_cosine_loss(d, r, **jkw), argnums=(0, 1))(
        jnp.asarray(delta), jnp.asarray(ref))
    d_t, r_t = _leaf(delta), _leaf(ref)
    loss_t = tlosses.calc_ref_cosine_loss(d_t, r_t, **tkw)
    assert_close(loss_t, loss_j, atol=VALUE_TOL)
    loss_t.backward()
    _grad_close(d_t.grad, grads_j[0])
    if kw.get("ref_grad_scale", 0.0) == 0.0:
        assert r_t.grad is None and not np.asarray(grads_j[1]).any()
    else:
        _grad_close(r_t.grad, grads_j[1])


# -- fg/bg regularizers --------------------------------------------------------------

B, HEADS, S = 2, 4, 13
LAYER_HW = {7: 8, 8: 8, 12: 4, 16: 8, 17: 8, 18: 8, 19: 16, 20: 16, 21: 16,
            22: 16, 23: 16, 24: 16}


def _scores(seed):
    rng = np.random.default_rng(seed)
    return {li: (rng.random((B, HEADS, hw * hw, S)) * 2 - 1).astype(np.float32)
            for li, hw in LAYER_HW.items()}


@pytest.mark.parametrize("shape,out", [((2, 16, 16, 1), (8, 8)), ((2, 32, 32, 1), (5, 7)),
                                       ((1, 8, 8, 3), (16, 16)), ((2, 7, 9, 1), (13, 4))])
def test_bilinear_resize_and_masks_match_jax(shape, out):
    """bilinear_resize_torch down and up (integer and fractional ratios,
    both borders clipped) equals JAX's gather form, values and gradient;
    resize_mask_for_attn and masked_mean with and without axes."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape[:1] + out + shape[3:]).astype(np.float32)
    fn_j = lambda v: jfgbg.bilinear_resize_torch(v, out)
    x_t = _leaf(x)
    y_t = tfgbg.bilinear_resize_torch(x_t, out)
    assert_close(y_t, fn_j(jnp.asarray(x)), atol=1e-6)
    (y_t * t(g)).sum().backward()
    _grad_close(x_t.grad, jax.grad(lambda v: (fn_j(v) * g).sum())(jnp.asarray(x)))
    mask = (rng.random(shape[:3] + (1,)) > 0.5).astype(np.float32)
    assert_close(tfgbg.resize_mask_for_attn(t(mask), out[0]),
                 jfgbg.resize_mask_for_attn(jnp.asarray(mask), out[0]), atol=1e-6)
    keep = rng.random(shape) > 0.3
    for axis in (None, (1, 2)):
        assert_close(tfgbg.masked_mean(t(x), torch.from_numpy(keep), dim=axis,
                                       keepdim=axis is not None),
                     jfgbg.masked_mean(jnp.asarray(x), jnp.asarray(keep), axis=axis,
                                       keepdims=axis is not None), atol=VALUE_TOL)


def _fg_mask(case, rng):
    if case == "none":
        return None
    fg = (rng.random((B, 32, 32, 1)) > 0.5).astype(np.float32)
    if case == "empty_row":
        fg[1] = 0.0          # the JAX layer skip: `valid` is 0
    return fg


@pytest.mark.parametrize("fg_case", ["mask", "none", "empty_row"])
@pytest.mark.parametrize("per_row", [False, True], ids=["pos_K", "pos_BK"])
@pytest.mark.parametrize("with_bg", [False, True], ids=["no_bg", "bg"])
def test_fgbg_losses_match_jax(fg_case, per_row, with_bg):
    """calc_fg_bg_complementary_loss (with bg_pos None it returns
    (0, calc_fg_mb_suppress_loss, 0, 0)) and calc_fg_bg_xlayer_consist_loss
    on shared scores: each term, and the gradient of a weighted sum of all
    six with respect to every layer's scores."""
    rng = np.random.default_rng(5)
    scores = _scores(6)
    fg = _fg_mask(fg_case, rng)
    subj, bg = [4, 5, 6], [9, 10]
    if per_row:
        subj, bg = [[4, 5, 6], [2, 3, 4]], [[9, 10], [11, 12]]
    bg = bg if with_bg else None
    coef = rng.random(6).astype(np.float32) + 0.5

    def terms_j(sc):
        c = jfgbg.calc_fg_bg_complementary_loss(
            sc, jnp.asarray(subj), None if bg is None else jnp.asarray(bg), B, fg_grad_scale=0.1,
            fg_mask=None if fg is None else jnp.asarray(fg))
        x = jfgbg.calc_fg_bg_xlayer_consist_loss(sc, jnp.asarray(subj),
                                                 None if bg is None else jnp.asarray(bg), B)
        return jnp.stack([*c, *x])

    sc_j = {li: jnp.asarray(v) for li, v in scores.items()}
    want = np.asarray(terms_j(sc_j))
    grads_j = jax.grad(lambda sc: (terms_j(sc) * coef).sum())(sc_j)
    sc_t = {li: _leaf(v) for li, v in scores.items()}
    c = tfgbg.calc_fg_bg_complementary_loss(
        sc_t, torch.tensor(subj), None if bg is None else torch.tensor(bg), B, fg_grad_scale=0.1,
        fg_mask=None if fg is None else t(fg))
    x = tfgbg.calc_fg_bg_xlayer_consist_loss(sc_t, torch.tensor(subj),
                                             None if bg is None else torch.tensor(bg), B)
    got = torch.stack([*c, *x])
    assert_close(got, want, atol=VALUE_TOL, rtol=1e-5)
    assert want[4] > 0 and (want[1] > 0) == (fg_case == "mask")
    if fg_case == "mask" and not with_bg:
        assert_close(c[1], jfgbg.calc_fg_mb_suppress_loss(sc_j, jnp.asarray(subj), B,
                                                          jnp.asarray(fg)), atol=VALUE_TOL)
    (got * t(coef)).sum().backward()
    g_max = max(np.abs(np.asarray(v)).max() for v in grads_j.values())
    for li in scores:
        assert_close(sc_t[li].grad, grads_j[li], atol=GRAD_TOL * g_max)


# -- conv-attention --------------------------------------------------------------------

@pytest.mark.parametrize("ks,shift,mix", [(2, True, 1.0), (3, True, 1.0), (4, True, 0.5),
                                          (3, False, 0.5), (4, False, 1.0), (1, True, 1.0)])
def test_replace_rows_by_conv_attn_matches_jax(ks, shift, mix):
    """ks 2, 3, 4 (and 1: the identity), shifted maps or not, mix weight 1
    and 0.5; values and gradients with respect to the scores, q and k."""
    rng = np.random.default_rng(7)
    b, h, hgt, wdt, c, n_tok = 3, 2, 6, 5, 8, 24
    n = hgt * wdt
    q = rng.standard_normal((b, h, n, c)).astype(np.float32) * 0.3
    k = rng.standard_normal((b, h, n_tok, c)).astype(np.float32) * 0.3
    attn = rng.standard_normal((b, h, n, n_tok)).astype(np.float32)
    pos = np.stack([np.arange(2, 18), np.arange(5, 21)])[:, :ks * ks]       # [BS=2, ks^2]
    g = rng.standard_normal(attn.shape).astype(np.float32)

    def fn_j(a, qq, kk):
        return jca.replace_rows_by_conv_attn(a, qq, kk, jnp.asarray(pos), (hgt, wdt), ks,
                                             c ** -0.5, conv_attn_mix_weight=mix,
                                             shift_attn_maps_for_diff_embs=shift)
    args = (jnp.asarray(attn), jnp.asarray(q), jnp.asarray(k))
    want = fn_j(*args)
    leaves = [_leaf(v) for v in (attn, q, k)]
    got = tca.replace_rows_by_conv_attn(*leaves, torch.from_numpy(pos), (hgt, wdt), ks, c ** -0.5,
                                        conv_attn_mix_weight=mix,
                                        shift_attn_maps_for_diff_embs=shift)
    assert_close(got, want, atol=VALUE_TOL)
    if ks == 1:
        return
    assert not np.allclose(np.asarray(want), attn)
    (got * t(g)).sum().backward()
    grads_j = jax.grad(lambda *a: (fn_j(*a) * g).sum(), argnums=(0, 1, 2))(*args)
    for leaf, gj in zip(leaves, grads_j):
        _grad_close(leaf.grad, gj)
