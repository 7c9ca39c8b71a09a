"""The modules of the port's compositional (Stage-2) iteration vs the JAX
package (tiny shapes, CPU, float32, the same numpy-seeded inputs): the rest
of losses.py (ortho_subtract, calc_prompt_emb_delta_loss),
cls_delta.distribute_embedding_layerwise, compos.py (the V/K mixes, the
delta alignment, the spatial weights, the mix-prompt loss, the teacher
selection), elastic.py (both losses and the q BatchNorm statistics) and the
host pieces of compos_step.py. Values, and gradients against jax.grad (a
value-only test would miss a wrong grad_scale), each with its tolerance
stated (test_torch_compos_step.py holds the phases)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaprompt_tpu.adaface import cls_delta as jcd
from adaprompt_tpu.train import compos as jcompos, compos_step as jcs, elastic as jel
from adaprompt_tpu.train import losses as jlosses
from adaprompt_tpu_torch.adaface import cls_delta as tcd
from adaprompt_tpu_torch.train import compos as tcompos, compos_step as tcs, elastic as tel
from adaprompt_tpu_torch.train import losses as tlosses
from torch_port_helpers import assert_close, t

VALUE_TOL = 1e-5       # fp32, the same formula in another summation order: of the largest value
GRAD_TOL = 1e-5        # of the gradient's largest entry


def _leaf(a):
    return t(a).requires_grad_(True)


def _close(got, want, tol=VALUE_TOL):
    want = np.asarray(want)
    assert_close(got, want, atol=tol * max(np.abs(want).max(), 1e-30))


def _grad_close(got: torch.Tensor, want, tol=GRAD_TOL):
    want = np.asarray(want)
    assert np.abs(want).max() > 0
    assert_close(got, want, atol=tol * np.abs(want).max())


def _grads_match(jfn, tfn, arrays, tol=GRAD_TOL, aux=False):
    """jax.grad of the scalar jfn (jitted: one compile) and torch autograd of
    tfn, with respect to every input array; returns both values (a loss's
    are compared by the caller; a cotangent-weighted sum's are not, its
    outputs are). With aux, jfn and tfn return (scalar, outputs), and the
    returned values are the outputs."""
    grad_fn = jax.jit(jax.value_and_grad(jfn, argnums=tuple(range(len(arrays))), has_aux=aux))
    want_v, want_g = grad_fn(*[jnp.asarray(a) for a in arrays])
    leaves = [_leaf(a) for a in arrays]
    got_v = tfn(*leaves)
    if aux:
        (got_v, got_aux), want_v = got_v, want_v[1]
    got_v.backward()
    for i, (lf, g) in enumerate(zip(leaves, want_g)):
        if np.abs(np.asarray(g)).max() == 0:
            assert lf.grad is None or lf.grad.abs().max() == 0, i
        else:
            _grad_close(lf.grad, g, tol)
    return (got_aux, want_v) if aux else (got_v, want_v)


# -- losses.py ---------------------------------------------------------------------

@pytest.mark.parametrize("n_dims,a_shape,b_shape", [(1, (3, 5, 16), (3, 5, 16)),
                                                   (1, (3, 5, 16), (1, 5, 16)),
                                                   (2, (3, 5, 16), (3, 5, 16))],
                         ids=["last-dim", "broadcast", "last-2-dims"])
def test_ortho_subtract_matches_jax(n_dims, a_shape, b_shape):
    rng = np.random.default_rng(0)
    a = rng.standard_normal(a_shape).astype(np.float32)
    b = rng.standard_normal(b_shape).astype(np.float32)
    g = rng.standard_normal(np.broadcast_shapes(a_shape, b_shape)).astype(np.float32)
    _grads_match(lambda x, y: (jlosses.ortho_subtract(x, y, n_dims) * g).sum(),
                 lambda x, y: (tlosses.ortho_subtract(x, y, n_dims) * t(g)).sum(), [a, b])
    _close(tlosses.ortho_subtract(t(a), t(b), n_dims),
           jlosses.ortho_subtract(jnp.asarray(a), jnp.asarray(b), n_dims))


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
def test_prompt_emb_delta_loss_matches_jax(masked):
    """The value and the gradient into all four prompt types (the class
    delta's at the 0.05 grad scale)."""
    rng = np.random.default_rng(1)
    embs = rng.standard_normal((4, 3, 12, 16)).astype(np.float32)
    mask = (rng.random((4, 12, 1)) > 0.3).astype(np.float32) if masked else None
    got, want = _grads_match(
        lambda e: jlosses.calc_prompt_emb_delta_loss(e, None if mask is None else jnp.asarray(mask)),
        lambda e: tlosses.calc_prompt_emb_delta_loss(e, None if mask is None else t(mask)), [embs])
    _close(got.detach(), want)
    assert float(want) > 0


# -- cls_delta.py ------------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["sqrt_M", "M", "none"])
def test_distribute_embedding_layerwise_matches_jax(scheme):
    """The class word's embedding spread over k slots in rows 2 and 3 at
    their own positions: values and the gradient into the context."""
    rng = np.random.default_rng(2)
    ctx = rng.standard_normal((3, 4, 20, 8)).astype(np.float32)
    pos0 = np.asarray([5, 7])
    g = rng.standard_normal(ctx.shape).astype(np.float32)
    _grads_match(
        lambda c: (jcd.distribute_embedding_layerwise(c, [2, 3], jnp.asarray(pos0), 4, scheme)
                   * g).sum(),
        lambda c: (tcd.distribute_embedding_layerwise(c, [2, 3], torch.as_tensor(pos0), 4, scheme)
                   * t(g)).sum(), [ctx])
    out = tcd.distribute_embedding_layerwise(t(ctx), [2, 3], torch.as_tensor(pos0), 4, scheme)
    _close(out, jcd.distribute_embedding_layerwise(jnp.asarray(ctx), [2, 3], jnp.asarray(pos0),
                                                   4, scheme))
    np.testing.assert_array_equal(out[:, :2].numpy(), ctx[:, :2])       # subject rows untouched


# -- compos.py ---------------------------------------------------------------------

@pytest.mark.parametrize("training_percent", [0.0, 0.6])
def test_mix_static_vk_embeddings_matches_jax(training_percent):
    """Both mixes' values, and the gradients into the subject and class
    contexts (the class one only through the 0.05-scaled mixes)."""
    rng = np.random.default_rng(3)
    subj = rng.standard_normal((16, 2, 12, 8)).astype(np.float32)
    cls = rng.standard_normal((16, 2, 12, 8)).astype(np.float32)
    t_frac = np.asarray([0.9, 0.45], np.float32)
    gv, gk = (rng.standard_normal(subj.shape).astype(np.float32) for _ in range(2))
    pos = [3, 4, 5]

    def jfn(s, c):
        v, k = jcompos.mix_static_vk_embeddings(s, c, pos, jnp.asarray(t_frac), training_percent)
        return (v * gv).sum() + (k * gk).sum()

    def tfn(s, c):
        v, k = tcompos.mix_static_vk_embeddings(s, c, pos, t(t_frac), training_percent)
        return (v * t(gv)).sum() + (k * t(gk)).sum()

    _grads_match(jfn, tfn, [subj, cls])
    v_t, k_t = tcompos.mix_static_vk_embeddings(t(subj), t(cls), pos, t(t_frac), training_percent)
    v_j, k_j = jcompos.mix_static_vk_embeddings(jnp.asarray(subj), jnp.asarray(cls), pos,
                                                jnp.asarray(t_frac), training_percent)
    _close(v_t, v_j)
    _close(k_t, k_j)


@pytest.mark.parametrize("fb_scale", [0.05, -1])
def test_calc_delta_alignment_loss_matches_jax(fb_scale):
    rng = np.random.default_rng(4)
    arrays = [rng.standard_normal((1, 4, 30)).astype(np.float32) for _ in range(4)]
    for dt in ("feat_to_ref", "ex_to_base"):
        got, want = _grads_match(
            lambda *a: jcompos.calc_delta_alignment_loss(
                *a, feat_base_grad_scale=fb_scale, cosine_exponent=3.0, delta_types=(dt,))[dt],
            lambda *a: tcompos.calc_delta_alignment_loss(
                *a, feat_base_grad_scale=fb_scale, cosine_exponent=3.0, delta_types=(dt,))[dt],
            arrays)
        _close(got.detach(), want)


@pytest.mark.parametrize("reversed_", [True, False])
def test_convert_attn_to_spatial_weight_matches_jax(reversed_):
    """The weight and the map; population std; no gradient flows."""
    rng = np.random.default_rng(5)
    attn = rng.random((2, 3, 64)).astype(np.float32)
    w_j, sa_j = jcompos.convert_attn_to_spatial_weight(jnp.asarray(attn), 1, (16, 16), reversed_)
    w_t, sa_t = tcompos.convert_attn_to_spatial_weight(_leaf(attn), 1, (16, 16), reversed_)
    _close(w_t, w_j)
    _close(sa_t, sa_j)
    assert not w_t.requires_grad


# the capture layers of the mix and preserve losses at tiny sizes: (h, channels)
_LAYERS = {7: (8, 16), 8: (8, 16), 12: (4, 24), 16: (4, 24), 24: (16, 8)}
_HEADS = 2
SUBJ_POS = [4, 5, 6]


def _captures(seed, q_hw=None):
    rng = np.random.default_rng(seed)
    outfeats, scores, qs = {}, {}, {}
    for li, (h, c) in _LAYERS.items():
        outfeats[li] = rng.standard_normal((4, h, h, c)).astype(np.float32)
        scores[li] = rng.standard_normal((4, _HEADS, h * h, 77)).astype(np.float32)
        qh = q_hw or h
        qs[li] = rng.standard_normal((4, _HEADS, qh * qh, c // _HEADS)).astype(np.float32)
    return outfeats, scores, qs


def _flat(d):
    return [d[k] for k in _LAYERS]


def _unflat(xs):
    return dict(zip(_LAYERS, xs))


@pytest.mark.parametrize("norm", [0.0, 1.0], ids=["plain", "layernorm"])
def test_calc_prompt_mix_loss_matches_jax(norm):
    """The three terms' values and their gradients with respect to every
    captured outfeat and score map (the pooling specs of 8 and 16 and the
    tiny sizes' proportional pooling), with the affine-free LayerNorm coin
    at 0 and 1."""
    outfeats, scores, _ = _captures(6)
    n = len(_LAYERS)
    weights = np.asarray([1.0, 3.0, 7.0], np.float32)    # tells the three terms apart

    def jfn(*xs):
        terms = jcompos.calc_prompt_mix_loss(_unflat(xs[:n]), _unflat(xs[n:]), SUBJ_POS,
                                             normalize_outfeat=norm)
        return sum(w * v for w, v in zip(weights, terms)), terms

    def tfn(*xs):
        terms = tcompos.calc_prompt_mix_loss(_unflat(xs[:n]), _unflat(xs[n:]), SUBJ_POS,
                                             normalize_outfeat=norm)
        return sum(float(w) * v for w, v in zip(weights, terms)), terms

    terms_t, terms_j = _grads_match(jfn, tfn, _flat(outfeats) + _flat(scores), aux=True)
    for a, b in zip(terms_t, terms_j):
        assert float(b) > 0
        _close(a.detach(), b)


@pytest.mark.parametrize("subj,cls", [
    ([0.30, 0.31], [0.25, 0.20]),        # both teachable: the larger margin wins
    ([0.30, 0.30], [0.20, 0.20]),        # a tie: the first
    ([0.282, 0.40], [0.28, 0.29]),       # margin exactly 0.002 / cls above 0.28: none
    ([0.2821, 0.40], [0.28, 0.281]),     # cls exactly at the threshold, margin just above
    ([0.10, 0.35], [0.30, 0.28]),        # the second only
])
def test_teacher_selection_matches_jax(subj, cls):
    """select_teachable_candidate and clip_teachability on ties and on the
    threshold and margin edges."""
    want = jcompos.select_teachable_candidate(np.asarray(subj), np.asarray(cls))
    assert tcompos.select_teachable_candidate(np.asarray(subj), np.asarray(cls)) == want
    s, c = np.asarray(subj, np.float32), np.asarray(cls, np.float32)
    np.testing.assert_array_equal(
        tcompos.clip_teachability(t(c), t(s)).numpy(),
        np.asarray(jcompos.clip_teachability(jnp.asarray(c), jnp.asarray(s))))


# -- elastic.py ----------------------------------------------------------------------

def test_elastic_matching_loss_matches_jax():
    """The three losses (weighted apart) and both bg probabilities; the
    gradients into q and the outfeats (the single rows' at 0.1 and 0.01,
    the mix feature's at 0.05)."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((4, 12, 25)).astype(np.float32) * 0.3
    of = rng.standard_normal((4, 12, 25)).astype(np.float32)
    fg = (rng.random((1, 1, 25)) > 0.8).astype(np.float32)   # ~20% fg: some bg probability
    weights = (1.0, 5.0, 11.0)

    def jfn(a, b):
        out = jel.calc_elastic_matching_loss(a, b, jnp.asarray(fg))
        return sum(w * v for w, v in zip(weights, out[:3])), out

    def tfn(a, b):
        out = tel.calc_elastic_matching_loss(a, b, t(fg))
        return sum(w * v for w, v in zip(weights, out[:3])), out

    out_t, out_j = _grads_match(jfn, tfn, [q, of], aux=True)
    for a, b in zip(out_t, out_j):
        _close(a.detach(), b)
    assert np.asarray(out_j[4]).max() > 0                 # some tokens are inferred background


@pytest.mark.parametrize("q_hw,normalize", [(None, True), (4, True), (None, False)],
                         ids=["same-size", "q-smaller", "unnormalized"])
def test_comp_fg_bg_preserve_loss_matches_jax(q_hw, normalize):
    """The six terms (weighted apart), their gradients into the outfeats, q
    and the score maps, and the q BatchNorm statistics (the running variance
    unbiased); with the outfeats resized to q's grid, and without the
    normalizations."""
    outfeats, scores, qs = _captures(8, q_hw)
    fg = np.zeros((1, 32, 32, 1), np.float32)
    fg[:, 6:22, 9:25] = 1.0
    n = len(_LAYERS)
    weights = np.asarray([1.0, 2.0, 0.0, 5.0, 7.0, 13.0], np.float32)

    def jfn(*xs):
        terms, stats = jel.calc_comp_fg_bg_preserve_loss(
            _unflat(xs[:n]), _unflat(xs[n:2 * n]), _unflat(xs[2 * n:]), jnp.asarray(fg),
            SUBJ_POS, normalize_q_outfeat=normalize)
        return sum(w * v for w, v in zip(weights, terms)), (terms, stats)

    def tfn(*xs):
        terms, stats = tel.calc_comp_fg_bg_preserve_loss(
            _unflat(xs[:n]), _unflat(xs[n:2 * n]), _unflat(xs[2 * n:]), t(fg), SUBJ_POS,
            normalize_q_outfeat=normalize)
        return sum(float(w) * v for w, v in zip(weights, terms)), (terms, stats)

    (terms_t, stats_t), (terms_j, stats_j) = _grads_match(
        jfn, tfn, _flat(outfeats) + _flat(qs) + _flat(scores), aux=True)
    for a, b in zip(terms_t, terms_j):
        _close(a.detach(), b)
    assert list(stats_t) == list(stats_j) == (list(_LAYERS) if normalize else [])
    for li in stats_j:
        for a, b in zip(stats_t[li], stats_j[li]):
            _close(a, b)


def test_preserve_loss_without_fg_mask_is_zero():
    outfeats, scores, qs = _captures(10)
    terms, stats = tel.calc_comp_fg_bg_preserve_loss(
        {k: t(v) for k, v in outfeats.items()}, {k: t(v) for k, v in qs.items()},
        {k: t(v) for k, v in scores.items()}, None, SUBJ_POS)
    assert [float(x) for x in terms] == [0.0] * 6 and stats == {}


# -- compos_step.py host pieces ----------------------------------------------------

@pytest.mark.parametrize("scale", [1.0, 0.8, 0.55])
def test_scale_into_canvas_matches_jax(scale):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 12, 12, 5)).astype(np.float32)
    _close(tcs.scale_into_canvas(t(x), scale), jcs.scale_into_canvas(jnp.asarray(x), scale))


def test_init_x_with_fg_matches_jax():
    """JAX's two noises (the key's and its fold_in(1)'s) injected."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    fg = np.zeros((1, 16, 16, 1), np.float32)
    fg[:, 4:12, 5:11] = 1.0
    key = jax.random.PRNGKey(3)
    noise = jax.random.normal(key, x.shape, jnp.float32)
    noise2 = jax.random.normal(jax.random.fold_in(key, 1), x.shape, jnp.float32)
    want = jcs.init_x_with_fg_from_training_image(jnp.asarray(x), jnp.asarray(fg),
                                                  jnp.asarray(fg), key, 0.8)
    got = tcs.init_x_with_fg_from_training_image(t(x), t(fg), t(fg), 0.8, noise=t(noise),
                                                 noise2=t(noise2))
    for a, b in zip(got, want):
        _close(a, b)
    # from a generator: the same structure, two draws of x's shape
    out, _, ffg = tcs.init_x_with_fg_from_training_image(t(x), t(fg), t(fg), 0.8,
                                                         gen=torch.Generator().manual_seed(0))
    assert out.shape == x.shape and float(ffg.sum()) <= fg.sum()


def test_host_draws_match_jax():
    """pick_fg_rand_scale (small and large foregrounds) and CachedInits
    (put, has, take's t in [400, 700) capped at prev_t - 150) on the same
    numpy stream leave the stream where JAX's leaves it."""
    small = np.zeros((16, 16))
    small[:2, :2] = 1
    big = (np.random.default_rng(0).random((16, 16)) < 0.5).astype(float)
    rng_j, rng_t = np.random.default_rng(5), np.random.default_rng(5)
    for m in (small, big, big):
        assert tcs.pick_fg_rand_scale(m, rng_t) == jcs.pick_fg_rand_scale(m, rng_j)
    x = np.random.default_rng(1).standard_normal((4, 8, 8, 4)).astype(np.float32)
    prev = np.asarray([900, 900, 520, 610])
    cj, ct = jcs.CachedInits(1000), tcs.CachedInits(1000)
    cj.put("s", x, prev)
    ct.put("s", x, prev)
    assert ct.has("s") and not ct.has("other")
    xj, tj = cj.take("s", rng_j)
    xt, tt = ct.take("s", rng_t)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(tt, tj)
    assert tt.dtype == np.int32 and not ct.has("s")
    assert np.all(tt < 700) and np.all(tt <= prev - 150) and np.all(tt >= 0)
    np.testing.assert_array_equal(rng_t.random(3), rng_j.random(3))
