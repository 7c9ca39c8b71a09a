"""Port personalization chain and training pieces vs the JAX package on
shared weights (tiny CLIP, CPU, float32): grad_scale, the Arc2Face forward
and inverse embeddings, the SubjBasisGenerator face branch and its
gradients, its trainable parameter set, the placeholders, the recon loss,
the forward-process math, the Prodigy lr schedule, and the optimizer chain
clip -> Prodigy -> MultiSteps against optax on the same gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adaprompt_tpu.adaface import arc2face as ja2f, conditioner as jcond
from adaprompt_tpu.adaface import gradient as jgrad, subj_basis_generator as jsbg
from adaprompt_tpu.sampling import schedule as jsched
from adaprompt_tpu.train import losses as jlosses, lr_schedules as jlr, prodigy as jprod
from adaprompt_tpu.train import trainer as jtrainer
from adaprompt_tpu_torch import convert
from adaprompt_tpu_torch.adaface import arc2face as ta2f, conditioner as tcond
from adaprompt_tpu_torch.adaface import gradient as tgrad, subj_basis_generator as tsbg
from adaprompt_tpu_torch.sampling import schedule as tsched
from adaprompt_tpu_torch.train import losses as tlosses, lr_schedules as tlr, prodigy as tprod
from adaprompt_tpu_torch.train import trainer as ttrainer
from torch_port_helpers import HIDDEN, assert_close, named, port_module, t, train_env

EMB_ATOL = 5e-5     # fp32 through 2 CLIP layers and a final LN (|emb| ~ 1-3)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return train_env(tmp_path_factory.mktemp("vocab"))


def _faces(seed, b=2):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((b, 512)).astype(np.float32)
    return f / np.linalg.norm(f, axis=-1, keepdims=True)


def test_trainable_parameters_match_jax_tree(env):
    """Every leaf of the JAX package's trainable SubjBasisGenerator tree is a
    trainable parameter of the port's, under the converted name, and no
    other parameter is (prompt2token_proj's embeddings included)."""
    jtree = jsbg.init_params(jax.random.PRNGKey(0), env["jscfg"])
    sbg = tsbg.SubjBasisGenerator(env["tscfg"])
    want = {k: tuple(v.shape) for k, v in convert.from_jax_params(
        jax.tree.map(np.asarray, jtree)).items()}
    got = {n: tuple(p.shape) for n, p in sbg.named_parameters() if p.requires_grad}
    assert got == want
    assert all(p.requires_grad for p in sbg.parameters())
    assert "prompt2token_proj.token_embedding" in got


@pytest.mark.parametrize("alpha", [0.0, 0.4, 1.0, 5.0])
def test_grad_scale(alpha):
    x = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    g_j = jax.grad(lambda v: jnp.sum(jgrad.grad_scale(v * v, alpha) * w))(jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    out = tgrad.grad_scale(xt * xt, alpha)
    assert_close(out, x * x, atol=0)
    loss = (out * t(w)).sum()
    assert loss.requires_grad == (alpha != 0.0)
    if loss.requires_grad:
        loss.backward()
    assert_close(xt.grad if xt.grad is not None else torch.zeros(3, 4), g_j, atol=1e-6)


@pytest.mark.parametrize("max_len", [21, 77])
def test_forward_face_embs(env, max_len):
    face = _faces(0)
    full_j, core_j = ja2f.forward_face_embs(env["jfrozen"].arc2face_text, env["jtok"],
                                            jnp.asarray(face), text_cfg=env["jt"],
                                            input_max_length=max_len)
    with torch.no_grad():
        full_t, core_t = ta2f.forward_face_embs(env["tfrozen"].arc2face_text, env["ttok"],
                                                t(face), input_max_length=max_len)
    assert core_t.shape == (2, 16, HIDDEN) and full_t.shape == (2, max_len, HIDDEN)
    assert_close(full_t, full_j, atol=EMB_ATOL)
    assert_close(core_t, core_j, atol=EMB_ATOL)


@pytest.mark.parametrize("extra", [None, ["smiling", "the cat"]])
def test_inverse_face_prompt_embs_every_type(env, extra):
    rng = np.random.default_rng(1)
    core = rng.standard_normal((2, 16, HIDDEN)).astype(np.float32)
    hw = np.asarray([[1.0], [2.0], [4.0]], np.float32)
    types = ("full", "full_pad", "full_half_pad", "full_zeroed_extra", "core", "b_core_e")
    jp = env["jsp"]["prompt2token_proj"]
    pad_j = ja2f.generate_pad_embeddings(jp, env["jtok"], env["jt"])
    outs_j = ja2f.inverse_face_prompt_embs(jp, env["jtok"], jnp.asarray(core), types, pad_j,
                                           hidden_state_layer_weights=jnp.asarray(hw),
                                           list_extra_words=extra, text_cfg=env["jt"])
    tp = port_module(tsbg.SubjBasisGenerator(env["tscfg"]), env["jsp"]).prompt2token_proj
    with torch.no_grad():
        pad_t = ta2f.generate_pad_embeddings(tp, env["ttok"])
        outs_t = ta2f.inverse_face_prompt_embs(tp, env["ttok"], t(core), types, pad_t,
                                               hidden_state_layer_weights=t(hw),
                                               list_extra_words=extra)
    assert_close(pad_t, pad_j, atol=0)
    for name, a, b in zip(types, outs_t, outs_j):
        assert a.shape == b.shape, name
        assert_close(a, b, atol=EMB_ATOL)


def test_subj_basis_generator_forward_and_grads(env):
    """The face branch's outputs and the gradients of a fixed linear form of
    both outputs (grad scales 5 on the layer weights, 0.4 on the outputs)."""
    rng = np.random.default_rng(2)
    core = rng.standard_normal((2, 16, HIDDEN)).astype(np.float32)
    w_subj = rng.standard_normal((2, 16, 16, HIDDEN)).astype(np.float32)
    w_prompt = rng.standard_normal((2, 77, HIDDEN)).astype(np.float32)

    def loss_j(params, scale):
        subj, prompt = jsbg.forward(params, env["jscfg"], env["jtok"], jnp.asarray(core),
                                    is_training=True, out_id_embs_scale=scale)
        return jnp.sum(subj * w_subj) + jnp.sum(prompt * w_prompt), (subj, prompt)

    sbg = port_module(tsbg.SubjBasisGenerator(env["tscfg"]), env["jsp"]).train()
    for scale in (1.0, 0.75):
        (_, (subj_j, prompt_j)), g_j = jax.value_and_grad(loss_j, has_aux=True)(env["jsp"], scale)
        sbg.zero_grad()
        subj_t, prompt_t = sbg(env["ttok"], t(core), is_training=True, out_id_embs_scale=scale)
        assert_close(subj_t, subj_j, atol=EMB_ATOL)
        assert_close(prompt_t, prompt_j, atol=EMB_ATOL)
        ((subj_t * t(w_subj)).sum() + (prompt_t * t(w_prompt)).sum()).backward()
        g_j = named(g_j)
        g_max = max(np.abs(g).max() for g in g_j.values())
        for n, p in sbg.named_parameters():
            g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
            # fp32: 1e-5 of the leaf's largest gradient, 1e-6 of the tree's
            assert np.abs(g - g_j[n]).max() <= 1e-5 * np.abs(g_j[n]).max() + 1e-6 * g_max, n
        assert np.abs(g_j["hidden_state_layer_weights"]).max() > 0


def test_placeholders(env):
    js = jcond.make_placeholders(env["jtok"], ("z",), ("y",))
    ts = tcond.make_placeholders(env["ttok"], ("z",), ("y",))
    assert [(s.string, s.token_id, s.num_vectors, s.is_bg) for s in ts] == \
        [(s.string, s.token_id, s.num_vectors, s.is_bg) for s in js]
    ids = env["ttok"](["a photo of a z person", "the cat in the park", "z and z y"])
    for a, b in zip(tcond.find_placeholder_indices(ids, ts[0]),
                    jcond.find_placeholder_indices(ids, js[0])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("masked,bg_weight", [(False, 1.0), (True, 0.0), (True, 0.1)])
def test_calc_recon_loss(masked, bg_weight):
    rng = np.random.default_rng(3)
    out, tgt = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32) for _ in range(2))
    img = (rng.random((2, 8, 8, 1)) > 0.2).astype(np.float32) if masked else None
    fg = (rng.random((2, 8, 8, 1)) > 0.5).astype(np.float32) if masked else None
    opt = lambda a, f: None if a is None else f(a)
    l_j = jlosses.calc_recon_loss(jnp.asarray(out), jnp.asarray(tgt), opt(img, jnp.asarray),
                                  opt(fg, jnp.asarray), 1.0, bg_weight)
    l_t = tlosses.calc_recon_loss(t(out), t(tgt), opt(img, t), opt(fg, t), 1.0, bg_weight)
    np.testing.assert_allclose(float(l_t), float(l_j), rtol=1e-6)


def test_q_sample_and_predict_start():
    rng = np.random.default_rng(4)
    x0, eps = (rng.standard_normal((3, 4, 4, 4)).astype(np.float32) for _ in range(2))
    ts = np.asarray([0, 517, 999])
    xt_j = jsched.q_sample(jsched.SD15_SCHEDULE, jnp.asarray(x0), jnp.asarray(ts), jnp.asarray(eps))
    xt_t = tsched.q_sample(tsched.SD15_SCHEDULE, t(x0), torch.from_numpy(ts), t(eps))
    assert_close(xt_t, xt_j, atol=1e-6)
    p_j = jsched.predict_start_from_noise(jsched.SD15_SCHEDULE, xt_j, jnp.asarray(ts),
                                          jnp.asarray(eps))
    p_t = tsched.predict_start_from_noise(tsched.SD15_SCHEDULE, xt_t, torch.from_numpy(ts), t(eps))
    assert_close(p_t, p_j, atol=1e-4)      # x 1/sqrt(acp_999) ~ 14
    for name in ("sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
                 "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod"):
        np.testing.assert_array_equal(getattr(tsched.SD15_SCHEDULE, name),
                                      getattr(jsched.SD15_SCHEDULE, name))


@pytest.mark.parametrize("cycles", [1, 3])
def test_prodigy_lr_schedule(cycles):
    sj, st = jlr.prodigy_lr_schedule(100, 10, cycles), tlr.prodigy_lr_schedule(100, 10, cycles)
    for step in (0, 5, 9, 10, 11, 39, 40, 41, 70, 99, 150):
        np.testing.assert_allclose(float(st(step)), float(sj(step)), rtol=1e-6, atol=1e-7)


def _grad_stream(rng, params, n):
    """n gradient trees: a fixed direction plus noise, one leaf sometimes zero."""
    out = []
    for i in range(n):
        g = {k: (rng.standard_normal(v.shape) * 0.3 + 0.5).astype(np.float32)
             for k, v in params.items()}
        if i == 2:
            g["b"] = np.zeros_like(g["b"])
        out.append(g)
    return out


@pytest.mark.parametrize("cfg", [
    dict(grad_accum=2),
    dict(grad_accum=1, grad_clip=0.05, scheduler_cycles=2, d_coef=0.5),
])
def test_optimizer_chain_matches_optax(cfg):
    """4 updates of clip_by_global_norm -> Prodigy (with its lr schedule) ->
    MultiSteps on the same gradients, against the JAX package's
    build_optimizer; float32, so to rounding."""
    rng = np.random.default_rng(5)
    params = {"b": rng.standard_normal(3).astype(np.float32),
              "w": rng.standard_normal((4, 3)).astype(np.float32)}
    config = dict(max_steps=12, warm_up_steps=2, **cfg)
    jopt = jtrainer.build_optimizer(jtrainer.TrainerConfig(**config))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = jopt.init(jp)
    tp = {k: torch.nn.Parameter(t(v)) for k, v in params.items()}
    topt = ttrainer.build_optimizer(ttrainer.TrainerConfig(**config), [tp["b"], tp["w"]])
    for g in _grad_stream(rng, params, 4 * cfg["grad_accum"]):
        upd, state = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = t(g[k])
        topt.step()
        for k in params:
            assert_close(tp[k], jp[k], atol=1e-6, rtol=1e-6)
    assert not np.allclose(np.asarray(jp["w"]), params["w"])
    inner = state.inner_opt_state if cfg["grad_accum"] > 1 else state
    np.testing.assert_allclose(float(topt.inner.d), float(inner[1].d), rtol=1e-5)


def test_prodigy_keeps_state_without_progress():
    """All-zero gradients: D and the parameters stay (the `progressed` guard)."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = tprod.Prodigy([p], lr=1.0)
    jstate = jprod.prodigy(lr=1.0).init(jnp.ones(3))
    upd, jstate = jprod.prodigy(lr=1.0).update(jnp.zeros(3), jstate, jnp.ones(3))
    p.grad = torch.zeros(3)
    opt.step()
    assert_close(p, np.ones(3) + np.asarray(upd), atol=0)
    assert float(opt.d) == float(jstate.d) == float(np.float32(1e-6))
