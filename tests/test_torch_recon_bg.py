"""The background ("y" token) branch of the port's zero-shot recon training
vs the JAX package (tiny models, CPU, float32, shared weights and draws):
the background SubjBasisGenerator (forward and every gradient, with and
without the pad blend, and its refusal of a feature row count other than
num_id_vecs_bg), the recon step with use_bg (every loss term, every
trainable leaf's gradient, bg_basis and emb_scales included, and the
update), and the trainer's mixed run (the iteration types, the host draws
in JAX's order, the CLIP features of prepare_recon_batch) with a
checkpoint round trip that carries bg_basis."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaprompt_tpu.adaface import checkpoint as jckpt, conditioner as jcond
from adaprompt_tpu.adaface import subj_basis_generator as jsbg, zs_features as jzs
from adaprompt_tpu.models import clip_vision as jcv, vae as jvae
from adaprompt_tpu.train import steps as jsteps, trainer as jtrainer
from adaprompt_tpu_torch.adaface import conditioner as tcond
from adaprompt_tpu_torch.adaface import subj_basis_generator as tsbg, zs_features as tzs
from adaprompt_tpu_torch.adaface.checkpoint import module_tree
from adaprompt_tpu_torch.models import clip_vision as tcv, vae as tvae
from adaprompt_tpu_torch.ops.layers import reset_parameters
from adaprompt_tpu_torch.train import steps as tsteps, trainer as ttrainer
from torch_port_helpers import HIDDEN, keeping_grads, named, port_module, randomized, t, train_env
from torch_port_helpers import torch_threads  # noqa: F401

LOSS_RTOL = 1e-5    # fp32, different summation orders through 2 CLIPs and a UNet
REG_ATOL = 1e-9     # the regularizer terms are ~1e-2..1 before their 1e-4 weights
GRAD_TOL = 1e-5     # of the leaf's largest gradient, plus 1e-6 of the tree's
VISION = dict(image_size=32, patch_size=8, hidden_size=64, intermediate_size=128,
              num_layers=2, num_heads=4, projection_dim=32)
S = (32 // 8) ** 2 + 1          # the tiny tower's tokens; its features have 2S rows
# the keys' LN bias shifts every key by one vector, so each query's logits
# by one constant: the softmax, and so the loss, does not depend on it (its
# gradient is 0 up to rounding)
KEY_SHIFT = "prompt_translator.to_k.ln.bias"
CAPTIONS = [ttrainer.CAPTION_BG, "a z" + ", " * 15 + "in the park with background y" + ", " * 3]


def _bg_cfgs(output_dim, image_dim, rows):
    kw = dict(placeholder_is_bg=True, num_out_embs_per_layer=4, num_id_vecs_bg=rows,
              image_embedding_dim=image_dim, output_dim=output_dim)
    return jsbg.SubjBasisConfig(**kw), tsbg.SubjBasisConfig(**kw)


def _bg_pair(jcfg, tcfg, seed):
    """The background generator in both packages, holding the same weights
    (the LNs' zero biases re-randomized)."""
    jp = randomized(jsbg.init_params(jax.random.PRNGKey(seed), jcfg), seed + 1)
    tm = port_module(tsbg.SubjBasisGenerator(tcfg), jp).train()
    return jax.tree.map(jnp.asarray, jp), tm


def test_bg_config_matches_jax():
    """SubjBasisConfig's fields in JAX's order with JAX's defaults (the text
    encoder's config compared by value), and BG_CONFIG."""
    fields = lambda cls: [f.name for f in dataclasses.fields(cls)]
    assert fields(tsbg.SubjBasisConfig) == fields(jsbg.SubjBasisConfig)
    for cfg_t, cfg_j in ((tsbg.BG_CONFIG, jsbg.BG_CONFIG), (tsbg.SUBJ_CONFIG, jsbg.SUBJ_CONFIG)):
        a, b = dataclasses.asdict(cfg_t), dataclasses.asdict(cfg_j)
        assert a.pop("text_cfg") == b.pop("text_cfg")
        assert a == b


@pytest.mark.parametrize("scale", [1.0, 0.7], ids=["plain", "pad-blend"])
def test_bg_generator_matches_jax(scale):
    """[B, 16, 4, D] and the gradient of sum(out * g) with respect to every
    parameter and to the CLIP features, against jax.grad."""
    jcfg, tcfg = _bg_cfgs(48, 24, 10)
    jp, tm = _bg_pair(jcfg, tcfg, 3)
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((2, 10, 24)).astype(np.float32)
    pads = rng.standard_normal((20, 48)).astype(np.float32)
    g = rng.standard_normal((2, 16, 4, 48)).astype(np.float32)

    def f(p, x):
        out, prompt = jsbg.forward(p, jcfg, None, clip_features=x, out_id_embs_scale=scale,
                                   pad_embeddings=jnp.asarray(pads), is_training=True)
        assert prompt is None
        return (out * jnp.asarray(g)).sum(), out

    (_, want), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(feats))
    x = t(feats).requires_grad_(True)
    out, prompt = tm(None, clip_features=x, out_id_embs_scale=scale, pad_embeddings=t(pads),
                     is_training=True)
    assert prompt is None and tuple(out.shape) == want.shape == (2, 16, 4, 48)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(want)).max())
    (out * t(g)).sum().backward()
    want_g = dict(named(gp), clip_features=np.asarray(gx))
    got_g = dict({n: p.grad.numpy() for n, p in tm.named_parameters()},
                 clip_features=x.grad.numpy())
    assert set(got_g) == set(want_g)
    g_max = max(np.abs(v).max() for v in want_g.values())
    for n, w in want_g.items():
        assert np.abs(w).max() > 0, n
        assert np.abs(got_g[n] - w).max() <= GRAD_TOL * np.abs(w).max() + 1e-6 * g_max, n


def test_bg_generator_refuses_other_row_counts():
    """Features whose row count is not num_id_vecs_bg: the port names both
    shapes in a ValueError; JAX's broadcast raises a TypeError. A blend
    without pad embeddings is refused too."""
    jcfg, tcfg = _bg_cfgs(48, 24, 10)
    jp, tm = _bg_pair(jcfg, tcfg, 3)
    feats = np.zeros((2, 20, 24), np.float32)
    with pytest.raises(TypeError):
        jsbg.forward(jp, jcfg, None, clip_features=jnp.asarray(feats))
    with pytest.raises(ValueError, match=r"\(2, 20, 24\).*\(1, 10, 48\)"):
        tm(None, clip_features=t(feats))
    with pytest.raises(ValueError, match="pad_embeddings"):
        tm(None, clip_features=t(np.zeros((2, 10, 24), np.float32)), out_id_embs_scale=0.5)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    env = train_env(tmp_path_factory.mktemp("vocab"))
    jbg, tbg = _bg_cfgs(HIDDEN, VISION["hidden_size"], 2 * S)
    jbp, _ = _bg_pair(jbg, tbg, 11)
    return dict(env, jbg=jbg, tbg=tbg, jbp=jbp)


def _batch(env, seed, b=2):
    rng = np.random.default_rng(seed)
    ids = np.asarray(env["jtok"](CAPTIONS))
    np.testing.assert_array_equal(ids, np.asarray(env["ttok"](CAPTIONS)))
    specs = jcond.make_placeholders(env["jtok"], ("z",), ("y",))
    tspecs = tcond.make_placeholders(env["ttok"], ("z",), ("y",))
    assert [s.token_id for s in specs] == [s.token_id for s in tspecs]
    bi, pos = jcond.find_placeholder_indices(ids, specs[0])
    bbi, bpos = jcond.find_placeholder_indices(ids, specs[1])
    assert list(bi) == list(bbi) == [0, 1] and (bpos >= pos + 16).all(), (pos, bpos)
    fid = rng.standard_normal((b, 512)).astype(np.float32)
    fid /= np.linalg.norm(fid, axis=-1, keepdims=True)
    return {"z0": rng.standard_normal((b, 8, 8, 4)).astype(np.float32), "faceid": fid,
            "caption_ids": ids.astype(np.int32), "subj_bi": bi, "subj_pos": pos,
            "bg_bi": bbi, "bg_pos": bpos,
            "clip_features": rng.standard_normal((b, 2 * S, VISION["hidden_size"])).astype(
                np.float32),
            "fg_mask": (rng.random((b, 8, 8, 1)) > 0.4).astype(np.float32),
            "aug_mask": (rng.random((b, 8, 8, 1)) > 0.2).astype(np.float32),
            "skip_weights": rng.dirichlet((1.0, 2.0, 2.0)).astype(np.float32),
            "emb_noise_std": np.float32(0.03),
            "emb_scale_perturb": np.asarray([1.2, 0.9], np.float32)}


def _jax_draws(key, b, scfg):
    """The draws of make_zs_recon_step's loss_fn."""
    kt, kn, ke = jax.random.split(key, 3)
    emb_shape = (b, scfg.num_out_layers, scfg.num_out_embs_per_layer, scfg.output_dim)
    return {"t": torch.from_numpy(np.array(jax.random.randint(kt, (b,), 0, 1000))).long(),
            "noise": t(jax.random.normal(kn, (b, 8, 8, 4), jnp.float32)),
            "emb_noise": t(jax.random.normal(ke, emb_shape, jnp.float32))}


@pytest.mark.parametrize("fgbg_reg", [False, True], ids=["plain", "fgbg"])
def test_recon_bg_step_matches_jax(env, fgbg_reg):
    """Loss terms, gradient norm, every trainable gradient (the subject and
    the background generators', emb_scales') and the parameters after one
    clip -> Prodigy update, with the background vectors spliced per layer."""
    batch_np = _batch(env, 3)
    key = jax.random.PRNGKey(30)
    scores0 = np.asarray([0.3, -0.2], np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    trainable = {"subj_basis": env["jsp"], "emb_scales": jnp.asarray(scores0),
                 "bg_basis": env["jbp"]}
    tcfg = dict(grad_accum=1, max_steps=10, warm_up_steps=2)
    jopt = keeping_grads(jtrainer.build_optimizer(jtrainer.TrainerConfig(**tcfg)))
    step_j = jax.jit(jtrainer.make_zs_recon_step(
        jopt, env["jfrozen"], env["jtok"], env["jscfg"], bg_basis_cfg=env["jbg"], use_bg=True,
        fgbg_reg=fgbg_reg, compute_dtype=jnp.float32))
    jstate, metrics = step_j(jsteps.create_train_state(trainable, jopt),
                             jsteps.frozen_params(env["jfrozen"]), jbatch, key)
    jgrads = jstate.opt_state[1]

    sbg = port_module(tsbg.SubjBasisGenerator(env["tscfg"]), env["jsp"]).train()
    bg = port_module(tsbg.SubjBasisGenerator(env["tbg"]),
                     jax.tree.map(np.asarray, env["jbp"])).train()
    params = {"subj_basis": sbg, "emb_scales": torch.nn.Parameter(t(scores0)), "bg_basis": bg}
    tstate = tsteps.TrainState(params, ttrainer.build_optimizer(
        ttrainer.TrainerConfig(**tcfg), tsteps.trainable_parameters(params)))
    leaves = {**{"subj_basis." + n: p for n, p in sbg.named_parameters()},
              **{"bg_basis." + n: p for n, p in bg.named_parameters()},
              "emb_scales": params["emb_scales"]}
    grads = {}
    for n, p in leaves.items():
        p.register_hook(lambda g, n=n: grads.__setitem__(n, g.clone()))
    step = tsteps.make_zs_recon_step(env["tfrozen"], env["ttok"], env["tscfg"],
                                     bg_basis_cfg=env["tbg"], use_bg=True, fgbg_reg=fgbg_reg,
                                     compute_dtype=torch.float32)
    tbatch = {k: (torch.from_numpy(np.asarray(v)).long()
                  if k in ("caption_ids", "subj_bi", "subj_pos", "bg_bi", "bg_pos") else t(v))
              for k, v in batch_np.items()}
    tstate, tm = step(tstate, tsteps.frozen_params(env["tfrozen"]), tbatch, None,
                      draws=_jax_draws(key, 2, env["jscfg"]))

    want_keys = {"loss", "loss_recon", "grad_norm"}
    if fgbg_reg:
        want_keys |= {"loss_fg_bg_complementary", "loss_subj_mb_suppress", "loss_bg_mf_suppress",
                      "loss_fg_bg_mask_contrast", "loss_fg_xlayer_consist",
                      "loss_bg_xlayer_consist"}
    assert set(tm) == set(metrics) == want_keys
    if fgbg_reg:     # every background term is live under use_bg
        for name in ("loss_fg_bg_complementary", "loss_bg_mf_suppress",
                     "loss_bg_xlayer_consist"):
            assert float(metrics[name]) > 0, name
    for name in want_keys - {"grad_norm"}:
        np.testing.assert_allclose(float(tm[name]), float(metrics[name]), rtol=LOSS_RTOL,
                                   atol=REG_ATOL, err_msg=name)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(metrics["grad_norm"]), rtol=1e-4)

    flat = lambda tree: {f"{top}.{k}": np.asarray(v) for top in ("subj_basis", "bg_basis")
                         for k, v in named(tree[top]).items()}
    jflat = dict(flat(jgrads), emb_scales=np.asarray(jgrads["emb_scales"]))
    jnew = dict(flat(jstate.params), emb_scales=np.asarray(jstate.params["emb_scales"]))
    old = dict(flat(trainable), emb_scales=scores0)
    assert set(jflat) == set(leaves)
    assert np.abs(jflat["emb_scales"]).min() > 0            # both global scales are trained
    g_max = max(np.abs(g).max() for g in jflat.values())
    moved = 0
    for name, p in leaves.items():
        g_j = jflat[name]
        g_t = grads.get(name, torch.zeros_like(p)).numpy()
        assert np.abs(g_t - g_j).max() <= GRAD_TOL * np.abs(g_j).max() + 1e-6 * g_max, name
        # one Prodigy step moves a leaf by ~1e-6: 1% of that plus 2 ulps of the parameter
        tol = 1e-2 * np.abs(jnew[name] - old[name]).max() + 2 * np.spacing(
            np.abs(old[name]).max())
        assert np.abs(p.detach().numpy() - jnew[name]).max() <= tol, name
        moved += bool(np.abs(jnew[name] - old[name]).max() > 0)
    assert all(np.abs(jflat[n]).max() > 0 for n in leaves
               if n.startswith("bg_basis.") and n != "bg_basis." + KEY_SHIFT)
    assert moved >= 4 + len(list(bg.parameters())) - 1


class _Recording:
    """Stands in for the JAX trainer's compiled steps: records each call's
    batch and moves nothing."""

    KEYS = ("skip_weights", "emb_noise_std", "emb_scale_perturb", "caption_ids", "subj_bi",
            "subj_pos", "bg_bi", "bg_pos", "clip_features")

    def __init__(self):
        self.calls = []

    def recon(self, use_bg, fgbg_reg):
        def step(state, fp, batch, key):
            self.calls.append(("recon_bg" if use_bg else "recon",
                               {k: np.asarray(batch[k]) for k in self.KEYS if k in batch}))
            zero = jnp.float32(0.0)
            return state, {"loss": zero, "loss_recon": zero, "grad_norm": zero}
        return step

    def distill(self, nd):
        def step(state, fp, batch, key):
            self.calls.append(("arc2face_distill", {"nd": nd, **{
                k: np.asarray(batch[k]) for k in ("skip_weights", "emb_noise_std")}}))
            zero = jnp.float32(0.0)
            return state, {"loss_arc2face_distill": zero, "grad_norm": zero}
        return step


class _DistillSteps(dict):
    def __init__(self, rec):
        super().__init__()
        self.rec = rec

    def __contains__(self, nd):
        return True

    def __getitem__(self, nd):
        return self.rec.distill(nd)


def test_trainer_bg_mixed_run_matches_jax(env, tmp_path):
    """arc2face_distill_iter_prob=0.5 and use_background_token_prob=0.9 over
    a tiny vision tower behind each package's zero-shot extractor: the same
    raw batches and seed give JAX's iteration types (all three), and on each
    step its host draws in its order, the captions' ids (caption_bg on
    recon_bg steps), the subject and background positions and the CLIP
    features [B, 2S, D]; the port's steps train (both generators and both
    global scales move), the stream after the run is JAX's, and a
    checkpoint carries bg_basis to the JAX package and back."""
    vcfg = dict(ch=32, ch_mult=(1, 2, 4), num_res_blocks=1)
    vt = reset_parameters(tvae.VAE(tvae.VAEConfig(**vcfg)), torch.Generator().manual_seed(9))
    cv = jcv.CLIPVisionConfig(**VISION)
    jvp = randomized(jcv.init_params(jax.random.PRNGKey(12), cv), 13)
    tv = port_module(tcv.CLIPVisionModel(tcv.CLIPVisionConfig(**VISION)), jvp)
    cfg = dict(max_steps=20, grad_accum=2, max_num_denoising_steps=3, ckpt_every=100,
               compute_dtype="float32", seed=1, metrics_flush_every=1,
               arc2face_distill_iter_prob=0.5)
    batches = lambda: ttrainer.synthetic_raw_batches(0, batch_size=4, size=32)
    rec = _Recording()
    jtr = jtrainer.AdaPromptTrainer(
        env["jfrozen"], jax.tree.map(jnp.asarray, module_tree(vt)), jvae.VAEConfig(**vcfg),
        env["jtok"], env["jscfg"], env["jsp"], batches(),
        jtrainer.TrainerConfig(out_dir=str(tmp_path / "jax"), **cfg), synthetic_faces=True,
        bg_basis_cfg=env["jbg"], bg_params=env["jbp"],
        zs_extractor=jzs.ZeroShotFeatureExtractor(jax.tree.map(jnp.asarray, jvp), cv),
        use_background_token_prob=0.9)
    jtr._distill_steps = _DistillSteps(rec)
    jtr._get_recon_step = rec.recon

    def port_trainer(out):
        bg = port_module(tsbg.SubjBasisGenerator(env["tbg"]),
                         jax.tree.map(np.asarray, env["jbp"])).train()
        sbg = port_module(tsbg.SubjBasisGenerator(env["tscfg"]), env["jsp"]).train()
        return ttrainer.AdaPromptTrainer(
            env["tfrozen"], vt, env["ttok"], env["tscfg"], sbg, batches(),
            ttrainer.TrainerConfig(out_dir=str(tmp_path / out), **cfg), synthetic_faces=True,
            bg_basis_cfg=env["tbg"], bg_params=bg, zs_extractor=tzs.ZeroShotFeatureExtractor(tv),
            use_background_token_prob=0.9)

    ttr = port_trainer("port")
    bg0 = {n: p.detach().clone() for n, p in ttr.state.params["bg_basis"].named_parameters()}
    seen = []
    real = ttr.prepare_recon_batch
    ttr.prepare_recon_batch = lambda *a, **k: seen.append(real(*a, **k)) or seen[-1]
    steps = 6
    rows = [ttr.train_step(i) for i in range(steps)]
    for i in range(steps):
        jtr.train_step(i)
    types = [r["iter_type"] for r in rows]
    assert types == [c[0] for c in rec.calls], types
    assert set(types) == {"recon", "recon_bg", "arc2face_distill"}, types
    for b, r, (ty, c) in zip(seen, rows, rec.calls):
        if ty == "arc2face_distill":
            assert r["num_denoising_steps"] == c.pop("nd")
        assert set(c) <= set(b) and ("clip_features" in b) == (ty == "recon_bg")
        for k, v in c.items():
            if k == "clip_features":
                assert tuple(b[k].shape) == v.shape == (4, 2 * S, VISION["hidden_size"])
                np.testing.assert_allclose(b[k].numpy(), v, rtol=0,
                                           atol=1e-5 * np.abs(v).max(), err_msg=k)
            else:
                np.testing.assert_allclose(b[k].numpy(), v, rtol=1e-6, err_msg=k)
        if ty == "recon_bg":
            assert (b["bg_pos"] >= b["subj_pos"] + 16).all()
            assert r["loss_bg_xlayer_consist"] > 0
    np.testing.assert_array_equal(jtr.rng.random(4), ttr.rng.random(4))   # same stream after
    for r in rows:
        assert np.isfinite(r["loss_arc2face_distill"] if r["iter_type"] == "arc2face_distill"
                           else r["loss"]) and r["grad_norm"] > 0
    moved = {n: not torch.equal(p, ttr.state.params["bg_basis"].get_parameter(n))
             for n, p in bg0.items() if n != KEY_SHIFT}
    assert all(moved.values()), moved
    assert ttr.state.params["emb_scales"].detach().abs().min() > 0

    path = ttr.save_checkpoint(steps)
    trees, meta = jckpt.load_checkpoint(path)
    assert set(trees) == {"subj_basis", "bg_basis", "emb_scales"}
    want = {k: v.numpy() for k, v in ttr.state.params["bg_basis"].state_dict().items()}
    got = named(trees["bg_basis"])
    assert set(got) == set(want) == set(named(env["jbp"]))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    ttr2 = port_trainer("port2")
    assert ttr2.load_checkpoint(path)["step"] == steps
    for k, v in ttr2.state.params["bg_basis"].state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k])
    np.testing.assert_array_equal(ttr2.state.params["emb_scales"].detach().numpy(),
                                  ttr.state.params["emb_scales"].detach().numpy())


def test_trainer_bg_needs_config_and_extractor(env, tmp_path):
    """bg_params without its config or without a zs_extractor is refused at
    construction, by name."""
    bg = tsbg.SubjBasisGenerator(env["tbg"])
    for kw in (dict(bg_basis_cfg=env["tbg"]), dict(zs_extractor=object())):
        with pytest.raises(ValueError, match="zs_extractor"):
            ttrainer.AdaPromptTrainer(env["tfrozen"], None, env["ttok"], env["tscfg"], None,
                                      iter(()), ttrainer.TrainerConfig(out_dir=str(tmp_path)),
                                      synthetic_faces=True, bg_params=bg, **kw)
