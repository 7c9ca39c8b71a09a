"""The port's compositional phases vs the JAX package's (tiny Stage-1
models, a tiny VAE, CPU, float32, shared weights): the filter phase
(x_recon and the decoded images of a fresh iteration's two candidates and
a reuse iteration's one row) against make_filter_phase, and the
with-gradient compositional phase against make_compos_train_phase, both
trainers' context_fn on the same 4-type batch and the same draws (the
embedding noise that JAX draws from its noise_key injected): every metric,
each trainable leaf's gradient, the parameters after one clip -> Prodigy
update, x_recon and the q BatchNorm statistics. This is where the UNet's
capture with a separate layerwise context_k is held against JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaprompt_tpu.models import vae as jvae
from adaprompt_tpu.train import compos_step as jcs, steps as jsteps, trainer as jtrainer
from adaprompt_tpu_torch.adaface import subj_basis_generator as tsbg
from adaprompt_tpu_torch.adaface.checkpoint import module_tree
from adaprompt_tpu_torch.models import vae as tvae
from adaprompt_tpu_torch.ops.layers import reset_parameters
from adaprompt_tpu_torch.train import compos_step as tcs, trainer as ttrainer
from torch_port_helpers import HIDDEN, keeping_grads, named, port_module, t, train_env

PHASE_TOL = 1e-4     # fp32 through the UNet and VAE: of the array's largest entry
LOSS_RTOL = 1e-4     # the phase's loss terms, through two CLIPs and a capturing UNet
GRAD_TOL = 1e-4      # of the leaf's largest gradient, plus 1e-6 of the tree's
VAE_CFG = dict(ch=32, ch_mult=(1, 2, 4), num_res_blocks=1)
METRICS = ("loss_compos", "loss_mix_prompt_distill", "loss_prompt_emb_delta",
           "loss_fg_xlayer_consist", "loss_bg_xlayer_consist", "loss_comp_fg_bg_preserve")


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    e = train_env(tmp_path_factory.mktemp("vocab"))
    vt = reset_parameters(tvae.VAE(tvae.VAEConfig(**VAE_CFG)), torch.Generator().manual_seed(9))
    return dict(e, tvae=vt.eval(), jvae=jax.tree.map(jnp.asarray, module_tree(vt)))


def _close(got, want, tol=PHASE_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
                               want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("n_cand", [2, 1], ids=["fresh", "reuse"])
def test_filter_phase_matches_jax(env, n_cand):
    """One no-gradient denoise of 2N rows with separate V and K contexts
    over the 16 layers, decoded: x_recon and the images. N = 2 is a fresh
    iteration's candidates, N = 1 a reuse iteration's one cached row. JAX's
    phase is given no unconditional context, as its trainer gives it none."""
    rows = 2 * n_cand
    rng = np.random.default_rng(0)
    ctx_v = rng.standard_normal((16, rows, 77, HIDDEN)).astype(np.float32)
    ctx_k = rng.standard_normal((16, rows, 77, HIDDEN)).astype(np.float32)
    x0 = rng.standard_normal((rows, 8, 8, 4)).astype(np.float32)
    noise = rng.standard_normal((rows, 8, 8, 4)).astype(np.float32)
    tt = np.asarray([900, 850] * n_cand)
    models = jcs.ComposModels(unet_cfg=env["ju"], vae_cfg=jvae.VAEConfig(**VAE_CFG))
    jphase = jcs.make_filter_phase(models, cfg_scale=5.0, compute_dtype=jnp.float32)
    xr_j, img_j = jphase({"unet": env["jfrozen"].unet, "vae": env["jvae"]}, jnp.asarray(ctx_v),
                         jnp.asarray(ctx_k), None, jnp.asarray(x0), jnp.asarray(tt),
                         jnp.asarray(noise))
    tphase = tcs.make_filter_phase(compute_dtype=torch.float32)
    xr_t, img_t = tphase({"unet": env["tfrozen"].unet, "vae": env["tvae"]}, t(ctx_v), t(ctx_k),
                         t(x0), torch.from_numpy(tt), t(noise))
    assert tuple(img_t.shape) == img_j.shape == (rows, 32, 32, 3)
    _close(xr_t, xr_j)
    _close(img_t, img_j)
    assert not xr_t.requires_grad and not img_t.requires_grad


def _trainers(env, tmp_path):
    """Stage-2 trainers of both packages over the same models (no teacher
    filter, one update a step), the JAX one's optimizer keeping its
    gradients."""
    cfg = dict(compute_dtype="float32", seed=4, grad_accum=1, max_steps=10, warm_up_steps=2,
               no_teacher_filter=True, metrics_flush_every=1)
    jtr = jtrainer.AdaPromptTrainer(
        env["jfrozen"], env["jvae"], jvae.VAEConfig(**VAE_CFG), env["jtok"], env["jscfg"],
        env["jsp"], iter(()), jtrainer.TrainerConfig.stage2(out_dir=str(tmp_path / "jax"), **cfg),
        synthetic_faces=True)
    jtr.optimizer = keeping_grads(jtr.optimizer)
    jtr.state = jsteps.create_train_state(jtr.state.params, jtr.optimizer)
    sbg = port_module(tsbg.SubjBasisGenerator(env["tscfg"]), env["jsp"]).train()
    ttr = ttrainer.AdaPromptTrainer(
        env["tfrozen"], env["tvae"], env["ttok"], env["tscfg"], sbg, iter(()),
        ttrainer.TrainerConfig.stage2(out_dir=str(tmp_path / "port"), **cfg),
        synthetic_faces=True)
    return jtr, ttr


@pytest.mark.parametrize("normalize_outfeat", [0.0, 1.0], ids=["plain", "layernorm"])
def test_compos_phase_matches_jax(env, tmp_path, normalize_outfeat):
    """Both trainers' compositional phase on one 4-type batch (made by each
    trainer's prepare_compos_batch from the same raw batch and seed, checked
    equal), four different t, the embedding noise on: every metric, the
    gradient norm, each trainable leaf's gradient (emb_scales included), the
    parameters after the update, x_recon and the q BatchNorm statistics."""
    jtr, ttr = _trainers(env, tmp_path)
    raw = next(ttrainer.synthetic_raw_batches(0, batch_size=2, size=32))
    cj, ct = jtr.prepare_compos_batch(raw), ttr.prepare_compos_batch(raw)
    for k in ("z0", "ids4", "subj_rows", "subj_pos4", "cls_pos", "faceid", "fg_mask",
              "skip_weights"):
        _close(ct[k].float(), cj[k], tol=1e-6)
    assert ct["subj_pos_host"] == cj["subj_pos_host"] and len(ct["subj_pos_host"]) == 16
    assert ct["cls_comp_prompt"] == cj["cls_comp_prompt"]
    assert ct["subject_name"] == cj["subject_name"]

    rng = np.random.default_rng(1)
    x0 = rng.standard_normal((4, 8, 8, 4)).astype(np.float32)
    noise = rng.standard_normal((4, 8, 8, 4)).astype(np.float32)
    tt = np.asarray([690, 610, 520, 450])
    key = jax.random.PRNGKey(5)
    scfg = env["jscfg"]
    emb_noise = jax.random.normal(key, (1, scfg.num_out_layers, scfg.num_out_embs_per_layer,
                                        scfg.output_dim), jnp.float32)
    extra = {"emb_noise_std": np.float32(0.03), "emb_scale_perturb": np.asarray([1.2, 0.9],
                                                                               np.float32),
             "normalize_outfeat": np.float32(normalize_outfeat),
             "training_percent": np.float32(0.3)}
    keys = ("fg_mask", "faceid", "ids4", "subj_rows", "subj_pos4", "cls_pos", "skip_weights")
    jbatch = dict({k: cj[k] for k in keys}, x_start=jnp.asarray(x0), t=jnp.asarray(tt),
                  noise=jnp.asarray(noise), subj_pos_host=tuple(cj["subj_pos_host"]),
                  noise_key=key, **{k: jnp.asarray(v) for k, v in extra.items()})
    tbatch = dict({k: ct[k] for k in keys}, x_start=t(x0), t=torch.from_numpy(tt),
                  noise=t(noise), subj_pos_host=tuple(ct["subj_pos_host"]),
                  **{k: torch.tensor(v) for k, v in extra.items()})

    jtr._ensure_compos()
    old_j = jtr.state.params
    jstate, jm, xr_j = jtr._compos_phase(jtr.state, jtr._mp_compos(), jbatch,
                                         jax.random.PRNGKey(0))
    jgrads = jstate.opt_state[1]

    ttr._ensure_compos()
    params = ttr.state.params
    leaves = dict(params["subj_basis"].named_parameters(), emb_scales=params["emb_scales"])
    grads = {}
    for n, p in leaves.items():
        p.register_hook(lambda g, n=n: grads.__setitem__(n, g.clone()))
    _, tm, xr_t = ttr._compos_phase(ttr.state, ttr._mp_compos(), tbatch, None,
                                    draws={"emb_noise": t(emb_noise)})

    for name in METRICS:
        np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=LOSS_RTOL, atol=1e-9,
                                   err_msg=name)
        assert np.isfinite(float(tm[name]))
    assert float(jm["loss_mix_prompt_distill"]) > 0 and float(jm["loss_comp_fg_bg_preserve"]) > 0
    assert float(jm["loss_prompt_emb_delta"]) > 0 and float(jm["loss_fg_xlayer_consist"]) > 0
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    _close(xr_t, xr_j)
    stats_j, stats_t = jm["q_bn_stats"], tm["q_bn_stats"]
    assert sorted(stats_t) == sorted(stats_j) == [7, 8]
    for li in stats_j:
        for a, b in zip(stats_t[li], stats_j[li]):
            _close(a, b)

    jflat = {k: np.asarray(v) for k, v in named(jgrads["subj_basis"]).items()}
    jflat["emb_scales"] = np.asarray(jgrads["emb_scales"])
    jnew = {k: np.asarray(v) for k, v in named(jstate.params["subj_basis"]).items()}
    jnew["emb_scales"] = np.asarray(jstate.params["emb_scales"])
    old = dict(named(old_j["subj_basis"]), emb_scales=np.asarray(old_j["emb_scales"]))
    assert np.abs(jflat["emb_scales"]).max() > 0
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
    assert moved >= 4
