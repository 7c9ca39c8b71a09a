"""The port's zero-shot recon step vs the JAX package's make_zs_recon_step on
shared weights and shared draws (tiny Stage-1 models, CPU, float32): every
loss term, the gradient norm, every trainable leaf's gradient (the
SubjBasisGenerator's and emb_scales') and the parameters after one
clip -> Prodigy update; with and without the fg/bg regularizers and with
subject conv-attention.

The draws are made by jax.random from the step's key as the JAX step splits
it (timesteps, noise, the embedding noise) and handed to the port's step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaprompt_tpu.adaface import conditioner as jcond
from adaprompt_tpu.train import steps as jsteps, trainer as jtrainer
from adaprompt_tpu_torch.adaface import conditioner as tcond
from adaprompt_tpu_torch.adaface import subj_basis_generator as tsbg
from adaprompt_tpu_torch.train import steps as tsteps, trainer as ttrainer
from torch_port_helpers import HIDDEN, keeping_grads, named, port_module, t, train_env, within
from torch_port_helpers import torch_threads  # noqa: F401

# torch_threads' count here: at one intra-op thread the CPU's reductions sum in
# an order that puts one element of these fp32 comparisons just past its
# bound (as they do without the fixture under OMP_NUM_THREADS=1); from two
# threads up they pass
TORCH_THREADS = 2

LOSS_RTOL = 1e-5    # fp32, different summation orders through 2 CLIPs and a UNet
REG_ATOL = 1e-9     # the regularizer terms are ~1e-2..1 before their 1e-4 weights
GRAD_TOL = 1e-5     # of the leaf's largest gradient, plus 1e-6 of the tree's
CAPTIONS = ["a photo of a z person", "a z in the park"]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return train_env(tmp_path_factory.mktemp("vocab"))


def _batch(env, seed, b=2):
    rng = np.random.default_rng(seed)
    ids = np.asarray(env["jtok"](CAPTIONS))
    np.testing.assert_array_equal(ids, np.asarray(env["ttok"](CAPTIONS)))
    spec = jcond.make_placeholders(env["jtok"], ("z",), ("y",))[0]
    tspec = tcond.make_placeholders(env["ttok"], ("z",), ("y",))[0]
    assert spec.token_id == tspec.token_id
    bi, pos = jcond.find_placeholder_indices(ids, spec)
    assert list(bi) == [0, 1] and list(pos) == [5, 2]
    fid = rng.standard_normal((b, 512)).astype(np.float32)
    fid /= np.linalg.norm(fid, axis=-1, keepdims=True)
    return {"z0": rng.standard_normal((b, 8, 8, 4)).astype(np.float32), "faceid": fid,
            "caption_ids": ids.astype(np.int32), "subj_bi": bi, "subj_pos": pos,
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


@pytest.mark.parametrize("fgbg_reg,conv_ks", [(False, 0), (True, 0), (True, 3), (False, 4)],
                         ids=["plain", "fgbg", "fgbg-conv3", "conv4"])
def test_recon_step_matches_jax(env, fgbg_reg, conv_ks):
    """Loss terms, gradient norm, every trainable gradient (emb_scales
    included) and the parameters after one clip -> Prodigy update."""
    batch_np = _batch(env, 3)
    key = jax.random.PRNGKey(20 + conv_ks)
    scores0 = np.asarray([0.3, -0.2], np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    trainable = {"subj_basis": env["jsp"], "emb_scales": jnp.asarray(scores0)}
    jopt = keeping_grads(jtrainer.build_optimizer(
        jtrainer.TrainerConfig(grad_accum=1, max_steps=10, warm_up_steps=2)))
    step_j = jax.jit(jtrainer.make_zs_recon_step(
        jopt, env["jfrozen"], env["jtok"], env["jscfg"], fgbg_reg=fgbg_reg,
        compute_dtype=jnp.float32, conv_attn_kernel_size=conv_ks))
    jstate, metrics = step_j(jsteps.create_train_state(trainable, jopt),
                             jsteps.frozen_params(env["jfrozen"]), jbatch, key)
    jgrads = jstate.opt_state[1]

    sbg = port_module(tsbg.SubjBasisGenerator(env["tscfg"]), env["jsp"]).train()
    params = {"subj_basis": sbg, "emb_scales": torch.nn.Parameter(t(scores0))}
    tstate = tsteps.TrainState(params, ttrainer.build_optimizer(
        ttrainer.TrainerConfig(grad_accum=1, max_steps=10, warm_up_steps=2),
        tsteps.trainable_parameters(params)))
    leaves = dict(sbg.named_parameters(), emb_scales=params["emb_scales"])
    grads = {}
    for n, p in leaves.items():
        p.register_hook(lambda g, n=n: grads.__setitem__(n, g.clone()))
    step = tsteps.make_zs_recon_step(env["tfrozen"], env["ttok"], env["tscfg"],
                                     fgbg_reg=fgbg_reg, compute_dtype=torch.float32,
                                     conv_attn_kernel_size=conv_ks)
    tbatch = {k: (torch.from_numpy(np.asarray(v)).long() if k in ("caption_ids", "subj_bi",
                                                                   "subj_pos")
                  else t(v)) for k, v in batch_np.items()}
    tstate, tm = step(tstate, tsteps.frozen_params(env["tfrozen"]), tbatch, None,
                      draws=_jax_draws(key, 2, env["jscfg"]))

    want_keys = {"loss", "loss_recon", "grad_norm"}
    if fgbg_reg:
        want_keys |= {"loss_fg_bg_complementary", "loss_subj_mb_suppress", "loss_bg_mf_suppress",
                      "loss_fg_bg_mask_contrast", "loss_fg_xlayer_consist",
                      "loss_bg_xlayer_consist"}
    assert set(tm) == set(metrics) == want_keys
    assert float(metrics["loss_recon"]) > 0
    if fgbg_reg:
        assert float(metrics["loss_fg_xlayer_consist"]) > 0
        assert float(metrics["loss_subj_mb_suppress"]) > 0
    for name in want_keys - {"grad_norm"}:
        np.testing.assert_allclose(float(tm[name]), float(metrics[name]), rtol=LOSS_RTOL,
                                   atol=REG_ATOL, err_msg=name)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(metrics["grad_norm"]), rtol=1e-4)

    jflat = {k: np.asarray(v) for k, v in named(jgrads["subj_basis"]).items()}
    jflat["emb_scales"] = np.asarray(jgrads["emb_scales"])
    jnew = {k: np.asarray(v) for k, v in named(jstate.params["subj_basis"]).items()}
    jnew["emb_scales"] = np.asarray(jstate.params["emb_scales"])
    old = dict(named(env["jsp"]), emb_scales=scores0)
    assert np.abs(jflat["emb_scales"]).max() > 0            # emb_scales is trained here
    g_max = max(np.abs(g).max() for g in jflat.values())
    moved = 0
    for name, p in leaves.items():
        g_j = jflat[name]
        g_t = grads.get(name, torch.zeros_like(p)).numpy()
        within(np.abs(g_t - g_j).max(), GRAD_TOL * np.abs(g_j).max() + 1e-6 * g_max, name)
        # one Prodigy step moves a leaf by ~1e-6: 1% of that plus 2 ulps of the parameter
        tol = 1e-2 * np.abs(jnew[name] - old[name]).max() + 2 * np.spacing(
            np.abs(old[name]).max())
        within(np.abs(p.detach().numpy() - jnew[name]).max(), tol, name)
        moved += bool(np.abs(jnew[name] - old[name]).max() > 0)
    assert moved >= 4


def test_apply_emb_scale_matches_jax():
    """sigmoid(score) + 0.5, times the perturbation when the batch has one."""
    rng = np.random.default_rng(4)
    embs = rng.standard_normal((2, 1, 3, HIDDEN)).astype(np.float32)
    scores = np.asarray([0.7, -1.1], np.float32)
    for pert in (None, np.asarray([1.3, 0.85], np.float32)):
        batch_j = {} if pert is None else {"emb_scale_perturb": jnp.asarray(pert)}
        batch_t = {} if pert is None else {"emb_scale_perturb": t(pert)}
        for index in (0, 1):
            want = jtrainer.apply_emb_scale(jnp.asarray(embs), {"emb_scales": jnp.asarray(scores)},
                                            batch_j, index)
            got = tsteps.apply_emb_scale(t(embs), {"emb_scales": t(scores)}, batch_t, index)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    e = t(embs)
    assert tsteps.apply_emb_scale(e, {}, {}, 0) is e          # no scores: unscaled
