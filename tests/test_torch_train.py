"""Port Stage-1 training vs the JAX package on shared weights and shared
draws (tiny models, CPU, float32): the distillation step's loss, its
SubjBasisGenerator gradients and the parameters after the Prodigy update
(test_torch_trainer.py holds the teacher chain and the trainer).

The draws are made by jax.random from the step's key as the JAX step splits
it, and handed to the port's step, so both compute on the same numbers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaprompt_tpu.train import steps as jsteps, trainer as jtrainer
from adaprompt_tpu_torch.adaface import subj_basis_generator as tsbg
from adaprompt_tpu_torch.train import steps as tsteps, trainer as ttrainer
from torch_port_helpers import keeping_grads, named, port_module, t, train_env

LOSS_RTOL = 1e-5   # fp32, different summation orders through 2 CLIP + 2 UNets
GRAD_TOL = 1e-5    # of the leaf's largest gradient, plus 1e-6 of the tree's (for
                   # leaves whose gradient is zero up to rounding, e.g. the k biases)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return train_env(tmp_path_factory.mktemp("vocab"))


def _batch(seed, b=2):
    rng = np.random.default_rng(seed)
    fid = rng.standard_normal((b, 512)).astype(np.float32)
    fid /= np.linalg.norm(fid, axis=-1, keepdims=True)
    return {"z0": rng.standard_normal((b, 8, 8, 4)).astype(np.float32), "faceid": fid,
            "fg_mask": (rng.random((b, 8, 8, 1)) > 0.4).astype(np.float32),
            "aug_mask": (rng.random((b, 8, 8, 1)) > 0.2).astype(np.float32)}


def _jax_draws(key, z0_shape, nd):
    """The draws of steps.py's loss_fn and arc2face_teacher.py's chain."""
    k_t, k_noise, k_teacher, _ = jax.random.split(key, 4)
    b = z0_shape[0]
    draws = {"t": jax.random.randint(k_t, (b,), 0, 1000),
             "noise": jax.random.normal(k_noise, z0_shape, jnp.float32),
             "rels": [], "next_noises": []}
    k = k_teacher
    for _ in range(nd - 1):
        k, k1, k2 = jax.random.split(k, 3)
        draws["rels"].append(jax.random.uniform(k1, (b,), jnp.float32))
        draws["next_noises"].append(jax.random.normal(k2, z0_shape, jnp.float32))
    return {"t": torch.from_numpy(np.asarray(draws["t"])).long(), "noise": t(draws["noise"]),
            "rels": t(np.asarray(draws["rels"]).reshape(nd - 1, b)),
            "next_noises": t(np.asarray(draws["next_noises"]).reshape((nd - 1,) + z0_shape))}


def _port_sbg(env):
    return port_module(tsbg.SubjBasisGenerator(env["tscfg"]), env["jsp"]).train()


@pytest.mark.parametrize("nd", [1, 2])
def test_distill_step_matches_jax(env, nd):
    """Loss, every SubjBasisGenerator gradient, and the parameters after one
    clip -> Prodigy update, on shared weights and shared draws."""
    batch_np = _batch(nd)
    key = jax.random.PRNGKey(10 + nd)
    jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    trainable = {"subj_basis": env["jsp"], "emb_scales": jnp.zeros((2,), jnp.float32)}
    fp = jsteps.frozen_params(env["jfrozen"])
    jopt = keeping_grads(jtrainer.build_optimizer(
        jtrainer.TrainerConfig(grad_accum=1, max_steps=10, warm_up_steps=2)))
    step_j = jax.jit(jsteps.make_arc2face_distill_step(
        jopt, env["jfrozen"], env["jtok"], env["jscfg"], num_denoising_steps=nd,
        compute_dtype=jnp.float32, skip_weights=(1.0, 2.0, 2.0)))
    jstate, metrics = step_j(jsteps.create_train_state(trainable, jopt), fp, jbatch, key)
    jgrads = jstate.opt_state[1]

    sbg = _port_sbg(env)
    params = {"subj_basis": sbg, "emb_scales": torch.nn.Parameter(torch.zeros(2))}
    tstate = tsteps.TrainState(params, ttrainer.build_optimizer(
        ttrainer.TrainerConfig(grad_accum=1, max_steps=10, warm_up_steps=2),
        tsteps.trainable_parameters(params)))
    before = {n: p.detach().clone() for n, p in sbg.named_parameters()}
    grads = {}
    for n, p in sbg.named_parameters():
        p.register_hook(lambda g, n=n: grads.__setitem__(n, g.clone()))
    step = tsteps.make_arc2face_distill_step(env["tfrozen"], env["ttok"], env["tscfg"],
                                             num_denoising_steps=nd, compute_dtype=torch.float32,
                                             skip_weights=(1.0, 2.0, 2.0))
    tbatch = {k: t(v) for k, v in batch_np.items()}
    tstate, tm = step(tstate, tsteps.frozen_params(env["tfrozen"]), tbatch, None,
                      draws=_jax_draws(key, batch_np["z0"].shape, nd))

    loss_j = float(metrics["loss_arc2face_distill"])
    assert np.isfinite(loss_j) and loss_j > 0
    np.testing.assert_allclose(float(tm["loss_arc2face_distill"]), loss_j, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(metrics["grad_norm"]), rtol=1e-4)
    jflat = {k: np.asarray(v) for k, v in named(jgrads["subj_basis"]).items()}
    jnew = {k: np.asarray(v) for k, v in named(jstate.params["subj_basis"]).items()}
    old = named(env["jsp"])
    g_max = max(np.abs(g).max() for g in jflat.values())
    moved = 0
    for name, p in sbg.named_parameters():
        g_j = jflat[name]
        g_t = grads.get(name, torch.zeros_like(p)).numpy()
        assert np.abs(g_t - g_j).max() <= (GRAD_TOL * np.abs(g_j).max()
                                           + 1e-6 * g_max), name
        # after the update: one Prodigy step moves a leaf by ~1e-6; allow 1%
        # of that plus 2 float32 ulps of the parameter for the rounding of p + u
        new_t = p.detach().numpy()
        tol = 1e-2 * np.abs(jnew[name] - old[name]).max() + 2 * np.spacing(
            np.abs(old[name]).max())
        assert np.abs(new_t - jnew[name]).max() <= tol, name
        moved += bool(np.abs(jnew[name] - old[name]).max() > 0)
    assert moved >= 3
