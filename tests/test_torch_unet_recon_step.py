"""The port's full-UNet reconstruction step (`train/steps.py`:
`create_train_state`, `masked_recon_loss`, `make_recon_step`) against the
JAX package's on a tiny UNet holding the same weights (CPU, float32), with
JAX's draws (the key's split, randint and normal) handed to the port:

  * default mode, the UNet's own weights trained: the loss, the gradient
    norm and every UNet weight's gradient against `make_recon_step`, with
    the fg and aug masks and without; the weights after one AdamW update
    against `optax.adamw` applied to the same gradients (Adam's first step
    moves each weight by ~lr * sign(g), so a gradient element near zero
    that differs in its last bits would flip its move: the update is held
    on the port's gradients, the gradients on JAX's);
  * context mode, a context made by a trainable embedding table through
    `context_fn` against the frozen UNet. JAX's `make_recon_step` takes
    `context_fn` and never calls it (its loss reads batch['context'] and
    differentiates the UNet's weights), so the JAX side is its step's own
    loss (q_sample, the UNet forward with the aug mask as key mask,
    masked_recon_loss) on that context, differentiated by jax.grad; its
    loss is also held against JAX's step run on the made context.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adaprompt_tpu.models import unet as junet
from adaprompt_tpu.sampling.schedule import SD15_SCHEDULE, q_sample
from adaprompt_tpu.train import steps as jsteps
from adaprompt_tpu_torch.adaface.checkpoint import module_tree
from adaprompt_tpu_torch.models import unet as tunet
from adaprompt_tpu_torch.ops.layers import reset_parameters
from adaprompt_tpu_torch.train import prodigy as tprodigy, steps as tsteps
from torch_port_helpers import keeping_grads, named, port_module, randomized, within
from torch_port_helpers import torch_threads  # noqa: F401

LOSS_RTOL = 1e-5    # fp32, different summation orders through a UNet
GRAD_TOL = 1e-5     # of the leaf's largest gradient, plus 1e-6 of the tree's
PARAM_RTOL = 1e-6   # the weights after one AdamW update, against optax.adamw
LR = 1e-4
UNET = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1, attention_ds=(1, 2),
            num_heads=4, context_dim=64)
B, HW, L, S = 2, 8, 2, 7


@pytest.fixture(scope="module")
def unets():
    """(JAX UNet tree, its numpy copy): the port's random init in the JAX
    layout, every zero leaf re-randomized."""
    tree = randomized(module_tree(reset_parameters(
        tunet.UNet(tunet.UNetConfig(**UNET)), torch.Generator().manual_seed(0))), 1)
    return jax.tree.map(jnp.asarray, tree), tree


@pytest.fixture(scope="module")
def jax_step():
    """JAX's make_recon_step under adamw (keeping its gradients), jitted once
    for the module: the context test's run of it reuses the compilation."""
    jtx, _ = _adamw()
    jopt = keeping_grads(jtx)
    return jopt, jax.jit(jsteps.make_recon_step(
        jopt, junet.UNetConfig(**UNET, use_checkpoint=False), compute_dtype=jnp.float32))


def _batch(seed, masks):
    rng = np.random.default_rng(seed)
    batch = {"z0": rng.standard_normal((B, HW, HW, 4)).astype(np.float32),
             "context": rng.standard_normal((L, B, S, UNET["context_dim"])).astype(np.float32)}
    if masks:
        batch["fg_mask"] = (rng.random((B, HW, HW, 1)) > 0.4).astype(np.float32)
        batch["aug_mask"] = (rng.random((B, HW, HW, 1)) > 0.2).astype(np.float32)
    return batch


def _jax_draws(key):
    """The draws of make_recon_step's loss_fn."""
    kt, kn = jax.random.split(key)
    return {"t": jax.random.randint(kt, (B,), 0, 1000),
            "noise": jax.random.normal(kn, (B, HW, HW, 4), jnp.float32)}


def _torch_draws(d):
    return {"t": torch.from_numpy(np.array(d["t"])).long(),
            "noise": torch.from_numpy(np.array(d["noise"]))}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _adamw():
    """optax.adamw and the port's AdamW behind a non-clipping pipeline."""
    return (optax.adamw(LR, b1=0.9, b2=0.993, weight_decay=1e-4),
            lambda ps: tprodigy.GradientPipeline(
                tprodigy.AdamW(ps, lr=LR, betas=(0.9, 0.993), weight_decay=1e-4), float("inf")))


def _check_leaves(leaves, grads, jgrads, old):
    """Each leaf's gradient within GRAD_TOL of JAX's, its value after the
    update within PARAM_RTOL of optax.adamw's step from `old` on the same
    gradients; returns how many moved."""
    g_max = max(np.abs(g).max() for g in jgrads.values())
    jtx, _ = _adamw()
    p0 = {n: jnp.asarray(v) for n, v in old.items()}
    g = {n: jnp.asarray(grads[n].numpy()) for n in leaves}
    upd, _ = jtx.update(g, jtx.init(p0), p0)
    want = {n: np.asarray(v) for n, v in optax.apply_updates(p0, upd).items()}
    moved = 0
    for name, p in leaves.items():
        g_j, g_t = jgrads[name], grads[name].numpy()
        within(np.abs(g_t - g_j).max(), GRAD_TOL * np.abs(g_j).max() + 1e-6 * g_max, name)
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=PARAM_RTOL, atol=0,
                                   err_msg=name)
        moved += bool(np.abs(p.detach().numpy() - old[name]).max() > 0)
    return moved


@pytest.mark.parametrize("masks", [True, False], ids=["masks", "nomask"])
def test_unet_recon_step_matches_jax(unets, jax_step, masks):
    """Default mode: the loss, the gradient norm, every UNet gradient and
    the weights after one AdamW update."""
    jtree, np_tree = unets
    batch = _batch(3, masks)
    key = jax.random.PRNGKey(7)
    _, ttx = _adamw()
    jopt, step_j = jax_step
    jstate, jm = step_j(jsteps.create_train_state(jtree, jopt),
                        {k: jnp.asarray(v) for k, v in batch.items()}, key)
    jgrads = named(jstate.opt_state[1])

    unet = port_module(tunet.UNet(tunet.UNetConfig(**UNET)), np_tree)
    assert not any(p.requires_grad for p in unet.parameters())
    state = tsteps.create_train_state({"unet": unet}, ttx)
    assert all(p.requires_grad for p in unet.parameters())
    leaves = dict(unet.named_parameters())
    grads = {}
    for n, p in leaves.items():
        p.register_hook(lambda g, n=n: grads.__setitem__(n, g.clone()))
    step = tsteps.make_recon_step(compute_dtype=torch.float32)
    state, tm = step(state, _tbatch(batch), None, draws=_torch_draws(_jax_draws(key)))
    assert set(tm) == set(jm) == {"loss_recon", "grad_norm"} and state.step == 1
    assert float(jm["loss_recon"]) > 0
    np.testing.assert_allclose(float(tm["loss_recon"]), float(jm["loss_recon"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert set(grads) == set(jgrads) == set(leaves)
    assert _check_leaves(leaves, grads, jgrads, named(np_tree)) == len(leaves)


def test_masked_recon_loss_matches_jax():
    rng = np.random.default_rng(4)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    pred, eps = f(B, HW, HW, 4), f(B, HW, HW, 4)
    fg = (rng.random((B, HW, HW, 1)) > 0.5).astype(np.float32)
    aug = (rng.random((B, HW, HW, 1)) > 0.3).astype(np.float32)
    for m_fg, m_aug, w in ((fg, aug, 0.1), (None, aug, 0.1), (fg, None, 0.5), (None, None, 0.1)):
        want = jsteps.masked_recon_loss(jnp.asarray(pred), jnp.asarray(eps),
                                        None if m_fg is None else jnp.asarray(m_fg),
                                        None if m_aug is None else jnp.asarray(m_aug), w)
        got = tsteps.masked_recon_loss(torch.from_numpy(pred), torch.from_numpy(eps),
                                       None if m_fg is None else torch.from_numpy(m_fg),
                                       None if m_aug is None else torch.from_numpy(m_aug), w)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _emb_table(seed):
    return np.random.default_rng(seed).standard_normal(
        (L, S, UNET["context_dim"])).astype(np.float32)


@pytest.mark.parametrize("masks", [True, False], ids=["masks", "nomask"])
def test_context_fn_step_matches_jax(unets, jax_step, masks):
    """Context mode: a trainable [L, S, D] table, scaled per sample by the
    batch's 'ctx_scale', makes the context of the frozen UNet. The loss,
    the gradient norm, the table's gradient against jax.grad and its value
    after one AdamW update; the UNet's weights untouched."""
    jtree, np_tree = unets
    batch = _batch(5, masks)
    batch["ctx_scale"] = np.asarray([0.7, 1.3], np.float32)
    table0 = _emb_table(6)
    key = jax.random.PRNGKey(9)
    draws = _jax_draws(key)
    jcfg = junet.UNetConfig(**UNET, use_checkpoint=False)

    def jctx(p, b):
        return p["emb"][:, None] * b["ctx_scale"][None, :, None, None]

    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        z_t = q_sample(SD15_SCHEDULE, jb["z0"], draws["t"], draws["noise"])
        eps_pred = junet.forward(jtree, z_t, draws["t"], jctx(p, jb), img_mask=jb.get("aug_mask"),
                                 cfg=jcfg)
        return jsteps.masked_recon_loss(eps_pred, draws["noise"], jb.get("fg_mask"),
                                        jb.get("aug_mask"))

    jp = {"emb": jnp.asarray(table0)}
    loss_j, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    _, ttx = _adamw()
    # JAX's own step on the made context gives the same loss
    jopt, step_j = jax_step
    _, jm = step_j(jsteps.create_train_state(jtree, jopt),
                   dict({k: v for k, v in jb.items() if k != "ctx_scale"}, context=jctx(jp, jb)),
                   key)
    np.testing.assert_allclose(float(jm["loss_recon"]), float(loss_j), rtol=LOSS_RTOL)

    unet = port_module(tunet.UNet(tunet.UNetConfig(**UNET)), np_tree)
    before = {n: p.detach().clone() for n, p in unet.named_parameters()}
    table = torch.nn.Parameter(torch.from_numpy(table0.copy()))
    state = tsteps.create_train_state({"emb": table}, ttx)
    grads = {}
    table.register_hook(lambda g: grads.__setitem__("emb", g.clone()))
    step = tsteps.make_recon_step(compute_dtype=torch.float32, context_fn=lambda p, b: (
        p["emb"][:, None] * b["ctx_scale"][None, :, None, None]))
    tb = _tbatch({k: v for k, v in batch.items() if k != "context"})
    state, tm = step(state, dict(tb, unet=unet), None, draws=_torch_draws(draws))
    np.testing.assert_allclose(float(tm["loss_recon"]), float(loss_j), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(optax.global_norm(jg)), rtol=1e-4)
    assert _check_leaves({"emb": table}, grads, {"emb": np.asarray(jg["emb"])},
                         {"emb": table0}) == 1
    assert not any(p.requires_grad for p in unet.parameters())
    assert all(torch.equal(p, before[n]) for n, p in unet.named_parameters())
