"""Port Stage-1 training vs the JAX package (tiny models, CPU, float32):
the Arc2Face teacher chain with injected draws, and the trainer's host
behaviour (the numpy draws in JAX's order, ND, HALF_BS) and checkpoints."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaprompt_tpu.adaface import checkpoint as jckpt
from adaprompt_tpu.models import vae as jvae
from adaprompt_tpu.train import arc2face_teacher as jteacher, trainer as jtrainer
from adaprompt_tpu_torch.adaface import subj_basis_generator as tsbg
from adaprompt_tpu_torch.adaface.checkpoint import module_tree
from adaprompt_tpu_torch.models import vae as tvae
from adaprompt_tpu_torch.ops.layers import reset_parameters
from adaprompt_tpu_torch.train import arc2face_teacher as tteacher, trainer as ttrainer
from torch_port_helpers import HIDDEN, assert_close, named, port_module, t, train_env


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return train_env(tmp_path_factory.mktemp("vocab"))


def _port_sbg(env):
    return port_module(tsbg.SubjBasisGenerator(env["tscfg"]), env["jsp"]).train()


def test_teacher_chain_matches_jax(env):
    """ND=3 with the chain's uniform and normal draws injected."""
    rng = np.random.default_rng(3)
    z0 = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    noise = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 21, HIDDEN)).astype(np.float32)
    tt = np.asarray([800, 517])
    key = jax.random.PRNGKey(4)
    out_j = jteacher.teacher_denoise_chain(env["jfrozen"].teacher_unet, jnp.asarray(z0),
                                           jnp.asarray(noise), jnp.asarray(tt), jnp.asarray(ctx),
                                           key, num_denoising_steps=3, unet_cfg=env["ju"],
                                           compute_dtype=jnp.float32)
    rels, nxt, k = [], [], key
    for _ in range(2):
        k, k1, k2 = jax.random.split(k, 3)
        rels.append(np.asarray(jax.random.uniform(k1, (2,), jnp.float32)))
        nxt.append(np.asarray(jax.random.normal(k2, z0.shape, jnp.float32)))
    out_t = tteacher.teacher_denoise_chain(env["tfrozen"].teacher_unet, t(z0), t(noise),
                                           torch.from_numpy(tt), t(ctx), t(np.stack(rels)),
                                           t(np.stack(nxt)), num_denoising_steps=3,
                                           compute_dtype=torch.float32)
    for a_t, a_j in zip(out_t[3], out_j[3]):
        np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    for i in range(3):
        assert_close(out_t[0][i], out_j[0][i], atol=1e-4)     # noise preds, fp32
        assert_close(out_t[1][i], out_j[1][i], atol=1e-3)     # pred_x0: x 1/sqrt(acp)
        assert_close(out_t[2][i], out_j[2][i], atol=0)


class _RecordingSteps(dict):
    """Stands in for the JAX trainer's compiled steps: records each call's
    batch and moves nothing."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __contains__(self, nd):
        return True

    def __getitem__(self, nd):
        def step(state, fp, batch, key):
            self.calls.append((nd, int(batch["z0"].shape[0]),
                               np.asarray(batch["skip_weights"])))
            zero = jnp.float32(0.0)
            return state, {"loss_arc2face_distill": zero, "grad_norm": zero}
        return step


def test_trainer_host_behaviour_and_checkpoint_match_jax(env, tmp_path):
    """Same raw batches and seed: the ND sequence, HALF_BS sizes and the
    Dirichlet clip-skip draws agree with the JAX trainer's; an .npz written
    by the port is read by the JAX package's load_checkpoint."""
    vcfg = dict(ch=32, ch_mult=(1, 2, 4), num_res_blocks=1)
    vt = reset_parameters(tvae.VAE(tvae.VAEConfig(**vcfg)), torch.Generator().manual_seed(9))
    cfg = dict(max_steps=20, grad_accum=2, max_num_denoising_steps=3, ckpt_every=100,
               compute_dtype="float32", seed=3, metrics_flush_every=2)
    batches = lambda: ttrainer.synthetic_raw_batches(0, batch_size=4, size=32)
    jtr = jtrainer.AdaPromptTrainer(
        env["jfrozen"], jax.tree.map(jnp.asarray, module_tree(vt)), jvae.VAEConfig(**vcfg),
        env["jtok"], env["jscfg"], env["jsp"], batches(),
        jtrainer.TrainerConfig(out_dir=str(tmp_path / "jax"), **cfg), synthetic_faces=True)
    jtr._distill_steps = _RecordingSteps()
    port_trainer = lambda out: ttrainer.AdaPromptTrainer(
        env["tfrozen"], vt, env["ttok"], env["tscfg"], _port_sbg(env), batches(),
        ttrainer.TrainerConfig(out_dir=str(tmp_path / out), **cfg), synthetic_faces=True)
    ttr = port_trainer("port")
    seen = []
    real = ttr.prepare_recon_batch
    ttr.prepare_recon_batch = lambda *a, **k: seen.append(real(*a, **k)) or seen[-1]
    steps = 6
    rows = [ttr.train_step(i) for i in range(steps)]
    for i in range(steps):
        jtr.train_step(i)
    nds = [r["num_denoising_steps"] for r in rows]
    assert nds == [c[0] for c in jtr._distill_steps.calls]
    assert [r["distill_bs"] for r in rows] == [c[1] for c in jtr._distill_steps.calls]
    assert [r["distill_bs"] for r in rows] == [-(-4 // nd) for nd in nds]
    assert len(set(nds)) > 1, nds
    for b, c in zip(seen, jtr._distill_steps.calls):
        np.testing.assert_allclose(b["skip_weights"].numpy(), c[2], rtol=1e-6)
    np.testing.assert_array_equal(jtr.rng.random(4), ttr.rng.random(4))   # same stream after

    path = ttr.save_checkpoint(steps)
    lines = [json.loads(ln) for ln in open(tmp_path / "port" / "metrics.jsonl")]
    assert [ln["step"] for ln in lines] == list(range(steps))
    assert all(np.isfinite(ln["loss_arc2face_distill"]) and ln["grad_norm"] > 0 for ln in lines)
    trees, meta = jckpt.load_checkpoint(path)
    assert meta == {"step": steps, "placeholder": "z"}
    want = {k: v.numpy() for k, v in ttr.state.params["subj_basis"].state_dict().items()}
    got = named(trees["subj_basis"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # the parameters moved after the accumulated updates, and load restores them
    assert not np.array_equal(want["hidden_state_layer_weights"],
                              named(env["jsp"])["hidden_state_layer_weights"])
    ttr2 = port_trainer("port2")
    assert ttr2.load_checkpoint(path)["step"] == steps
    for k, v in ttr2.state.params["subj_basis"].state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k])
