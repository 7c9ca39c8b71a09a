"""Port Stage-1 training vs the JAX package (tiny models, CPU, float32):
the Arc2Face teacher chain with injected draws, and the trainer's host
behaviour (the numpy draws in JAX's order, ND, HALF_BS, face ids), its
config and refusals, and checkpoints."""

import dataclasses
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
from torch_port_helpers import torch_threads  # noqa: F401


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


def test_trainer_config_matches_jax():
    """The port's TrainerConfig has the JAX one's fields, in its order and
    with its defaults; one keyword set builds equal configs in both packages,
    and the Stage-2 presets agree."""
    fields = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert fields(ttrainer.TrainerConfig) == fields(jtrainer.TrainerConfig)
    kw = dict(base_lr=1e-4, num_candidate_teachers=3, fgbg_reg=False, use_conv_attn_kernel_size=1,
              no_teacher_filter=True, ema_decay=0.99, seed=5, max_num_denoising_steps=3)
    assert (dataclasses.asdict(ttrainer.TrainerConfig(**kw))
            == dataclasses.asdict(jtrainer.TrainerConfig(**kw)))
    assert (dataclasses.asdict(ttrainer.TrainerConfig.stage2(seed=2))
            == dataclasses.asdict(jtrainer.TrainerConfig.stage2(seed=2)))


@pytest.mark.parametrize("kw,embedder,error,words", [
    (dict(composition_regs_iter_gap=3), None, ValueError, "no_teacher_filter=True"),
    (dict(), None, ValueError, "no face_embedder"),
    (dict(composition_regs_iter_gap=3, no_teacher_filter=True, use_ema=True), True, None, "ema"),
    (dict(optimizer_type="AdamW"), True, None, "AdamW"),
    (dict(optimizer_type="SGD"), True, ValueError, "SGD"),
])
def test_trainer_refusals(env, tmp_path, kw, embedder, error, words):
    """What the port refuses at construction: the JAX trainer's own
    ValueErrors, with its messages (compositional training without a teacher
    filter, no face embedder, an optimizer other than Prodigy and AdamW);
    and what it builds since the trainer's state is ported (EMA, also under
    the compositional iterations, and the AdamW optimizer), where only
    `distribute` still raises."""
    cfg = dict(out_dir=str(tmp_path), **kw)
    face = _StubEmbedder() if embedder else None
    if error is None:
        tr = ttrainer.AdaPromptTrainer(env["tfrozen"], None, env["ttok"], env["tscfg"],
                                       _port_sbg(env), iter(()), ttrainer.TrainerConfig(**cfg),
                                       face_embedder=face)
        if words == "ema":
            assert tr.ema is not None and tr.ema.num_updates == 0
        else:
            assert type(tr.state.optimizer.inner).__name__ == words
        with pytest.raises(NotImplementedError, match="multi-card"):
            tr.distribute()
        return
    with pytest.raises(error, match=words) as port:
        ttrainer.AdaPromptTrainer(env["tfrozen"], None, env["ttok"], env["tscfg"], None, iter(()),
                                  ttrainer.TrainerConfig(**cfg), face_embedder=face)
    with pytest.raises(ValueError) as ref:
        jtrainer.AdaPromptTrainer(env["jfrozen"], None, None, env["jtok"], env["jscfg"], None,
                                  iter(()), jtrainer.TrainerConfig(**cfg), face_embedder=face)
    assert str(port.value) == str(ref.value)


class _StubEmbedder:
    """ArcFace stand-in: two faces a photo, embeddings drawn from a seed made
    of the photo's pixels, and no face in the second photo it is shown."""

    def __init__(self):
        self.calls = 0

    def embed_image(self, image_np):
        self.calls += 1
        if self.calls == 2:
            return np.zeros((0, 512), np.float32)
        rng = np.random.default_rng(int(np.asarray(image_np, np.int64).sum()))
        return rng.standard_normal((2, 512)).astype(np.float32)


def test_trainer_face_embedder_matches_jax(env, tmp_path):
    """Face ids through a face embedder: each image's first face, and for
    the faceless one a random id from the host stream in the JAX trainer's
    order; the faceid rows and the stream after them agree with JAX's."""
    vcfg = dict(ch=32, ch_mult=(1, 2, 4), num_res_blocks=1)
    vt = reset_parameters(tvae.VAE(tvae.VAEConfig(**vcfg)), torch.Generator().manual_seed(9))
    cfg = dict(compute_dtype="float32", seed=3)
    raws = list(zip(range(2), ttrainer.synthetic_raw_batches(0, batch_size=4, size=32)))
    jtr = jtrainer.AdaPromptTrainer(
        env["jfrozen"], jax.tree.map(jnp.asarray, module_tree(vt)), jvae.VAEConfig(**vcfg),
        env["jtok"], env["jscfg"], env["jsp"], iter(()),
        jtrainer.TrainerConfig(out_dir=str(tmp_path / "jax"), **cfg), face_embedder=_StubEmbedder())
    ttr = ttrainer.AdaPromptTrainer(
        env["tfrozen"], vt, env["ttok"], env["tscfg"], _port_sbg(env), iter(()),
        ttrainer.TrainerConfig(out_dir=str(tmp_path / "port"), **cfg),
        face_embedder=_StubEmbedder())
    for _, raw in raws:
        got = ttr.prepare_recon_batch(raw, iter_type="arc2face_distill_iter")["faceid"].numpy()
        want = np.asarray(jtr.prepare_recon_batch(raw, iter_type="arc2face_distill_iter")["faceid"])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)
    assert ttr.face_embedder.calls == jtr.face_embedder.calls == 8
    np.testing.assert_array_equal(jtr.rng.random(4), ttr.rng.random(4))   # same stream after


class _RecordingRecon:
    """Stands in for the JAX trainer's compiled recon step: records each
    call's batch and moves nothing."""

    def __init__(self):
        self.calls = []

    def __call__(self, use_bg, fgbg_reg):
        def step(state, fp, batch, key):
            self.calls.append({k: np.asarray(batch[k]) for k in (
                "skip_weights", "emb_noise_std", "emb_scale_perturb", "caption_ids", "subj_bi",
                "subj_pos")})
            zero = jnp.float32(0.0)
            return state, {"loss": zero, "loss_recon": zero, "grad_norm": zero}
        return step


def test_trainer_mixed_run_matches_jax(env, tmp_path):
    """arc2face_distill_iter_prob=0.5 with conv-attention and the fg/bg
    regularizers: the same raw batches and seed give the JAX trainer's
    iteration types, and on each step its host draws in its order (the
    clip-skip weights, the embedding-noise std drawn only when its coin
    comes up, the scale perturbation, ND on distillation steps), the
    captions' ids and subject positions; the port's recon steps train, and
    the stream after the run is JAX's."""
    vcfg = dict(ch=32, ch_mult=(1, 2, 4), num_res_blocks=1)
    vt = reset_parameters(tvae.VAE(tvae.VAEConfig(**vcfg)), torch.Generator().manual_seed(9))
    cfg = dict(max_steps=20, grad_accum=2, max_num_denoising_steps=3, ckpt_every=100,
               compute_dtype="float32", seed=5, metrics_flush_every=1,
               arc2face_distill_iter_prob=0.5, use_conv_attn_kernel_size=2)
    batches = lambda: ttrainer.synthetic_raw_batches(0, batch_size=4, size=32)
    jtr = jtrainer.AdaPromptTrainer(
        env["jfrozen"], jax.tree.map(jnp.asarray, module_tree(vt)), jvae.VAEConfig(**vcfg),
        env["jtok"], env["jscfg"], env["jsp"], batches(),
        jtrainer.TrainerConfig(out_dir=str(tmp_path / "jax"), **cfg), synthetic_faces=True)
    jtr._distill_steps = _RecordingSteps()
    jtr._get_recon_step = _RecordingRecon()
    ttr = ttrainer.AdaPromptTrainer(
        env["tfrozen"], vt, env["ttok"], env["tscfg"], _port_sbg(env), batches(),
        ttrainer.TrainerConfig(out_dir=str(tmp_path / "port"), **cfg), synthetic_faces=True)
    seen = []
    real = ttr.prepare_recon_batch
    ttr.prepare_recon_batch = lambda *a, **k: seen.append(real(*a, **k)) or seen[-1]
    steps = 8
    rows = [ttr.train_step(i) for i in range(steps)]
    jtypes = []
    for i in range(steps):
        before = len(jtr._get_recon_step.calls)
        jtr.train_step(i)
        jtypes.append("recon" if len(jtr._get_recon_step.calls) > before else "arc2face_distill")
    types = [r["iter_type"] for r in rows]
    assert types == jtypes and set(types) == {"recon", "arc2face_distill"}, types
    distill = [r for r in rows if r["iter_type"] == "arc2face_distill"]
    assert [r["num_denoising_steps"] for r in distill] == [c[0] for c in jtr._distill_steps.calls]
    recon = [b for b, ty in zip(seen, types) if ty == "recon"]
    assert len(recon) == len(jtr._get_recon_step.calls)
    stds = []
    for b, c in zip(recon, jtr._get_recon_step.calls):
        for k, v in c.items():
            np.testing.assert_allclose(b[k].numpy(), v, rtol=1e-6, err_msg=k)
        stds.append(float(c["emb_noise_std"]))
    assert 0.0 in stds and any(0.02 <= s <= 0.04 for s in stds), stds   # the coin both ways
    for b, c in zip([b for b, ty in zip(seen, types) if ty != "recon"], jtr._distill_steps.calls):
        np.testing.assert_allclose(b["skip_weights"].numpy(), c[2], rtol=1e-6)
        assert float(b["emb_noise_std"]) == 0.0
    np.testing.assert_array_equal(jtr.rng.random(4), ttr.rng.random(4))   # same stream after
    for r in rows:
        assert np.isfinite(r["loss"] if r["iter_type"] == "recon"
                           else r["loss_arc2face_distill"]) and r["grad_norm"] > 0
        if r["iter_type"] == "recon":
            assert r["loss_fg_xlayer_consist"] > 0
    # emb_scales moved: the recon steps train it
    assert ttr.state.params["emb_scales"].detach().abs().max() > 0
