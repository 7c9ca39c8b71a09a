"""The port's Stage-2 trainer vs the JAX package's (tiny models, CPU,
float32, the same raw batches, seed and TrainerConfig.stage2(...)
overrides): on a gap-2 run with no_teacher_filter=True that mixes recon,
distillation and compositional steps, the iteration types step for step,
the host draws and the batches handed to each phase, a fresh and a reuse
compositional iteration, the numpy stream after the run and ca_q_bn_stats
after the two compositional steps; checkpoints carrying ca_q_bns both ways
and the frozen copy reset on load; the CLIP teacher filter fed JAX's
candidate triples on a tiny scorer of shared weights; the teachable
counters; and what the trainer refuses or skips.

Recon and distillation steps are stand-ins in both packages (they record
their batch and move nothing), so that the parameters move only through
the real compositional phases. The port's compositional phase is handed
JAX's device draws (the fresh x_start, the noise, the embedding noise of
JAX's noise_key): the packages draw them from different generators."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaprompt_tpu.adaface import checkpoint as jckpt
from adaprompt_tpu.eval import clip_scorer as jscorer
from adaprompt_tpu.models import clip_text as jclip, clip_vision as jcv, vae as jvae
from adaprompt_tpu.train import compos_step as jcs, trainer as jtrainer
from adaprompt_tpu_torch.adaface import subj_basis_generator as tsbg
from adaprompt_tpu_torch.adaface.checkpoint import module_tree
from adaprompt_tpu_torch.eval import clip_scorer as tscorer
from adaprompt_tpu_torch.models import clip_text as tclip, clip_vision as tcv, vae as tvae
from adaprompt_tpu_torch.ops.layers import reset_parameters
from adaprompt_tpu_torch.train import trainer as ttrainer
from torch_port_helpers import VOCAB, named, port_module, randomized, t, train_env
from torch_port_helpers import torch_threads  # noqa: F401

VAE_CFG = dict(ch=32, ch_mult=(1, 2, 4), num_res_blocks=1)
TOL = 1e-4          # fp32 phases through the UNet: of the array's largest entry
STEPS = 6           # compositional at 2 (fresh) and 4 (reuse)
CFG = dict(max_steps=20, grad_accum=1, max_num_denoising_steps=3, ckpt_every=100,
           compute_dtype="float32", seed=6, metrics_flush_every=1, warm_up_steps=2,
           arc2face_distill_iter_prob=0.5, composition_regs_iter_gap=2, no_teacher_filter=True)
COMPOS_KEYS = ("ids4", "subj_rows", "subj_pos4", "cls_pos", "faceid", "fg_mask", "skip_weights",
               "t", "emb_noise_std", "emb_scale_perturb", "normalize_outfeat", "training_percent",
               "x_start")


def _close(got, want, tol=TOL, err_msg=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=err_msg)


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    e = train_env(tmp_path_factory.mktemp("vocab"))
    vt = reset_parameters(tvae.VAE(tvae.VAEConfig(**VAE_CFG)), torch.Generator().manual_seed(9))
    return dict(e, tvae=vt.eval(), jvae=jax.tree.map(jnp.asarray, module_tree(vt)))


class _Stubs:
    """Stand-ins for both packages' recon and distillation steps: each call
    records (iteration type, its batch) and moves nothing."""

    def __init__(self, zero):
        self.calls, self.zero = [], zero

    def recon(self, use_bg, fgbg_reg):
        def step(state, fp, batch, key):
            self.calls.append(("recon", {k: _np(batch[k]) for k in (
                "skip_weights", "emb_noise_std", "emb_scale_perturb", "caption_ids", "subj_pos")}))
            return state, {"loss": self.zero, "loss_recon": self.zero, "grad_norm": self.zero}
        return step

    def distill(self, nd):
        def step(state, fp, batch, key):
            self.calls.append(("arc2face_distill", {"nd": nd, "bs": int(batch["z0"].shape[0]),
                                                    "skip_weights": _np(batch["skip_weights"])}))
            return state, {"loss_arc2face_distill": self.zero, "grad_norm": self.zero}
        return step


class _DistillSteps(dict):
    def __init__(self, stubs):
        super().__init__()
        self.stubs = stubs

    def __contains__(self, nd):
        return True

    def __getitem__(self, nd):
        return self.stubs.distill(nd)


def _jax_trainer(env, out, **kw):
    return jtrainer.AdaPromptTrainer(
        env["jfrozen"], env["jvae"], jvae.VAEConfig(**VAE_CFG), env["jtok"], env["jscfg"],
        env["jsp"], ttrainer.synthetic_raw_batches(0, batch_size=2, size=32),
        jtrainer.TrainerConfig.stage2(out_dir=str(out), **CFG), synthetic_faces=True, **kw)


def _port_trainer(env, out, **kw):
    sbg = port_module(tsbg.SubjBasisGenerator(env["tscfg"]), env["jsp"]).train()
    return ttrainer.AdaPromptTrainer(
        env["tfrozen"], env["tvae"], env["ttok"], env["tscfg"], sbg,
        ttrainer.synthetic_raw_batches(0, batch_size=2, size=32),
        ttrainer.TrainerConfig.stage2(out_dir=str(out), **CFG), synthetic_faces=True, **kw)


@pytest.fixture(scope="module")
def run(env, tmp_path_factory):
    """Both trainers over STEPS steps; JAX's first, its compositional
    phase's batches (and the embedding noise of their noise_key) recorded
    and the port's compositional phase handed its device draws."""
    tmp = tmp_path_factory.mktemp("run")
    jtr = _jax_trainer(env, tmp / "jax")
    jstubs = _Stubs(jnp.float32(0.0))
    jtr._distill_steps, jtr._get_recon_step = _DistillSteps(jstubs), jstubs.recon
    jtr._ensure_compos()
    jphase, jcalls = jtr._compos_phase, []

    def jrecord(state, mp, batch, key):
        shape = (1, env["jscfg"].num_out_layers, env["jscfg"].num_out_embs_per_layer,
                 env["jscfg"].output_dim)
        jcalls.append(dict({k: np.asarray(batch[k]) for k in COMPOS_KEYS + ("noise",)},
                           subj_pos_host=tuple(int(p) for p in batch["subj_pos_host"]),
                           emb_noise=np.asarray(jax.random.normal(batch["noise_key"], shape))))
        return jphase(state, mp, batch, key)

    jtr._compos_phase = jrecord
    jrows = [jtr.train_step(i) for i in range(STEPS)]

    ttr = _port_trainer(env, tmp / "port")
    tstubs = _Stubs(torch.zeros(()))
    ttr._get_recon_step, ttr._distill_step = tstubs.recon, tstubs.distill
    ttr._ensure_compos()
    tphase, tcalls = ttr._compos_phase, []

    def tinject(state, mp, batch, gen):
        want = jcalls[len(tcalls)]
        tcalls.append(dict({k: _np(batch[k]) for k in COMPOS_KEYS},
                           subj_pos_host=tuple(batch["subj_pos_host"])))
        batch = dict(batch, noise=t(want["noise"]))
        if len(set(want["t"].tolist())) == 1:          # fresh: the winner's triple tiled 4x
            batch["x_start"] = t(want["x_start"])
        return tphase(state, mp, batch, gen, draws={"emb_noise": t(want["emb_noise"])})

    ttr._compos_phase = tinject
    trows = [ttr.train_step(i) for i in range(STEPS)]
    return dict(jtr=jtr, ttr=ttr, jrows=jrows, trows=trows, jcalls=jcalls, tcalls=tcalls,
                jstubs=jstubs, tstubs=tstubs, tmp=tmp)


def test_stage2_iteration_types_match_jax(run):
    """Recon, distillation and compositional steps, the same on each step;
    compositional steps at 2 and 4, the first fresh and the second reusing
    its x_recon; no distillation coin on them."""
    types = [r["iter_type"] for r in run["trows"]]
    assert types == [r["iter_type"] for r in run["jrows"]], types
    assert set(types) == {"recon", "arc2face_distill", "compos_distill"}, types
    assert [i for i, ty in enumerate(types) if ty == "compos_distill"] == [2, 4]
    other = [ty for ty in types if ty != "compos_distill"]
    assert other == [c[0] for c in run["tstubs"].calls] == [c[0] for c in run["jstubs"].calls]
    fresh_t, reuse_t = run["tcalls"][0]["t"], run["tcalls"][1]["t"]
    assert len(set(fresh_t.tolist())) == 1 and 800 <= fresh_t[0] < 1000
    assert len(set(reuse_t.tolist())) > 1 and np.all((400 <= reuse_t) & (reuse_t < 700))
    assert np.all(reuse_t <= fresh_t - 150)
    for r in run["trows"]:
        if r["iter_type"] == "compos_distill":
            assert r["teacher_filter_disabled"] == 1.0 and r["grad_norm"] > 0
            assert all(np.isfinite(r[k]) for k in ("loss_compos", "loss_mix_prompt_distill",
                                                  "loss_prompt_emb_delta",
                                                  "loss_comp_fg_bg_preserve"))
            assert "teachable" not in r


def test_stage2_host_draws_and_batches_match_jax(run):
    """Each phase's batch: the recon and distillation stand-ins' (clip-skip
    weights, the embedding-noise std, the scale perturbation, ids and
    positions, ND and HALF_BS), and the compositional phase's (the 4-type
    ids and positions, face id, fg mask, clip-skip weights, t, the noise
    coin and std, the perturbation, the LayerNorm coin, the progress, and on
    the reuse step the cached x_start); then the stream after the run."""
    for (ty, c_t), (ty_j, c_j) in zip(run["tstubs"].calls, run["jstubs"].calls):
        assert ty == ty_j
        for k, v in c_j.items():
            np.testing.assert_allclose(c_t[k], v, rtol=1e-6, err_msg=k)
    assert len(run["tcalls"]) == len(run["jcalls"]) == 2
    for i, (c_t, c_j) in enumerate(zip(run["tcalls"], run["jcalls"])):
        assert c_t["subj_pos_host"] == c_j["subj_pos_host"]
        for k in COMPOS_KEYS:
            if k == "x_start" and i == 0:
                continue              # the fresh candidates come from each package's generator
            tol = TOL if k == "x_start" else 1e-6
            _close(c_t[k], c_j[k], tol=tol, err_msg=k)
    stds = [float(c["emb_noise_std"]) for c in run["tcalls"]]
    assert all(s == 0.0 or 0.02 <= s <= 0.04 for s in stds)
    np.testing.assert_array_equal(run["jtr"].rng.random(4), run["ttr"].rng.random(4))


def test_stage2_q_bn_stats_match_jax(run):
    """ca_q_bn_stats after the two compositional steps (the running mean and
    unbiased variance of the captured layers' q), and the parameters they
    trained."""
    js, ts = run["jtr"].ca_q_bn_stats, run["ttr"].ca_q_bn_stats
    assert sorted(ts) == sorted(js) == [7, 8]
    for li in js:
        for k in ("mean", "var"):
            _close(ts[li][k], js[li][k], err_msg=f"{li} {k}")
    want = named(run["jtr"].state.params["subj_basis"])
    for n, p in run["ttr"].state.params["subj_basis"].named_parameters():
        _close(p, want[n], tol=1e-3, err_msg=n)


def test_stage2_checkpoint_carries_ca_q_bns(env, run):
    """The port's checkpoint holds ca_q_bns, which the JAX package reads;
    loading it (or a JAX-written one) restores the statistics and makes the
    frozen blend copy the loaded generator."""
    ttr, tmp = run["ttr"], run["tmp"]
    path = ttr.save_checkpoint(STEPS)
    trees, meta = jckpt.load_checkpoint(path)
    assert set(trees) == {"subj_basis", "emb_scales", "ca_q_bns"}
    jtr2 = _jax_trainer(env, tmp / "jax2")
    jtr2.load_checkpoint(path)
    ttr2 = _port_trainer(env, tmp / "port2")
    frozen0 = {n: p.clone() for n, p in ttr2._frozen_sbg.named_parameters()}
    ttr2.load_checkpoint(path)
    for li, ent in ttr.ca_q_bn_stats.items():
        for k, v in ent.items():
            np.testing.assert_array_equal(jtr2.ca_q_bn_stats[li][k], v.numpy())
            np.testing.assert_array_equal(ttr2.ca_q_bn_stats[li][k].numpy(), v.numpy())
    trained = dict(ttr.state.params["subj_basis"].named_parameters())
    moved = 0
    for n, p in ttr2._frozen_sbg.named_parameters():
        assert torch.equal(p, trained[n]) and not p.requires_grad, n
        moved += not torch.equal(p, frozen0[n])
    assert moved > 0
    # a JAX-written checkpoint: its statistics reach the port
    jpath = run["jtr"].save_checkpoint(STEPS + 1)
    ttr3 = _port_trainer(env, tmp / "port3")
    ttr3.load_checkpoint(jpath)
    for li, ent in run["jtr"].ca_q_bn_stats.items():
        for k, v in ent.items():
            np.testing.assert_array_equal(ttr3.ca_q_bn_stats[li][k].numpy(), np.asarray(v))


TEXT = dict(vocab_size=VOCAB, hidden_size=48, intermediate_size=96, num_layers=2, num_heads=4)
VISION = dict(image_size=24, patch_size=8, hidden_size=32, intermediate_size=64, num_layers=2,
              num_heads=4, projection_dim=16)


@pytest.mark.parametrize("rows", [slice(0, 2), slice(1, 2)], ids=["fresh", "reuse"])
def test_teacher_filter_matches_jax(env, tmp_path, rows):
    """With a tiny CLIPScorer of shared weights (its 24-pixel tower resizing
    the 32-pixel decodes), both trainers' _teacher_filter fed the same
    candidate triples (made by JAX): the CLIP losses and the decision. A
    fresh iteration's two candidates, and a reuse iteration's one row."""
    jt = jclip.CLIPTextConfig(**TEXT, eos_token_id=env["jtok"].eos_id)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(6), 3)
    tree = {"text": randomized(jclip.init_params(k1, jt), 7),
            "text_projection": np.asarray(jax.random.normal(k3, (48, 16)) * 0.02, np.float32),
            "vision": randomized(jcv.init_params(k2, jcv.CLIPVisionConfig(**VISION)), 8)}
    js = jscorer.CLIPScorer(jscorer.CLIPScorerParams(
        text=jax.tree.map(jnp.asarray, tree["text"]),
        text_projection=jnp.asarray(tree["text_projection"]),
        vision=jax.tree.map(jnp.asarray, tree["vision"])), env["jtok"], jt,
        jcv.CLIPVisionConfig(**VISION))
    ts = port_module(tscorer.CLIPScorer(
        env["ttok"], tclip.CLIPTextConfig(**TEXT, eos_token_id=env["ttok"].eos_id),
        tcv.CLIPVisionConfig(**VISION), device="cpu"), tree)
    cfg = dict(CFG, no_teacher_filter=False)
    jtr = jtrainer.AdaPromptTrainer(
        env["jfrozen"], env["jvae"], jvae.VAEConfig(**VAE_CFG), env["jtok"], env["jscfg"],
        env["jsp"], iter(()), jtrainer.TrainerConfig.stage2(out_dir=str(tmp_path / "j"), **cfg),
        synthetic_faces=True, clip_scorer=js)
    sbg = port_module(tsbg.SubjBasisGenerator(env["tscfg"]), env["jsp"]).train()
    ttr = ttrainer.AdaPromptTrainer(
        env["tfrozen"], env["tvae"], env["ttok"], env["tscfg"], sbg, iter(()),
        ttrainer.TrainerConfig.stage2(out_dir=str(tmp_path / "t"), **cfg),
        synthetic_faces=True, clip_scorer=ts)
    raw = next(ttrainer.synthetic_raw_batches(0, batch_size=2, size=32))
    cj, ct = jtr.prepare_compos_batch(raw), ttr.prepare_compos_batch(raw)
    keys = jax.random.split(jax.random.PRNGKey(2), 3)
    xc = jnp.concatenate([jcs.init_x_with_fg_from_training_image(
        cj["z0"], cj["fg_mask"], cj["fg_mask"], keys[i], s)[0] for i, s in enumerate((0.9, 0.75))])
    tc = jnp.asarray([910, 830], jnp.int32)
    nc = jax.random.normal(keys[2], xc.shape, jnp.float32)
    xc, tc, nc = xc[rows], tc[rows], nc[rows]
    want = jtr._teacher_filter(cj, xc, tc, nc)
    got = ttr._teacher_filter(ct, t(xc), torch.tensor(np.asarray(tc)).long(), t(nc))
    assert got[:2] == want[:2]
    assert set(got[2]) == set(want[2]) == {"loss_clip_subj_comp", "loss_clip_cls_comp"}
    for k, v in want[2].items():
        np.testing.assert_allclose(got[2][k], v, rtol=0, atol=1e-5, err_msg=k)


def test_teachable_counters_match_jax(env, tmp_path):
    """_log_teachable's metrics and the sample grid's colour over fresh and
    reuse, teachable and not."""
    jtr = _jax_trainer(env, tmp_path / "j")
    ttr = _port_trainer(env, tmp_path / "t")
    for teachable, reuse in ((True, False), (False, False), (True, True), (False, True),
                             (True, True)):
        mj, mt = {}, {}
        jtr._log_teachable(mj, teachable, reuse)
        ttr._log_teachable(mt, teachable, reuse)
        assert mt == mj and ttr._last_teach_color == jtr._last_teach_color


def test_stage2_refusals_and_skips(env, tmp_path):
    """Compositional training without a scorer and without the opt-in is
    refused with JAX's ValueError; EMA builds under Stage-2, a full state
    loads back into its trainer and is refused, before anything moves, by a
    trainer with another optimizer; `distribute` still raises;
    prepare_compos_batch returns None for prompts without the placeholder,
    as JAX's does, and such a step falls through to the coins."""
    cfg = dict(CFG, no_teacher_filter=False)
    kw = dict(synthetic_faces=True)
    with pytest.raises(ValueError) as port:
        ttrainer.AdaPromptTrainer(env["tfrozen"], None, env["ttok"], env["tscfg"], None, iter(()),
                                  ttrainer.TrainerConfig.stage2(out_dir=str(tmp_path), **cfg), **kw)
    with pytest.raises(ValueError) as ref:
        jtrainer.AdaPromptTrainer(env["jfrozen"], None, None, env["jtok"], env["jscfg"], None,
                                  iter(()), jtrainer.TrainerConfig.stage2(out_dir=str(tmp_path),
                                                                          **cfg), **kw)
    assert str(port.value) == str(ref.value) and "no_teacher_filter=True" in str(port.value)
    sbg = port_module(tsbg.SubjBasisGenerator(env["tscfg"]), env["jsp"])
    adamw = ttrainer.AdaPromptTrainer(
        env["tfrozen"], None, env["ttok"], env["tscfg"], sbg, iter(()),
        ttrainer.TrainerConfig.stage2(out_dir=str(tmp_path),
                                      **dict(CFG, use_ema=True, optimizer_type="AdamW")), **kw)
    assert adamw.ema is not None and adamw._frozen_sbg is not None
    ttr = _port_trainer(env, tmp_path / "t")
    assert ttr.load_full_state(ttr.save_full_state(1))["step"] == 1
    before = {n: p.clone() for n, p in sbg.named_parameters()}
    with pytest.raises(ValueError, match="Prodigy"):
        adamw.load_full_state(str(tmp_path / "t" / "trainer_state-1.npz"))
    assert all(torch.equal(p, before[n]) for n, p in sbg.named_parameters())
    with pytest.raises(NotImplementedError, match="multi-card"):
        ttr.distribute()
    jtr = _jax_trainer(env, tmp_path / "j")
    raw = next(ttrainer.synthetic_raw_batches(0, batch_size=2, size=32))
    raw = dict(raw, subj_prompt_comp=["a photo of a person in the park"] * 2)
    assert ttr.prepare_compos_batch(raw) is None and jtr.prepare_compos_batch(raw) is None
    stubs = _Stubs(torch.zeros(()))
    ttr._get_recon_step, ttr._distill_step = stubs.recon, stubs.distill
    ttr.batch_iterator = iter([raw])
    assert ttr.train_step(2)["iter_type"] in ("recon", "arc2face_distill")
    assert ttr.ca_q_bn_stats == {} and not ttr._cached_inits.cache
