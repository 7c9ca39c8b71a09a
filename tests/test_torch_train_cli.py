"""The port's training CLI (`adaprompt_tpu_torch/cli/train.py`) against the
JAX package's, on tiny models (`--device cpu`, `load_pipeline`
monkeypatched as in tests/test_torch_cli.py): the parsed namespace with
`--base` and `--set`, `build_trainer_config` field for field, every
refusal under JAX's conditions, `--overlay_source` compositing the batches
as JAX's dataset and provider do, the CLIP key maps (`CLIPScorer.from_torch`,
`clip_vision.from_torch`) against JAX's on the transformers layout that
`tools/reference_layouts.py` writes; then the port's CLI end to end in
fp32: its losses equal to the port's trainer driven directly over the same
batches, the SIGUSR1 and interrupt saves (held to the end of the step)
taken up by `--resume_state`, nothing saved for an error inside a step, Stage 2
from Stage 1's checkpoint with the CLIP teacher filter, the static mode,
and checkpoints that the JAX package's `load_checkpoint` reads."""

import copy
import dataclasses
import functools
import json
import os
import signal
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaprompt_tpu import pipeline as jpipe
from adaprompt_tpu.adaface import checkpoint as jckpt, static_embedder as jse
from adaprompt_tpu.adaface import subj_basis_generator as jsbg
from adaprompt_tpu.cli import common as jcommon, train as jtrain
from adaprompt_tpu.data import dataset as jds, overlays as jov
from adaprompt_tpu.eval import clip_scorer as jscorer
from adaprompt_tpu.models import clip_text as jclip, clip_vision as jcv
from adaprompt_tpu_torch import pipeline as tpipe
from adaprompt_tpu_torch.adaface import subj_basis_generator as tsbg
from adaprompt_tpu_torch.adaface.checkpoint import module_tree
from adaprompt_tpu_torch.cli import common as tcommon, train as ttrain
from adaprompt_tpu_torch.data import dataset as tds
from adaprompt_tpu_torch.eval import clip_scorer as tscorer
from adaprompt_tpu_torch.models import arcface as tarcface, clip_text as tclip
from adaprompt_tpu_torch.models import clip_vision as tcv, vae as tvae
from adaprompt_tpu_torch.ops.layers import reset_parameters
from adaprompt_tpu_torch.train import prodigy as tprodigy, trainer as ttrainer
from adaprompt_tpu_torch.utils.png import write_png
from torch_port_helpers import (JAX_VAE, TORCH_VAE, VOCAB, arcface_pair, port_module,
                                randomized, torch_threads, train_env)  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import reference_layouts as rl  # noqa: E402

ARCFACE_CLI = dict(layers=(1, 1, 1, 1), planes=(8, 8, 16, 16), num_features=512,
                   input_size=112)   # the CLI's centre crop is 112 pixels
CLIP_VISION = dict(image_size=32, patch_size=8, hidden_size=64, intermediate_size=128,
                   num_layers=2, num_heads=4, projection_dim=32)
CLIP_TEXT = dict(vocab_size=VOCAB, hidden_size=48, intermediate_size=96, num_layers=2,
                 num_heads=4)
FEAT_TOL = 1e-5      # fp32 CLIP features, another summation order: of the largest entry
SIZE = 64            # photos 64x64 -> 8x8 latents
COMMON = ["--device", "cpu", "--fp32", "--size", str(SIZE), "--bs", "2", "--accum", "1"]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Tiny shared weights, a data root of two subjects (PNG photos with
    masks), and the files the CLI reads: the Arc2Face teacher as an SD
    checkpoint, an insightface ArcFace .pth and a transformers CLIPModel."""
    d = tmp_path_factory.mktemp("train_cli")
    e = train_env(d)
    vae = reset_parameters(tvae.VAE(TORCH_VAE), torch.Generator().manual_seed(7))
    jv = randomized(module_tree(vae), 8)
    e["tv"], e["jv"] = port_module(tvae.VAE(TORCH_VAE), jv), jax.tree.map(jnp.asarray, jv)
    rng = np.random.default_rng(0)
    root = d / "subjects"
    for name in ("alice", "bob"):
        (root / name).mkdir(parents=True)
        for i in range(2):
            write_png(str(root / name / f"{i}.png"),
                      rng.integers(0, 256, (80, 72, 3), np.uint8))
            mask = np.zeros((80, 72, 3), np.uint8)
            mask[16:64, 12:60] = 255
            write_png(str(root / name / f"{i}_mask.png"), mask)
    tf = e["tfrozen"]
    teacher = tpipe.StableDiffusionPipeline(tf.teacher_unet, e["tv"], tf.arc2face_text,
                                            e["ttok"])
    files = {"a2f": str(d / "arc2face.ckpt"), "arcface": str(d / "arcface.pth"),
             "clip": str(d / "clip.bin")}
    torch.save(rl.sd_checkpoint(teacher), files["a2f"])
    _, e["jacfg"], arc = arcface_pair(12, **ARCFACE_CLI)
    torch.save(rl.arcface_insightface(arc), files["arcface"])
    scorer = tscorer.CLIPScorer.random_init(
        3, e["ttok"], tclip.CLIPTextConfig(**CLIP_TEXT, eos_token_id=e["ttok"].eos_id),
        tcv.CLIPVisionConfig(**CLIP_VISION), device="cpu")
    torch.save(rl.clip_model_hf(scorer), files["clip"])
    e.update(root=str(root), files=files, scorer=scorer)
    return e


def _port_pipe(env):
    tf = env["tfrozen"]
    return tpipe.StableDiffusionPipeline(tf.unet, env["tv"], copy.deepcopy(tf.text),
                                         copy.deepcopy(env["ttok"]))


def _jax_pipe(env):
    jf = env["jfrozen"]
    return jpipe.StableDiffusionPipeline(
        jpipe.SDParams(unet=jf.unet, vae=env["jv"], text=dict(jf.text)),
        tokenizer=copy.deepcopy(env["jtok"]), unet_cfg=env["ju"], vae_cfg=JAX_VAE,
        text_cfg=env["jt"], compute_dtype=jnp.float32)


@pytest.fixture()
def clis(env, monkeypatch):
    """Fresh tiny pipelines as both CLIs' `load_pipeline`, the tiny ArcFace
    as the port's IResNet-100, the tiny CLIP towers as the port's ViT-B/32,
    and SIGUSR1's handler restored afterwards."""
    monkeypatch.setattr(tcommon, "load_pipeline", lambda args: _port_pipe(env))
    monkeypatch.setattr(jcommon, "load_pipeline", lambda args: _jax_pipe(env))
    monkeypatch.setattr(tarcface, "IRESNET100", tarcface.IResNetConfig(**ARCFACE_CLI))
    tok = env["ttok"]
    monkeypatch.setattr(tscorer.CLIPScorer, "from_torch", functools.partial(
        tscorer.CLIPScorer.from_torch,
        text_cfg=tclip.CLIPTextConfig(**CLIP_TEXT, eos_token_id=tok.eos_id),
        vision_cfg=tcv.CLIPVisionConfig(**CLIP_VISION)))
    old = signal.getsignal(signal.SIGUSR1)
    yield
    signal.signal(signal.SIGUSR1, old)


def _rows(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


# -- arguments, the trainer config, the refusals --------------------------------------

def test_namespace_matches_jax(tmp_path):
    y = tmp_path / "s.yaml"
    y.write_text("trainer:\n  d_coef: 0.75\n  accum: 4\ndata:\n  bs: 3\n  size: 256\n")
    argv = ["--data_roots", "a", "b", "--stage", "2", "--base", str(y), "--set",
            "trainer.warm_up_steps=50", "data.num_workers=0", "--accum", "1", "--fp32"]
    want = vars(jtrain.parse_args(argv))
    got = vars(ttrain.parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == want and want["bs"] == 3 and want["accum"] == 1


@pytest.mark.parametrize("argv", [
    [], ["--stage", "2"],
    ["--stage", "2", "--max_steps", "10", "--d_coef", "0.3", "--warm_up_steps", "7",
     "--composition_regs_iter_gap", "4", "--arc2face_distill_iter_prob", "0.6",
     "--max_num_denoising_steps", "7", "--use_conv_attn_kernel_size", "3", "--accum", "3",
     "--optimizer", "AdamW", "--num_candidate_teachers", "3", "--seed", "5", "--fp32",
     "--ckpt_every", "9", "--out_dir", "elsewhere"]],
    ids=["stage1", "stage2", "overrides"])
def test_trainer_config_matches_jax(argv):
    argv = ["--data_roots", "x"] + argv
    want = dataclasses.asdict(jtrain.build_trainer_config(jtrain.parse_args(argv)))
    got = dataclasses.asdict(ttrain.build_trainer_config(ttrain.parse_args(argv)))
    assert got == want


REFUSALS = {
    "no_arc2face": ([], "no --arc2face_ckpt"),
    "no_arcface": (["--arc2face_ckpt", "A2F"], "--arcface_ckpt is required"),
    "no_clip": (["--synthetic_faces", "--stage", "2"], "without --clip_ckpt"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_match_jax(env, clis, tmp_path, monkeypatch, case):
    """Each refusal of the JAX CLI fires in the port's under the same
    arguments: no Arc2Face teacher without --synthetic_faces, no ArcFace
    without it, and compositional iterations without --clip_ckpt or
    --no_teacher_filter."""
    extra, msg = REFUSALS[case]
    # JAX reads the Arc2Face file at SD-1.5's widths: its key maps hand it the tiny teacher
    monkeypatch.setattr(jtrain.unet_mod, "from_torch", lambda sd: env["jfrozen"].teacher_unet)
    monkeypatch.setattr(jtrain.clip_text, "from_torch", lambda sd: env["jfrozen"].arc2face_text)
    argv = ["--data_roots", env["root"], "--out_dir", str(tmp_path)] + [
        env["files"]["a2f"] if a == "A2F" else a for a in extra]
    with pytest.raises(SystemExit, match=msg):
        jtrain.main(argv)
    with pytest.raises(SystemExit, match=msg):
        ttrain.main(COMMON + argv)


def test_multi_card_raises(env, clis, tmp_path):
    with pytest.raises(NotImplementedError, match="multi-card"):
        ttrain.main(COMMON + ["--data_roots", env["root"], "--out_dir", str(tmp_path),
                              "--synthetic_faces", "--fsdp", "2", "--num_steps", "1"])


def test_overlay_source_composites_as_jax(env, clis, tmp_path, monkeypatch):
    """--overlay_source over a folder of PNG backgrounds at --overlay_prob
    0.5: the CLI takes its two recon steps, and the batches it trains on
    hold, example by example, what the JAX CLI's dataset and
    BackgroundOverlayProvider (size and seed from the same arguments) make,
    composited ones and plain ones both."""
    bg = tmp_path / "backgrounds"
    bg.mkdir()
    rng = np.random.default_rng(1)
    for i, cap in enumerate(("a mountain lake at sunset", "an empty city street at night")):
        write_png(str(bg / f"{i}.png"), rng.integers(0, 256, (70 + 4 * i, 80, 3), np.uint8))
        (bg / f"{i}.txt").write_text(cap)
    batches = []

    def recording(*a, **kw):
        for batch in tds_make_batch_iterator(*a, **kw):
            batches.append(copy.deepcopy(batch))
            yield batch
    tds_make_batch_iterator = tds.make_batch_iterator
    monkeypatch.setattr(tds, "make_batch_iterator", recording)
    tr = ttrain.main(COMMON + [
        "--data_roots", env["root"], "--out_dir", str(tmp_path / "out"), "--synthetic_faces",
        "--num_steps", "2", "--arc2face_distill_iter_prob", "0", "--num_workers", "0",
        "--seed", "6", "--overlay_source", str(bg), "--overlay_prob", "0.5"])
    rows = _rows(tmp_path / "out")
    assert [r["iter_type"] for r in rows] == ["recon", "recon"]
    assert all(np.isfinite(r["loss"]) for r in rows)

    subjects = jds.scan_subject_folders(env["root"])
    dset = jds.PersonalizedDataset(
        subjects, size=SIZE, seed=6,
        num_vectors_per_subj_token=tr.subj_basis_cfg.num_out_embs_per_layer,
        overlay_provider=jov.BackgroundOverlayProvider(str(bg), size=SIZE, seed=6),
        overlay_prob=0.5)
    sampler = jds.SubjectSampler(subjects, seed=6)
    flags = []
    for got in batches:
        subj = sampler.next_subject()
        want = [dset.sample(subj) for _ in range(2)]
        assert got["subject_idx"] == subj
        for k in dict.fromkeys(k for e in want for k in e):
            for i, e in enumerate(want):
                if k not in e:
                    assert got[k][i] is None, k
                elif isinstance(e[k], np.ndarray):
                    np.testing.assert_array_equal(got[k][i], e[k], err_msg=k)
                else:
                    assert got[k][i] == e[k], k
        flags += got["has_wds_comp"]
    assert len(batches) >= 2 and True in flags and False in flags


# -- the CLIP key maps ------------------------------------------------------------------

def test_clip_scorer_from_torch_matches_jax(env):
    """A transformers CLIPModel state dict (tiny towers, `logit_scale` and
    the `position_ids` entries included) loaded by both packages: equal text
    and image features and similarities within FEAT_TOL."""
    sd = rl.clip_model_hf(env["scorer"])
    tok = env["ttok"]
    jtcfg = jclip.CLIPTextConfig(**CLIP_TEXT, eos_token_id=tok.eos_id)
    js = jscorer.CLIPScorer.from_torch({k: v.numpy() for k, v in sd.items()}, env["jtok"],
                                       jtcfg, jcv.CLIPVisionConfig(**CLIP_VISION))
    ts = tscorer.CLIPScorer.from_torch(
        sd, tok, tclip.CLIPTextConfig(**CLIP_TEXT, eos_token_id=tok.eos_id),
        tcv.CLIPVisionConfig(**CLIP_VISION), device="cpu")
    imgs = np.random.default_rng(1).uniform(-1, 1, (2, 40, 40, 3)).astype(np.float32)
    texts = ["a photo of a person", "a cat in the park"]
    for got, want in ((ts.get_text_features(texts, norm=False),
                       js.get_text_features(texts, norm=False)),
                      (ts.get_image_features(torch.from_numpy(imgs), norm=False),
                       js.get_image_features(jnp.asarray(imgs), norm=False)),
                      (ts.txt_to_img_similarity(texts, torch.from_numpy(imgs), "none"),
                       js.txt_to_img_similarity(texts, jnp.asarray(imgs), "none"))):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=FEAT_TOL * np.abs(want).max())


def test_clip_vision_from_torch_matches_jax(env):
    """clip_vision.from_torch on a CLIPVisionModelWithProjection state dict
    (a ViT-H/14-shaped tower cut to 2 layers at 32 px): the masked encode's
    hidden states, pooled output and image embeddings against JAX's."""
    cfg = dict(CLIP_VISION, patch_size=16, num_heads=2)
    vis = tcv.CLIPVisionModel.random_init(4, tcv.CLIPVisionConfig(**cfg), device="cpu")
    sd = rl.clip_vision_hf(vis)
    jp = jcv.from_torch({k: v.numpy() for k, v in sd.items()}, jcv.CLIPVisionConfig(**cfg))
    model = tcv.CLIPVisionModel(tcv.CLIPVisionConfig(**cfg), device="cpu")
    model.load_state_dict(tcv.from_torch(sd, model.cfg), strict=True)
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(np.float32)
    mask = np.zeros((2, 32, 32, 1), np.float32)
    mask[:, 8:24, 4:20] = 1
    got = model.encode(torch.from_numpy(x), attn_mask=torch.from_numpy(mask))
    want = jcv.encode(jp, jnp.asarray(x), cfg=jcv.CLIPVisionConfig(**cfg),
                      attn_mask=jnp.asarray(mask))
    for k in ("pooled", "image_embeds"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=0,
                                   atol=FEAT_TOL * np.abs(w).max())


# -- the CLI end to end -----------------------------------------------------------------

def _stage1_argv(env, out, steps=3, extra=()):
    return COMMON + ["--data_roots", env["root"], "--out_dir", str(out),
                     "--arc2face_ckpt", env["files"]["a2f"],
                     "--arcface_ckpt", env["files"]["arcface"], "--num_steps", str(steps),
                     "--arc2face_distill_iter_prob", "0.5", "--max_num_denoising_steps", "3",
                     "--ckpt_every", "2", "--seed", "3"] + list(extra)


def test_cli_losses_match_the_trainer(env, clis, tmp_path, monkeypatch):
    """Three Stage-1 steps (distillation and recon draws, an Arc2Face teacher
    from the SD-layout file, ArcFace ids, two loader threads, a trace of step
    2, samples every 2 steps): the CLI's metrics rows equal those of the
    port's trainer built directly over the same models and batches."""
    monkeypatch.setattr(ttrainer.AdaPromptTrainer, "log_samples", functools.partialmethod(
        ttrainer.AdaPromptTrainer.log_samples, num_steps=2, height=SIZE, width=SIZE))
    torch.use_deterministic_algorithms(True)
    try:
        out = tmp_path / "cli"
        tr = ttrain.main(_stage1_argv(env, out, extra=["--sample_every", "2",
                                                       "--profile_dir", str(tmp_path / "prof")]))
        args = ttrain.parse_args(_stage1_argv(env, tmp_path / "direct"))
        pipe = _port_pipe(env)
        teacher, a2f_text = ttrain.load_teacher(env["files"]["a2f"], pipe)
        frozen = ttrainer.steps_mod.FrozenSD(pipe.unet, pipe.text, a2f_text, teacher)
        scfg = tsbg.SubjBasisConfig(placeholder_is_bg=False, output_dim=pipe.text.cfg.hidden_size,
                                    text_cfg=pipe.text.cfg)
        sbg = reset_parameters(tsbg.SubjBasisGenerator(scfg), torch.Generator().manual_seed(3))
        subjects = tds.scan_subject_folders(env["root"])
        it = tds.make_batch_iterator(
            tds.PersonalizedDataset(subjects, size=SIZE, seed=3), tds.SubjectSampler(subjects, seed=3),
            batch_size=2, num_workers=2)
        from adaprompt_tpu_torch.eval.face_eval import FaceSimilarityEvaluator
        direct = ttrainer.AdaPromptTrainer(
            frozen, pipe.vae, pipe.tokenizer, scfg, sbg, it, ttrain.build_trainer_config(args),
            face_embedder=FaceSimilarityEvaluator(tcommon.load_arcface(env["files"]["arcface"],
                                                                       "cpu")))
        for i in range(3):
            direct.train_step(i)
            if i == 1:     # the CLI's --sample_every 2: log_samples draws a face id
                direct.log_samples(2)
        direct.save_checkpoint(3)
    finally:
        torch.use_deterministic_algorithms(False)
    cli_rows, direct_rows = _rows(out), _rows(tmp_path / "direct")
    strip = lambda rows: [{k: v for k, v in r.items() if k != "step_time_s"} for r in rows]
    assert strip(cli_rows) == strip(direct_rows) and len(cli_rows) == 3
    assert {r["iter_type"] for r in cli_rows} == {"arc2face_distill", "recon"}
    files = sorted(os.listdir(out))
    assert {"embeddings_gs-2.npz", "embeddings_gs-3.npz", "samples_gs-2.png"} <= set(files)
    assert os.path.exists(tmp_path / "prof" / "trace.json")
    assert isinstance(tr, ttrainer.AdaPromptTrainer)
    # the generator checkpoint in the JAX package's reader, in JAX's layout
    trees, meta = jckpt.load_checkpoint(str(out / "embeddings_gs-3.npz"))
    jtree = jax.eval_shape(lambda: jsbg.init_params(
        jax.random.PRNGKey(0), jsbg.SubjBasisConfig(placeholder_is_bg=False,
                                                    output_dim=env["jt"].hidden_size,
                                                    text_cfg=env["jt"])))
    assert jax.tree.map(np.shape, trees["subj_basis"]) == jax.tree.map(lambda s: s.shape, jtree)
    assert meta["step"] == 3


def _repeating(make_batch_iterator):
    """A loader that yields its first batch again and again, so that a run
    resumed from a full state (which holds no loader position, as in JAX)
    meets the uninterrupted run's batches."""
    def make(dataset, sampler, batch_size, num_workers=0, prefetch=4):
        batch = next(make_batch_iterator(dataset, sampler, batch_size))
        while True:
            yield copy.deepcopy(batch)
    return make


def test_sigusr1_and_crash_saves_resume(env, clis, tmp_path, monkeypatch, capsys):
    """Signals sent inside the optimizer's update wait for the end of the
    step: SIGUSR1 in step 1 writes trainer_state-2 and training goes on,
    SIGINT in step 2 writes trainer_state-3 and raises KeyboardInterrupt.
    Resumed from either, the CLI gives the uninterrupted run's metrics rows,
    losses included, bit for bit. An error raised inside a step's update is
    raised again with no state saved."""
    monkeypatch.setattr(tds, "make_batch_iterator", _repeating(tds.make_batch_iterator))
    step, update = ttrainer.AdaPromptTrainer.train_step, tprodigy.Prodigy.step
    plan, now = {}, []      # step index -> what its update meets first

    def train_step(self, i):
        now[:] = [plan.get(i)]
        return step(self, i)

    def update_then(self, *args, **kwargs):
        what = now.pop() if now else None
        if isinstance(what, Exception):
            raise what
        if what is not None:
            os.kill(os.getpid(), what)
        return update(self, *args, **kwargs)
    monkeypatch.setattr(ttrainer.AdaPromptTrainer, "train_step", train_step)
    monkeypatch.setattr(tprodigy.Prodigy, "step", update_then)
    argv = lambda out, *extra: _stage1_argv(env, out, steps=4,
                                            extra=["--num_workers", "0", "--seed", "4", *extra])
    torch.use_deterministic_algorithms(True)
    try:
        full = tmp_path / "full"
        ttrain.main(argv(full))
        plan.update({1: signal.SIGUSR1, 2: signal.SIGINT})
        run = tmp_path / "run"
        with pytest.raises(KeyboardInterrupt):
            ttrain.main(argv(run))
        out = capsys.readouterr().out
        assert "SIGUSR1: saved" in out and "interrupted: saved" in out
        states = sorted(f for f in os.listdir(run) if f.startswith("trainer_state-"))
        assert states == ["trainer_state-2.npz", "trainer_state-3.npz"]
        plan.clear()
        plan[1] = RuntimeError("boom")
        crash = tmp_path / "crash"
        with pytest.raises(RuntimeError, match="boom"):
            ttrain.main(argv(crash))
        assert "step 1 raised part-way" in capsys.readouterr().out
        assert not [f for f in os.listdir(crash) if f.startswith("trainer_state-")]
        plan.clear()
        for at in (2, 3):
            ttrain.main(argv(run / f"from{at}", "--resume_state",
                             str(run / f"trainer_state-{at}.npz")))
            assert f"resumed full trainer state at step {at}" in capsys.readouterr().out
    finally:
        torch.use_deterministic_algorithms(False)
    strip = lambda rows: [{k: v for k, v in r.items() if k != "step_time_s"} for r in rows]
    want = strip(_rows(full))
    assert [r["step"] for r in want] == [0, 1, 2, 3]
    assert {r["iter_type"] for r in want} == {"arc2face_distill", "recon"}
    assert strip(_rows(run)) == want[:3]
    for at in (2, 3):
        assert strip(_rows(run / f"from{at}")) == want[at:], at


def test_stage2_and_static_modes(env, clis, tmp_path):
    """Stage 2 from Stage 1's generator checkpoint with the CLIP teacher
    filter (a compositional iteration at step 1), and two static-mode steps
    whose static_emb_gs-2 the JAX package reads in its layout."""
    s1 = tmp_path / "s1"
    ttrain.main(_stage1_argv(env, s1, steps=2, extra=["--num_workers", "0"]))
    s2 = tmp_path / "s2"
    tr = ttrain.main(COMMON + [
        "--data_roots", env["root"], "--out_dir", str(s2), "--stage", "2",
        "--arc2face_ckpt", env["files"]["a2f"], "--arcface_ckpt", env["files"]["arcface"],
        "--adaface_ckpt", str(s1 / "embeddings_gs-2.npz"), "--clip_ckpt", env["files"]["clip"],
        "--composition_regs_iter_gap", "1", "--num_steps", "2", "--num_workers", "0"])
    loaded = jckpt.load_checkpoint(str(s1 / "embeddings_gs-2.npz"))[0]["subj_basis"]
    assert tr.clip_scorer is not None and not tr.cfg.no_teacher_filter
    rows = _rows(s2)
    assert rows[1]["iter_type"] in ("compos_distill", "compos_distill_skipped")
    assert np.isfinite(rows[0]["loss"]) and "embeddings_gs-2.npz" in os.listdir(s2)
    assert loaded is not None
    st = tmp_path / "static"
    ttrain.main(COMMON + ["--data_roots", env["root"], "--out_dir", str(st), "--mode", "static",
                          "--num_steps", "2", "--ckpt_every", "1", "--num_workers", "0",
                          "--num_vectors_per_subj_token", "2", "--static_rank", "2"])
    trees, meta = jckpt.load_checkpoint(str(st / "static_emb_gs-2.npz"))
    jtree = jse.init_params(jax.random.PRNGKey(0), jse.StaticEmbedderConfig(
        num_vectors=2, rank=2, out_emb_dim=env["jt"].hidden_size))
    assert jax.tree.map(np.shape, trees["static_emb"]) == jax.tree.map(np.shape, jtree)
    assert meta == {"step": 2, "mode": "static"}
    assert os.path.exists(st / "static_emb_gs-1.npz")
