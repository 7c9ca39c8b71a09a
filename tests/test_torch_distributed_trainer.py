"""The port's trainer over a device mesh (AdaPromptTrainer.distribute, gloo
ranks on the CPU) vs the JAX package's undistributed trainer steps (which
GSPMD makes equal to its distributed ones) and vs the port's own
single-rank run, on the same weights (convert.from_jax_params, zero leaves
re-randomised) and the same global batches and draws, over a 2x2 (dp, fsdp)
and a 2x1 world:

  * a recon step with the fg/bg regularizers, whose rows' fg masks differ in
    area (a mean of per-rank masked means would be off) and with the
    embedding noise on;
  * an ND=3 distillation step on the HALF_BS rows, rounded up to dp;
  * a compositional iteration (whole on every rank);
  * save_full_state under the mesh (the undistributed file's keys and
    values, written by rank 0 alone), load_full_state and one more recon
    step;
  * two train_step calls with the trainer's own draws and the EMA they
    update (against the port's single-rank run only: JAX draws other
    numbers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaprompt_tpu.models import vae as jvae
from adaprompt_tpu.train import steps as jsteps, trainer as jtrainer
from adaprompt_tpu_torch.adaface import conditioner as tcond
from adaprompt_tpu_torch.adaface import subj_basis_generator as tsbg
from adaprompt_tpu_torch.adaface.checkpoint import module_tree
from adaprompt_tpu_torch.models import vae as tvae
from adaprompt_tpu_torch.ops.layers import reset_parameters
from adaprompt_tpu_torch.train import trainer as ttrainer
import torch_dist_workers as workers
from torch_port_helpers import named, port_module, train_env
from torch_port_helpers import torch_threads  # noqa: F401

LOSS_RTOL = 1e-5         # as tests/test_torch_recon_step.py: fp32, other summation orders
COMPOS_RTOL = 1e-4       # as tests/test_torch_compos_step.py
GRAD_NORM_RTOL = 1e-4
VAE_CFG = dict(ch=32, ch_mult=(1, 2, 4), num_res_blocks=1)
CAPTIONS = ["a photo of a z person", "a z in the park"] * 2
CFG = dict(compute_dtype="float32", seed=4, grad_accum=1, max_steps=10, warm_up_steps=2,
           no_teacher_filter=True, metrics_flush_every=1, use_ema=True)
WORLDS = {"2x2": 2, "2x1": 1}       # dp x fsdp over 4 and 2 ranks
DISTILL_B = 8                       # ceil(8 / 3) = 3 rows, rounded up to dp = 2: 4


def _recon_batch(env, seed):
    """4 rows whose fg masks cover 9, 18, 36 and 54 of the 64 latent pixels."""
    rng = np.random.default_rng(seed)
    ids = np.asarray(env["jtok"](CAPTIONS))
    bi, pos = [], []
    for i, row in enumerate(ids):
        bi.append(i)
        pos.append(int(np.where(row == env["spec_id"])[0][0]))
    fg = np.zeros((4, 8, 8, 1), np.float32)
    for i, (h, w) in enumerate([(3, 3), (3, 6), (6, 6), (6, 9)]):
        fg[i, :h, :min(w, 8)] = 1
        if w > 8:
            fg[i, h:h + 1, :w - 8] = 1
    fid = rng.standard_normal((4, 512)).astype(np.float32)
    fid /= np.linalg.norm(fid, axis=-1, keepdims=True)
    return {"z0": rng.standard_normal((4, 8, 8, 4)).astype(np.float32), "faceid": fid,
            "caption_ids": ids.astype(np.int64), "subj_bi": np.asarray(bi, np.int64),
            "subj_pos": np.asarray(pos, np.int64), "fg_mask": fg,
            "aug_mask": (rng.random((4, 8, 8, 1)) > 0.2).astype(np.float32),
            "skip_weights": rng.dirichlet((1.0, 2.0, 2.0)).astype(np.float32),
            "emb_noise_std": np.float32(0.03),
            "emb_scale_perturb": np.asarray([1.2, 0.9], np.float32)}


def _recon_draws(key, b, scfg):
    """The draws of make_zs_recon_step's loss_fn (test_torch_recon_step.py)."""
    kt, kn, ke = jax.random.split(key, 3)
    emb_shape = (b, scfg.num_out_layers, scfg.num_out_embs_per_layer, scfg.output_dim)
    return {"t": np.asarray(jax.random.randint(kt, (b,), 0, 1000)).astype(np.int64),
            "noise": np.asarray(jax.random.normal(kn, (b, 8, 8, 4), jnp.float32)),
            "emb_noise": np.asarray(jax.random.normal(ke, emb_shape, jnp.float32))}


def _distill_batch(seed):
    rng = np.random.default_rng(seed)
    fid = rng.standard_normal((DISTILL_B, 512)).astype(np.float32)
    fid /= np.linalg.norm(fid, axis=-1, keepdims=True)
    return {"z0": rng.standard_normal((DISTILL_B, 8, 8, 4)).astype(np.float32), "faceid": fid,
            "fg_mask": (rng.random((DISTILL_B, 8, 8, 1)) > 0.4).astype(np.float32),
            "aug_mask": (rng.random((DISTILL_B, 8, 8, 1)) > 0.2).astype(np.float32)}


def _distill_draws(key, z0_shape, nd):
    """The draws of steps.py's loss_fn and the teacher chain (test_torch_train.py)."""
    k_t, k_noise, k_teacher, _ = jax.random.split(key, 4)
    b = z0_shape[0]
    rels, nxt, k = [], [], k_teacher
    for _ in range(nd - 1):
        k, k1, k2 = jax.random.split(k, 3)
        rels.append(np.asarray(jax.random.uniform(k1, (b,), jnp.float32)))
        nxt.append(np.asarray(jax.random.normal(k2, z0_shape, jnp.float32)))
    return {"t": np.asarray(jax.random.randint(k_t, (b,), 0, 1000)).astype(np.int64),
            "noise": np.asarray(jax.random.normal(k_noise, z0_shape, jnp.float32)),
            "rels": np.stack(rels), "next_noises": np.stack(nxt)}


def _compos_batch(jtr):
    """A 4-type batch made by the JAX trainer, with four t and the noise on."""
    raw = next(ttrainer.synthetic_raw_batches(0, batch_size=2, size=32))
    cj = jtr.prepare_compos_batch(raw)
    rng = np.random.default_rng(1)
    keys = ("fg_mask", "faceid", "ids4", "subj_rows", "subj_pos4", "cls_pos", "skip_weights")
    b = {k: np.asarray(cj[k]) for k in keys}
    for k in ("ids4", "subj_rows", "subj_pos4", "cls_pos"):
        b[k] = b[k].astype(np.int64)
    b.update(x_start=rng.standard_normal((4, 8, 8, 4)).astype(np.float32),
             t=np.asarray([690, 610, 520, 450], np.int64),
             noise=rng.standard_normal((4, 8, 8, 4)).astype(np.float32),
             subj_pos_host=tuple(cj["subj_pos_host"]), emb_noise_std=np.float32(0.03),
             emb_scale_perturb=np.asarray([1.2, 0.9], np.float32),
             normalize_outfeat=np.float32(1.0), training_percent=np.float32(0.3))
    return b


def _jax_recon(batch):
    out = {k: jnp.asarray(v) for k, v in batch.items()}
    for k in ("caption_ids", "subj_bi", "subj_pos"):
        out[k] = out[k].astype(jnp.int32)
    return out


def _jax_run(jtr, spec, steps):
    """JAX's steps on the spec's batches and draws, in order (each of
    `steps`, the first ones of STEPS): each step's metrics, and the
    generator and emb_scales after it. A distributed trainer's batches are
    sharded over its mesh."""
    out = {}
    shard = jtr._shard_batch

    def record(tag, m):
        out[tag] = {k: np.asarray(v) for k, v in m.items() if k != "q_bn_stats"}
        out[tag + "/params"] = named(jtr.state.params["subj_basis"])
        out[tag + "/emb_scales"] = np.asarray(jtr.state.params["emb_scales"])

    recon = jtr._get_recon_step(use_bg=False, fgbg_reg=True)
    jtr.state, m = recon(jtr.state, jtr._fp, shard(_jax_recon(spec["recon_batch"])),
                         jax.random.PRNGKey(30))
    record("recon", m)
    if "distill" not in steps:
        return out
    distill = jax.jit(jsteps.make_arc2face_distill_step(
        jtr.optimizer, jtr.frozen, jtr.tokenizer, jtr.subj_basis_cfg, num_denoising_steps=3,
        compute_dtype=jnp.float32, skip_weights=jtr.cfg.skip_weights))
    rows = spec["distill_rows"]
    batch = {k: jnp.asarray(v[:rows]) for k, v in spec["distill_batch"].items()}
    jtr.state, m = distill(jtr.state, jtr._fp, shard(batch), jax.random.PRNGKey(31))
    record("distill", m)
    jtr._ensure_compos()
    jbatch = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) or np.isscalar(v) else v)
              for k, v in spec["compos_batch"].items()}
    jbatch["noise_key"] = jax.random.PRNGKey(5)
    jtr.state, m, x_recon = jtr._compos_phase(jtr.state, jtr._mp_compos(), jbatch,
                                              jax.random.PRNGKey(0))
    record("compos", dict(m, x_recon=x_recon))
    jtr.state, m = recon(jtr.state, jtr._fp, shard(_jax_recon(spec["recon_batch2"])),
                         jax.random.PRNGKey(32))
    record("resumed", m)
    return out


def jax_and_spec(tmp, mesh=None, steps=("recon", "distill", "compos", "resumed")):
    """(JAX's steps, the spec of the port's runs): the tiny models saved for
    the ranks under tmp, the batches and draws; JAX's trainer distributed
    over `mesh` when one is given."""
    (tmp / "vocab").mkdir()
    env = train_env(tmp / "vocab")
    env["spec_id"] = tcond.make_placeholders(env["ttok"], ("z",), ("y",))[0].token_id
    vae = reset_parameters(tvae.VAE(tvae.VAEConfig(**VAE_CFG)), torch.Generator().manual_seed(9))
    sbg = port_module(tsbg.SubjBasisGenerator(env["tscfg"]), env["jsp"])
    f = env["tfrozen"]
    torch.save({"unet": f.unet.state_dict(), "text": f.text.state_dict(),
                "arc2face_text": f.arc2face_text.state_dict(),
                "teacher_unet": f.teacher_unet.state_dict(), "vae": vae.state_dict(),
                "sbg": sbg.state_dict()}, tmp / "states.pt")
    jtr = jtrainer.AdaPromptTrainer(
        env["jfrozen"], jax.tree.map(jnp.asarray, module_tree(vae)), jvae.VAEConfig(**VAE_CFG),
        env["jtok"], env["jscfg"], env["jsp"], iter(()),
        jtrainer.TrainerConfig.stage2(out_dir=str(tmp / "jax"), **CFG), synthetic_faces=True)
    scfg = env["jscfg"]
    spec = {"states": str(tmp / "states.pt"), "vocab": str(tmp / "vocab"),
            "cfgs": (f.unet.cfg, f.text.cfg, tvae.VAEConfig(**VAE_CFG), env["tscfg"]),
            "trainer_cfg": CFG,
            "recon_batch": _recon_batch(env, 3),
            "recon_draws": _recon_draws(jax.random.PRNGKey(30), 4, scfg),
            "distill_batch": _distill_batch(4), "distill_rows": 4,
            "distill_draws": _distill_draws(jax.random.PRNGKey(31), (4, 8, 8, 4), 3),
            "compos_batch": _compos_batch(jtr),
            "compos_draws": {"emb_noise": np.asarray(jax.random.normal(
                jax.random.PRNGKey(5), (1, scfg.num_out_layers, scfg.num_out_embs_per_layer,
                                        scfg.output_dim), jnp.float32))},
            "recon_batch2": _recon_batch(env, 5),
            "recon_draws2": _recon_draws(jax.random.PRNGKey(32), 4, scfg)}
    if mesh is not None:
        jtr.distribute(mesh)
        with mesh:
            return _jax_run(jtr, spec, steps), spec
    return _jax_run(jtr, spec, steps), spec


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's steps, the port's single-rank run and each world's ranks."""
    tmp = tmp_path_factory.mktemp("dist_trainer")
    want, spec = jax_and_spec(tmp)
    single = workers.run_trainer(spec, str(tmp / "single"))
    worlds = {}
    for name, fsdp in WORLDS.items():
        d = tmp / name
        d.mkdir()
        workers.spawn(workers.trainer_rank, 2 * fsdp, d, dict(spec, fsdp=fsdp))
        worlds[name] = [workers.load(d / f"trainer-{r}.pkl") for r in range(2 * fsdp)]
    return want, single, worlds


def _close_metrics(got, want, names, rtol, what):
    for name in names:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=GRAD_NORM_RTOL if name == "grad_norm" else rtol,
                                   atol=1e-9, err_msg=f"{what}: {name}")


def _close_params(got, want, start, what):
    """Each leaf within 1% of how far it moved from the start plus 2 float32
    ulps of the parameter (the single parity tests' bound for one step)."""
    for name, w in want.items():
        tol = 1e-2 * np.abs(w - start[name]).max() + 2 * np.spacing(np.abs(start[name]).max())
        err = np.abs(got[name] - w).max()
        assert err <= tol, f"{what}: {name} {err} > {tol}"


STEPS = {"recon": LOSS_RTOL, "distill": LOSS_RTOL, "compos": COMPOS_RTOL, "resumed": LOSS_RTOL}


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("step", list(STEPS))
def test_distributed_step_matches_jax(runs, world, step):
    """Every rank's metrics and updated generator (gathered whole) equal
    JAX's undistributed step and the port's single-rank run."""
    want, single, worlds = runs
    names = [k for k in want[step] if k != "x_recon"]
    assert "grad_norm" in names and len(names) >= 2
    for r in worlds[world]:
        for ref, what in ((want, "JAX"), (single, "single rank")):
            _close_metrics(r[step], ref[step], names, STEPS[step], f"{world} {step} vs {what}")
            _close_params(r[step + "/params"], ref[step + "/params"], single["init/params"],
                          f"{world} {step} vs {what}")
            _close_params({"emb_scales": r[step + "/emb_scales"]},
                          {"emb_scales": ref[step + "/emb_scales"]},
                          {"emb_scales": single["init/emb_scales"]}, f"{world} {step} vs {what}")
    if step == "compos":
        x = want["compos"]["x_recon"]
        for r in worlds[world]:
            np.testing.assert_allclose(r["compos"]["x_recon"], x, rtol=0,
                                       atol=1e-4 * np.abs(x).max())


@pytest.mark.parametrize("world", list(WORLDS))
def test_rows_and_shards(runs, world):
    """Each rank computes its dp block of the recon rows and of the HALF_BS
    rows (3 undistributed, rounded up to dp = 2: 4); under fsdp = 2 the
    generator's big leaves are sharded."""
    _, single, worlds = runs
    assert single["distill_bs"] == 4 and single["recon/rows"] == 4
    for r in worlds[world]:
        assert r["distill_bs"] == 4
        assert r["recon/rows"] == 2 and r["distill/rows"] == 2
        assert bool(r["sharded"]) == (WORLDS[world] > 1)


@pytest.mark.parametrize("world", list(WORLDS))
def test_full_state_under_mesh(runs, world):
    """save_full_state under the mesh writes, from rank 0 alone, the
    undistributed file's keys and values (the optimizer's slots, the
    generator copy, the streams); every rank reads it back."""
    _, single, worlds = runs
    ref = np.load(single["state_file"])
    got = np.load(worlds[world][0]["state_file"])
    assert sorted(got.files) == sorted(ref.files)
    # a tolerance of 1e-4 of the value plus 1e-5 of its group's largest
    # (an optimizer slot's over all leaves: the attention k biases'
    # gradients are zero up to rounding)
    group = lambda k: "/".join(k.split("/")[:2]) if k.startswith("optstate/") else k.split("/")[0]
    scale = {}
    for k in ref.files:
        if ref[k].dtype.kind == "f":
            scale[group(k)] = max(scale.get(group(k), 0.0), float(np.abs(ref[k]).max()))
    for k in ref.files:
        a, b = got[k], ref[k]
        if b.dtype.kind != "f":
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 * scale[group(k)], err_msg=k)
    for r in worlds[world]:
        assert r["written"].count("trainer_state-3.npz") == 1
        assert r["metrics_lines"] == 2        # rank 0's two train_step rows


@pytest.mark.parametrize("world", list(WORLDS))
def test_train_step_matches_single_rank(runs, world):
    """Two train_step calls after the resume, with the trainer's own host and
    device draws: every rank's metrics, generator and EMA (updated on every
    rank's shards) are the single-rank trainer's."""
    _, single, worlds = runs
    for i in (1, 2):
        tag = f"train_step{i}"
        names = [k for k in single[tag] if k != "x_recon"]
        for r in worlds[world]:
            assert r[tag + "/iter_type"] == single[tag + "/iter_type"]
            _close_metrics(r[tag], single[tag], names, LOSS_RTOL, f"{world} {tag}")
            _close_params(r[tag + "/params"], single[tag + "/params"], single["init/params"],
                          f"{world} {tag}")
    init = dict(single["init/params"], emb_scales=single["init/emb_scales"])
    start = {n: init[n.removeprefix("subj_basis.")] for n in single["ema"]}
    assert len(start) == len(init)
    for r in worlds[world]:
        _close_params(r["ema"], single["ema"], start, f"{world} EMA")
