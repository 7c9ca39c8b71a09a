"""The port's static textual-inversion embedder and its recon step,
PromptConditioner, and the trainer's sample grid, against the JAX package
(tiny models of train_env, CPU, float32).

The static recon step gets the JAX step's draws (t and the noise, split
from its key as the JAX step splits them). log_samples is held against the
port's own parts composed by hand (face id -> Arc2Face -> the generator ->
PromptConditioner -> generate(seed=step) -> the teachability boxes), and
its PNG read back through PIL."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from adaprompt_tpu.adaface import conditioner as jcond, static_embedder as jse
from adaprompt_tpu.train import steps as jsteps, trainer as jtrainer
from adaprompt_tpu_torch.adaface import arc2face as tarc2face
from adaprompt_tpu_torch.adaface import conditioner as tcond, static_embedder as tse
from adaprompt_tpu_torch.adaface import subj_basis_generator as tsbg
from adaprompt_tpu_torch.models import vae as tvae
from adaprompt_tpu_torch.ops.layers import reset_parameters
from adaprompt_tpu_torch.pipeline import DEFAULT_NEGATIVE_PROMPT, StableDiffusionPipeline
from adaprompt_tpu_torch.train import steps as tsteps, trainer as ttrainer
from adaprompt_tpu_torch.utils.png import encode_png
from torch_port_helpers import TORCH_VAE, HIDDEN, keeping_grads, port_module, t, train_env
from torch_port_helpers import torch_threads  # noqa: F401

LOSS_RTOL = 1e-5    # fp32 through 2 CLIP layers and a UNet, as the zero-shot recon step's test
GRAD_TOL = 1e-5     # of the leaf's largest gradient, plus 1e-6 of the tree's
CAPTIONS = ["a photo of a z person", "a z in the park"]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return train_env(tmp_path_factory.mktemp("vocab"))


def _np_tree(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


# -- the static embedder -------------------------------------------------------------------

@pytest.mark.parametrize("n_init", [0, 2], ids=["basis-only", "pre_vecs"])
def test_static_embedder_forward_matches_jax(n_init):
    """forward() -> [L, K, D] on JAX's initial parameters (bias made
    nonzero), loaded through from_torch, to 1e-6; without and with the
    init-word basis vectors pre_vecs."""
    cfg_kw = dict(num_layers=16, num_vectors=3, out_emb_dim=64, rank=5)
    rng = np.random.default_rng(n_init)
    init = rng.standard_normal((n_init, 64)).astype(np.float32) if n_init else None
    jp = _np_tree(jse.init_params(jax.random.PRNGKey(3), jse.StaticEmbedderConfig(**cfg_kw),
                                  init_vecs=None if init is None else jnp.asarray(init)))
    jp["bias"] = 0.1 * rng.standard_normal(jp["bias"].shape).astype(np.float32)
    assert ("pre_vecs" in jp) == bool(n_init)
    want = np.asarray(jse.forward({k: jnp.asarray(v) for k, v in jp.items()},
                                  jse.StaticEmbedderConfig(**cfg_kw)))
    module = tse.from_torch({k: torch.from_numpy(v.copy()) for k, v in jp.items()},
                            tse.StaticEmbedderConfig())
    assert module.cfg == tse.StaticEmbedderConfig(**cfg_kw, num_init_vecs=n_init)
    got = module()
    assert got.shape == (16, 3, 64)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    assert set(dict(module.named_parameters())) == set(jp)


def test_static_embedder_init_rules_match_jax():
    """The initialization's rules, the draws aside (a torch.Generator in
    the port): shapes, the common weights 1/r, or 1/N over the init words
    and 0.4/N beyond (init_vec_weights where given), the init-word rows of
    the random weights scaled by 0.04 and the rest by 0.1, the basis
    vectors' norm 1/4 with the last one zero, pre_vecs the init words for
    every k, and a zero bias."""
    cfg = dict(num_layers=4, num_vectors=3, out_emb_dim=32, rank=6)
    init = np.random.default_rng(0).standard_normal((2, 32)).astype(np.float32)
    for init_vecs, weights in ((None, None), (init, None), (init, [0.7, 0.3])):
        jp = _np_tree(jse.init_params(
            jax.random.PRNGKey(1), jse.StaticEmbedderConfig(**cfg),
            init_vecs=None if init_vecs is None else jnp.asarray(init_vecs),
            init_vec_weights=weights))
        tm = tse.StaticLayerwiseEmbedding(
            tse.StaticEmbedderConfig(**cfg), torch.Generator().manual_seed(1),
            init_vecs=None if init_vecs is None else torch.from_numpy(init_vecs),
            init_vec_weights=weights)
        tp = {k: v.detach().numpy() for k, v in tm.named_parameters()}
        assert {k: v.shape for k, v in tp.items()} == {k: v.shape for k, v in jp.items()}
        for k in ("basis_comm_weights", "bias", "pre_vecs"):
            if k in jp:
                np.testing.assert_allclose(tp[k], jp[k], rtol=1e-7, atol=0, err_msg=k)
        for p in (tp, jp):
            norms = np.linalg.norm(p["basis_vecs"], axis=-1)
            np.testing.assert_allclose(norms[:-1], 0.25, rtol=1e-5)
            assert not p["basis_vecs"][-1].any()
            if init_vecs is not None:           # std 0.04 on the init rows, 0.1 beyond
                assert np.abs(p["basis_rand_weights"][..., :2]).max() < 0.04 * 6
                assert 0.1 * 6 > np.abs(p["basis_rand_weights"][..., 2:]).max() > 0.04 * 2
    again = tse.StaticLayerwiseEmbedding(tse.StaticEmbedderConfig(**cfg),
                                         torch.Generator().manual_seed(1))
    other = tse.StaticLayerwiseEmbedding(tse.StaticEmbedderConfig(**cfg),
                                         torch.Generator().manual_seed(2))
    assert torch.equal(again.basis_vecs, tse.StaticLayerwiseEmbedding(
        tse.StaticEmbedderConfig(**cfg), torch.Generator().manual_seed(1)).basis_vecs)
    assert not torch.equal(again.basis_vecs, other.basis_vecs)


# -- the static recon step -----------------------------------------------------------------

def _recon_batch(env, seed, b=2):
    rng = np.random.default_rng(seed)
    ids = np.asarray(env["jtok"](CAPTIONS))
    np.testing.assert_array_equal(ids, np.asarray(env["ttok"](CAPTIONS)))
    spec = jcond.make_placeholders(env["jtok"], ("z",), ())[0]
    bi, pos = jcond.find_placeholder_indices(ids, spec)
    assert list(bi) == [0, 1] and list(pos) == [5, 2]
    return {"z0": rng.standard_normal((b, 8, 8, 4)).astype(np.float32),
            "caption_ids": ids.astype(np.int32), "subj_bi": bi, "subj_pos": pos,
            "fg_mask": (rng.random((b, 8, 8, 1)) > 0.4).astype(np.float32),
            "aug_mask": (rng.random((b, 8, 8, 1)) > 0.2).astype(np.float32),
            "skip_weights": rng.dirichlet((1.0, 2.0, 2.0)).astype(np.float32)}


def test_static_recon_step_matches_jax(env):
    """Loss, gradient norm, every gradient of the StaticLayerwiseEmbedding
    and its parameters after one clip -> Prodigy update, with JAX's t and
    noise injected; the UNet under the augmentation mask."""
    scfg_kw = dict(num_layers=16, num_vectors=4, out_emb_dim=HIDDEN, rank=5)
    batch_np = _recon_batch(env, 4)
    key = jax.random.PRNGKey(8)
    jp = _np_tree(jse.init_params(jax.random.PRNGKey(2), jse.StaticEmbedderConfig(**scfg_kw)))
    jp["bias"] = 0.05 * np.random.default_rng(1).standard_normal(jp["bias"].shape).astype(
        np.float32)
    cfg = dict(grad_accum=1, max_steps=10, warm_up_steps=2)
    jopt = keeping_grads(jtrainer.build_optimizer(jtrainer.TrainerConfig(**cfg)))
    step_j = jax.jit(jtrainer.make_static_recon_step(
        jopt, env["jfrozen"], jse.StaticEmbedderConfig(**scfg_kw), compute_dtype=jnp.float32))
    trainable = {"static_emb": {k: jnp.asarray(v) for k, v in jp.items()}}
    jstate, metrics = step_j(jsteps.create_train_state(trainable, jopt),
                             jsteps.frozen_params(env["jfrozen"]),
                             {k: jnp.asarray(v) for k, v in batch_np.items()}, key)
    jgrads = _np_tree(jstate.opt_state[1]["static_emb"])
    jnew = _np_tree(jstate.params["static_emb"])

    module = tse.from_torch({k: torch.from_numpy(v.copy()) for k, v in jp.items()},
                            tse.StaticEmbedderConfig())
    params = {"static_emb": module}
    state = tsteps.TrainState(params, ttrainer.build_optimizer(
        ttrainer.TrainerConfig(**cfg), tsteps.trainable_parameters(params)))
    grads = {}
    for n, p in module.named_parameters():
        p.register_hook(lambda g, n=n: grads.__setitem__(n, g.clone()))
    step = ttrainer.make_static_recon_step(env["tfrozen"], module.cfg,
                                           compute_dtype=torch.float32)
    kt, kn = jax.random.split(key)
    draws = {"t": torch.from_numpy(np.array(jax.random.randint(kt, (2,), 0, 1000))).long(),
             "noise": t(jax.random.normal(kn, (2, 8, 8, 4), jnp.float32))}
    tbatch = {k: (torch.from_numpy(np.asarray(v)).long()
                  if k in ("caption_ids", "subj_bi", "subj_pos") else t(v))
              for k, v in batch_np.items()}
    state, tm = step(state, tsteps.frozen_params(env["tfrozen"]), tbatch, None, draws=draws)

    assert set(tm) == set(metrics) == {"loss", "loss_recon", "grad_norm"}
    assert float(metrics["loss"]) > 0
    for name in ("loss", "loss_recon"):
        np.testing.assert_allclose(float(tm[name]), float(metrics[name]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(metrics["grad_norm"]), rtol=1e-4)
    g_max = max(np.abs(g).max() for g in jgrads.values())
    for name, p in module.named_parameters():
        g_j, g_t = jgrads[name], grads[name].numpy()
        assert np.abs(g_j).max() > 0, name
        assert np.abs(g_t - g_j).max() <= GRAD_TOL * np.abs(g_j).max() + 1e-6 * g_max, name
        tol = 1e-2 * np.abs(jnew[name] - jp[name]).max() + 2 * np.spacing(
            np.abs(jp[name]).max())
        assert np.abs(p.detach().numpy() - jnew[name]).max() <= tol, name
        assert np.abs(jnew[name] - jp[name]).max() > 0, name


# -- PromptConditioner -----------------------------------------------------------------------

K = 4


def _conditioners(env):
    specs_j = jcond.make_placeholders(env["jtok"], ("z",), ("y",), num_vectors_subj=K,
                                      num_vectors_bg=2)
    specs_t = tcond.make_placeholders(env["ttok"], ("z",), ("y",), num_vectors_subj=K,
                                      num_vectors_bg=2)
    assert [s.token_id for s in specs_j] == [s.token_id for s in specs_t]
    return (jcond.PromptConditioner(env["jfrozen"].text, env["jtok"], specs_j, env["jt"]),
            tcond.PromptConditioner(env["tfrozen"].text, env["ttok"], specs_t))


PC_CASES = {
    # name: (prompts, {placeholder: rows, layers}, skip weights, layerwise)
    "layerwise-broadcast-absent": (["a photo of a z person", "a cat", "portrait of z smiling"],
                                   {"z": (1, 16), "y": (1, 16)}, (1.0, 1.0), None),
    "one-layer-per-row": (["a z in the park", "the face of a z"], {"z": (2, 1)},
                          (0.2, 0.3, 0.5), None),
    "tiled": (["a z", "z in the park", "a photo of z", "the z"], {"z": (2, 1)}, (1.0, 1.0),
              None),
    "forced-layerwise": (["a photo of a z person"], {"z": (1, 1)}, (1.0, 1.0), True),
    "no-embeddings": ([DEFAULT_NEGATIVE_PROMPT] * 2, {}, (1.0, 1.0), None),
}


@pytest.mark.parametrize("case", list(PC_CASES))
def test_prompt_conditioner_matches_jax(env, case):
    """Every branch: layerwise inferred from L' > 1 or forced, a placeholder
    absent from every prompt skipped, one row broadcast to every match,
    fewer rows than matches tiled, the batched L x B encode with the
    clip-skip weights -> [L, B, 77, D]."""
    prompts, embs, sw, layerwise = PC_CASES[case]
    pc_j, pc_t = _conditioners(env)
    rng = np.random.default_rng(len(case))
    arrays = {name: 0.1 * rng.standard_normal((m, lp, K, HIDDEN)).astype(np.float32)
              for name, (m, lp) in embs.items()}
    want = np.asarray(pc_j(prompts, {k: jnp.asarray(v) for k, v in arrays.items()},
                           skip_weights=sw, layerwise=layerwise))
    got = pc_t(prompts, {k: t(v) for k, v in arrays.items()}, skip_weights=sw,
               layerwise=layerwise)
    layers = 16 if (layerwise or any(lp > 1 for _, lp in embs.values())) else 1
    assert got.shape == want.shape == (layers, len(prompts), 77, HIDDEN)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=2e-5 * np.abs(want).max())
    if embs:      # the splice changed the context
        plain = np.asarray(pc_j(prompts, {}, skip_weights=sw, layerwise=layerwise))
        assert np.abs(plain - want).max() > 1e-3


# -- the sample grid -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sampler(env, tmp_path_factory):
    vae = reset_parameters(tvae.VAE(TORCH_VAE), torch.Generator().manual_seed(9)).eval()
    sbg = port_module(tsbg.SubjBasisGenerator(env["tscfg"]), env["jsp"])
    tr = ttrainer.AdaPromptTrainer(
        env["tfrozen"], vae, env["ttok"], env["tscfg"], sbg,
        ttrainer.synthetic_raw_batches(0, batch_size=2, size=32),
        ttrainer.TrainerConfig(out_dir=str(tmp_path_factory.mktemp("samples")),
                               compute_dtype="float32", seed=3), synthetic_faces=True)
    return tr


def _composed(tr, faceid, step, prompt, n):
    """log_samples' strip from the port's parts, composed by hand."""
    with torch.no_grad():
        _, core = tarc2face.forward_face_embs(tr.frozen.arc2face_text, tr.tokenizer,
                                              torch.from_numpy(faceid), input_max_length=21)
        subj, _ = tr.state.params["subj_basis"](tr.tokenizer, core, is_training=False)
        pc = tcond.PromptConditioner(tr.frozen.text, tr.tokenizer, [tr.subject_spec])
        cond = pc([prompt] * n, {tr.subject_spec.string: subj})
        uncond = pc([DEFAULT_NEGATIVE_PROMPT] * n, {})
    pipe = StableDiffusionPipeline(tr.frozen.unet, tr.vae, tr.frozen.text, tr.tokenizer)
    imgs = pipe.generate(None, context=cond, context_uncond=uncond, num_steps=3, height=32,
                         width=32, seed=step)
    assert cond.shape[0] == 16 and uncond.shape[0] == 1
    return np.concatenate(list(imgs), axis=1)


def test_log_samples_matches_its_parts(sampler):
    """The strip written to samples_gs-{step}.png equals the composed parts;
    the face id drawn from the host stream advances it as JAX's
    standard_normal((1, 512)) draw does; the PNG reads back through PIL."""
    tr = sampler
    stream = np.random.default_rng()
    stream.bit_generator.state = tr.rng.bit_generator.state
    faceid = stream.standard_normal((1, 512)).astype(np.float32)
    faceid /= np.linalg.norm(faceid, axis=-1, keepdims=True)
    path = tr.log_samples(7, num_steps=3, height=32, width=32)
    assert path.endswith("samples_gs-7.png")
    assert tr.rng.bit_generator.state == stream.bit_generator.state
    png = np.asarray(Image.open(path))
    assert png.shape == (32, 64, 3) and png.dtype == np.uint8
    np.testing.assert_array_equal(png, _composed(tr, faceid, 7, "a photo of a z", 2))
    assert png.std() > 0


def test_log_samples_teachability_boxes(sampler):
    """A given face id draws nothing from the host stream; after a
    compositional decision each image is boxed 6 pixels wide in its
    colour (purple: reuse teachable); the pipeline is built once."""
    tr = sampler
    faceid = np.random.default_rng(5).standard_normal((1, 512)).astype(np.float32)
    faceid /= np.linalg.norm(faceid)
    before = tr.rng.bit_generator.state
    tr._last_teach_color = 3
    try:
        png = np.asarray(Image.open(tr.log_samples(9, faceid=faceid, num_steps=3, height=32,
                                                   width=32, prompt="portrait of a z")))
    finally:
        del tr._last_teach_color
    pipe = tr._sample_pipe
    assert tr.rng.bit_generator.state == before
    plain = _composed(tr, faceid, 9, "portrait of a z", 2)
    box = np.zeros(png.shape[:2], bool)
    for x0 in (0, 32):
        box[:6, x0:x0 + 32] = box[-6:, x0:x0 + 32] = True
        box[:, x0:x0 + 6] = box[:, x0 + 26:x0 + 32] = True
    assert (png[box] == (160, 32, 240)).all()
    np.testing.assert_array_equal(png[~box], plain[~box])
    tr.log_samples(10, faceid=faceid, num_steps=1, height=32, width=32)
    assert tr._sample_pipe is pipe


def test_png_writer():
    """8-bit RGB through zlib: PIL reads back the array; other arrays are
    refused."""
    img = np.random.default_rng(0).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(encode_png(img)))), img)
    for bad in (img.astype(np.float32), img[..., 0]):
        with pytest.raises(ValueError):
            encode_png(bad)
