"""The product path as a whole, the port's AdaFacePipeline against the JAX
package's on shared weights (tiny models, float32, CPU): the prompt rewrite,
photos or a given face vector -> the 16 subject vectors and their token-table
rows, the noised face with JAX's draw injected, the cond/uncond encodings,
and the latents and images of `_generate` from the wrapper's cond/uncond
and a shared x_T."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaprompt_tpu import pipeline as jpipe
from adaprompt_tpu.adaface import wrapper as jwrap
from adaprompt_tpu_torch import pipeline as tpipe
from adaprompt_tpu_torch.adaface import wrapper as twrap
from adaprompt_tpu_torch.models import clip_text as tclip
from torch_port_helpers import (HIDDEN, JAX_VAE, TORCH_VAE, assert_close, t, train_env,
                                wrapper_env)
from torch_port_helpers import torch_threads  # noqa: F401

PROMPT = "portrait of a z person"
REL = 1e-4      # of the largest reference value: fp32 through 4 CLIP layers and the ArcFace trunk


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return wrapper_env(tmp_path_factory.mktemp("vocab"))


def _rel_close(got, want):
    want = np.asarray(want)
    assert np.abs(want).max() > 1e-3
    assert_close(got, want, atol=REL * np.abs(want).max())


def _photos(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (64, 64, 3)).astype(np.uint8) for _ in range(3)]


def _face(seed):
    f = np.random.default_rng(seed).standard_normal((1, 512)).astype(np.float32)
    return f / np.linalg.norm(f, axis=-1, keepdims=True)


@pytest.mark.parametrize("prompt", [PROMPT, "a painting in the style of monet",
                                    "z, a z-person and the wizard of oz",
                                    "z_0 z_1 z_2 z_3 z_4 z_5 z_6 z_7 z_8 z_9 z_10 z_11 z_12 "
                                    "z_13 z_14 z_15 at the beach"])
def test_update_prompt(env, prompt):
    """The three cases: 'z' replaced, no 'z' -> the tokens prepended, the
    tokens already there -> unchanged; token ids agree too."""
    jada, tada = env["jada"], env["tada"]
    assert tada.placeholder_tokens == jada.placeholder_tokens
    assert tada.placeholder_token_ids == jada.placeholder_token_ids
    assert tada.update_prompt(prompt) == jada.update_prompt(prompt)
    assert "z_0 z_1" in tada.update_prompt(prompt) and "z_15" in tada.update_prompt(prompt)
    np.testing.assert_array_equal(tada.pipe.tokenize([tada.update_prompt(prompt)]),
                                  jada.pipe.tokenize([jada.update_prompt(prompt)]))


@pytest.mark.parametrize("scale", [1.0, 0.7])
def test_subject_vectors_from_a_given_face(env, scale):
    jada, tada = env["jada"], env["tada"]
    face = _face(0)
    want = jada.generate_adaface_embeddings(pre_face_embs=jnp.asarray(face), gen_rand_face=True,
                                            out_id_embs_scale=scale)
    got = tada.generate_adaface_embeddings(pre_face_embs=t(face), gen_rand_face=True,
                                           out_id_embs_scale=scale)
    assert got.shape == (16, HIDDEN) and not got.requires_grad
    _rel_close(got, want)
    rows = tada.pipe.text.token_embedding[tada.placeholder_token_ids]
    assert torch.equal(rows, got)
    np.testing.assert_array_equal(
        np.asarray(jada.pipe.params.text["token_embedding"])[jada.placeholder_token_ids],
        np.asarray(want))


def test_subject_vectors_from_photos(env):
    """Photos through the shared tiny ArcFace trunk: the mean normalized
    face vector, then the same subject vectors; without an update the table
    keeps its rows; a pipeline that sees no face returns None."""
    jada, tada = env["jada"], env["tada"]
    photos = _photos(1)
    _rel_close(tada.extract_faceid_embeds(images_np=photos),
               jada.extract_faceid_embeds(images_np=photos))
    before = tada.pipe.text.token_embedding.detach().clone()
    want = jada.generate_adaface_embeddings(images_np=photos, update_text_encoder=False)
    got = tada.generate_adaface_embeddings(images_np=photos, update_text_encoder=False)
    _rel_close(got, want)
    assert torch.equal(tada.pipe.text.token_embedding, before)
    embedder, tada.face_embedder = tada.face_embedder, None
    try:
        assert tada.extract_faceid_embeds(images_np=photos) is None
        assert tada.generate_adaface_embeddings(images_np=photos) is None
        _rel_close(tada.generate_adaface_embeddings(images_np=photos, pre_face_embs=t(_face(2)),
                                                    update_text_encoder=False),
                   jada.generate_adaface_embeddings(pre_face_embs=jnp.asarray(_face(2)),
                                                    gen_rand_face=True,
                                                    update_text_encoder=False))
    finally:
        tada.face_embedder = embedder


def test_noised_face_with_the_jax_draw(env):
    """noise_level > 0 with the JAX package's own normal draw injected (the
    two generators differ); add_noise_keep_norm itself; and without an
    injected draw, a seeded, norm-keeping perturbation."""
    jada, tada = env["jada"], env["tada"]
    face, seed, level = _face(3), 5, 0.08
    _, key = jax.random.split(jax.random.PRNGKey(seed))    # the random face's key, unused
    k2, _ = jax.random.split(key)
    noise = np.asarray(jax.random.normal(k2, (1, 512), jnp.float32))
    assert_close(twrap.add_noise_keep_norm(t(face), level, noise=t(noise)),
                 jwrap.add_noise_keep_norm(k2, jnp.asarray(face), level), atol=1e-6)
    want = jada.generate_adaface_embeddings(pre_face_embs=jnp.asarray(face), gen_rand_face=True,
                                            noise_level=level, seed=seed,
                                            update_text_encoder=False)
    got = tada.generate_adaface_embeddings(pre_face_embs=t(face), gen_rand_face=True,
                                           noise_level=level, seed=seed, noise=t(noise),
                                           update_text_encoder=False)
    _rel_close(got, want)
    clean = tada.generate_adaface_embeddings(pre_face_embs=t(face), gen_rand_face=True,
                                             update_text_encoder=False)
    assert (got - clean).abs().max() > 10 * REL * clean.abs().max()     # the noise mattered
    a, b, c = (twrap.add_noise_keep_norm(t(face), level, torch.Generator().manual_seed(s))
               for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert_close(a.norm(dim=-1), np.ones(1, np.float32), atol=1e-5)


def test_random_face_is_seeded(env):
    tada = env["tada"]
    a, b, c = (tada.generate_adaface_embeddings(gen_rand_face=True, seed=s,
                                                update_text_encoder=False) for s in (4, 4, 5))
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.isfinite(a).all()


def test_encode_prompt_and_generate_match_jax(env):
    """After one personalization in both packages: cond and uncond, then the
    latents of the two `_generate` functions from the wrapper's cond/uncond
    tiled for 2 images and one shared x_T (<= 1e-4 absolute), and the uint8
    images within one level."""
    jada, tada = env["jada"], env["tada"]
    photos = _photos(6)
    jada.generate_adaface_embeddings(images_np=photos)
    tada.generate_adaface_embeddings(images_np=photos)
    (jc, ju), (tc, tu) = jada.encode_prompt(PROMPT), tada.encode_prompt(PROMPT)
    assert tc.shape == (1, 77, HIDDEN) and tu.shape == (1, 77, HIDDEN)
    _rel_close(tc, jc)
    _rel_close(tu, ju)
    plain = tada.pipe.encode_prompt([PROMPT])
    assert (tc - plain).abs().max() > 1e-2            # the subject tokens reached the encoder
    n = 2
    x_T = np.random.default_rng(0).standard_normal((n, 8, 8, 4)).astype(np.float32)
    args_j = (jnp.tile(jc, (n, 1, 1))[None], jnp.tile(ju, (n, 1, 1))[None], jnp.asarray(x_T), 3,
              (4.0, 2.0))
    args_t = (tc.repeat(n, 1, 1)[None], tu.repeat(n, 1, 1)[None], t(x_T), 3, (4.0, 2.0))
    jp, tp = jada.pipe, tada.pipe
    z_j = jpipe._generate_jit(jp.params.unet, jp.params.vae, *args_j, True, env["ju"], JAX_VAE,
                              jp.sched, jnp.float32)
    z_t = tpipe._generate(tp.unet, tp.vae, *args_t, True, tp.sched, torch.float32)
    assert_close(z_t, z_j, atol=1e-4, rtol=1e-5)
    img_j = np.asarray(jpipe._generate_jit(jp.params.unet, jp.params.vae, *args_j, False,
                                           env["ju"], JAX_VAE, jp.sched, jnp.float32))
    img_t = tpipe._generate(tp.unet, tp.vae, *args_t, False, tp.sched, torch.float32).numpy()
    assert img_t.shape == (n, 64, 64, 3) and img_t.dtype == np.uint8 and img_t.std() > 0
    assert np.abs(img_t.astype(np.int32) - img_j.astype(np.int32)).max() <= 1


def test_call_and_warmup(env):
    """__call__ through the public generate: shape, seeding, the sampler
    and `fast=` passed through; warmup leaves a usable pipeline."""
    tada = env["tada"]
    kw = dict(out_image_count=2, num_steps=2, height=64, width=64)
    a, b, c = tada(PROMPT, seed=1, **kw), tada(PROMPT, seed=1, **kw), tada(PROMPT, seed=2, **kw)
    assert a.shape == (2, 64, 64, 3) and a.dtype == np.uint8 and a.std() > 0
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()
    cond, uncond = tada.encode_prompt(PROMPT)
    ref = tada.pipe.generate(None, context=cond.repeat(2, 1, 1)[None],
                             context_uncond=uncond.repeat(2, 1, 1)[None], num_steps=2,
                             guidance_scale=4.0, height=64, width=64, seed=1)
    np.testing.assert_array_equal(a, ref)
    d = tada(PROMPT, seed=1, sampler="dpmpp", fast=tpipe.FastConfig(), **dict(kw, num_steps=4))
    assert d.shape == a.shape and d.std() > 0 and (d != a).any()
    rows = tada.pipe.text.token_embedding[tada.placeholder_token_ids].clone()
    tada.warmup(out_image_counts=(1,), num_steps=1, height=64, width=64)
    assert not torch.equal(tada.pipe.text.token_embedding[tada.placeholder_token_ids], rows)


def test_token_table_grows_by_zero_rows(tmp_path):
    """A text encoder whose table ends at the base vocabulary gains 16 zero
    rows, keeps its old rows and its requires_grad, as the JAX table does;
    a second pipeline over the same tokenizer and encoder adds nothing."""
    e = train_env(tmp_path)
    tok, base = e["ttok"], e["ttok"].vocab_size_with_added
    cfg = tclip.CLIPTextConfig(vocab_size=base, hidden_size=HIDDEN, intermediate_size=64,
                               num_layers=1, num_heads=8, eos_token_id=tok.eos_id)
    text = tclip.CLIPTextModel(cfg)
    with torch.no_grad():
        text.token_embedding.normal_()
    old = text.token_embedding.detach().clone()
    text.token_embedding.requires_grad_(True)
    tf = e["tfrozen"]
    pipe = tpipe.StableDiffusionPipeline(tf.unet, None, text, tok)
    from adaprompt_tpu_torch.adaface.subj_basis_generator import SubjBasisGenerator
    sbg = SubjBasisGenerator(e["tscfg"])
    ada = twrap.AdaFacePipeline(pipe, sbg, None, tf.arc2face_text)
    table = text.token_embedding
    assert table.shape == (base + 16, HIDDEN) and table.requires_grad
    assert torch.equal(table[:base], old) and not table[base:].any()
    assert ada.placeholder_token_ids == list(range(base, base + 16))
    jtable = jnp.zeros((base, HIDDEN))
    assert jnp.concatenate([jtable, jnp.zeros((16, HIDDEN))]).shape == tuple(table.shape)
    twrap.AdaFacePipeline(pipe, sbg, e["tscfg"], tf.arc2face_text, tf.arc2face_text.cfg)
    assert text.token_embedding is table and tok.vocab_size_with_added == base + 16
    with pytest.raises(ValueError, match="configuration"):
        twrap.AdaFacePipeline(pipe, sbg, e["tscfg"], tf.arc2face_text, cfg)


def test_random_init_on_cpu_and_default_device():
    from adaprompt_tpu_torch.models import arcface as taf, unet as tunet
    from adaprompt_tpu_torch.utils.tokenizer import CLIPTokenizer
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            twrap.AdaFacePipeline.random_init(0, unet_cfg=tunet.UNetConfig(fused_conv=True))
    text = tclip.CLIPTextConfig(hidden_size=576, intermediate_size=64, num_layers=3, num_heads=8)
    ada = twrap.AdaFacePipeline.random_init(
        0, device="cpu", dtype=torch.float32, text_cfg=text, vae_cfg=TORCH_VAE,
        unet_cfg=tunet.UNetConfig(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                                  attention_ds=(1, 2), num_heads=4, context_dim=576,
                                  fused_conv=True),
        arcface_cfg=taf.IResNetConfig(layers=(1, 1, 1, 1), planes=(8, 8, 8, 8)),
        tokenizer=CLIPTokenizer.fallback())
    assert ada.pipe.unet_cfg.fused_conv and ada.device.type == "cpu"
    embs = ada.generate_adaface_embeddings(images_np=_photos(0))
    assert embs.shape == (16, 576) and torch.isfinite(embs).all()
    imgs = ada(PROMPT, out_image_count=1, num_steps=1, height=64, width=64)
    assert imgs.shape == (1, 64, 64, 3) and imgs.std() > 0
