"""Shared pieces of the port's parity tests (tests/test_torch_*.py): tiny
configurations for both packages, and JAX parameter trees with every
zero-initialized leaf re-randomized, so that no layer (the UNet's
zero_module convs above all) makes a parity test pass vacuously."""

import contextlib

import jax
import numpy as np
import optax
import pytest
import torch

from adaprompt_tpu.adaface import subj_basis_generator as jsbg
from adaprompt_tpu.models import arcface as jarcface
from adaprompt_tpu.models import clip_text as jclip, unet as junet, vae as jvae
from adaprompt_tpu.train import steps as jsteps
from adaprompt_tpu_torch import convert
from adaprompt_tpu_torch.adaface import subj_basis_generator as tsbg
from adaprompt_tpu_torch.adaface.checkpoint import module_tree
from adaprompt_tpu_torch.models import arcface as tarcface
from adaprompt_tpu_torch.models import clip_text as tclip, unet as tunet, vae as tvae
from adaprompt_tpu_torch.ops.layers import reset_parameters
from adaprompt_tpu_torch.ops.tome import _partition as tome_partition
from adaprompt_tpu_torch.ops.tome import quantize_merge_count as tome_merge_count
from adaprompt_tpu_torch.train import steps as tsteps
from adaprompt_tpu_torch.utils.tokenizer import CLIPTokenizer as TorchTokenizer
from adaface_fixtures import build_word_vocab

# intra-op threads of torch in each port test module (`torch_threads`); a
# module may set its own count as `TORCH_THREADS`
TEST_THREADS = 1


# (what, error, bound) of every `within` check, for tools/thread_margins.py
MARGINS = []


@contextlib.contextmanager
def numpy_random_normal(seed=0):
    """`jax.random.normal` drawing from a seeded numpy generator for as long
    as the context lasts: a JAX `init_params` then builds its very tree
    without compiling a random kernel for each of its parameter shapes
    (~15 s for a BiSeNet, a RetinaFace or a small IResNet on the CPU)."""
    rng = np.random.default_rng(seed)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", lambda key, shape, dtype=np.float32:
                   rng.standard_normal(shape).astype(dtype))
        yield


def within(err, bound, what):
    """assert err <= bound, keeping both in MARGINS."""
    MARGINS.append((what, float(err), float(bound)))
    assert err <= bound, f"{what}: {err} > {bound}"


@pytest.fixture(scope="module", autouse=True)
def torch_threads(request):
    """TEST_THREADS intra-op threads (or the module's TORCH_THREADS) for the
    test module that imports this fixture: under the suite's parallel
    workers on a few cores, torch's default pool (a thread a core in every
    worker) oversubscribes the CPU and the small-tensor steps of these tests
    slow down many-fold (six copies of one resume test: 2,250 s with 8
    threads each, 54 s with 1)."""
    n = torch.get_num_threads()
    torch.set_num_threads(getattr(request.module, "TORCH_THREADS", TEST_THREADS))
    yield
    torch.set_num_threads(n)


JAX_UNET = junet.UNetConfig(model_channels=32, channel_mult=(1, 2, 4, 4), num_res_blocks=2,
                            attention_ds=(1, 2, 4), num_heads=4, context_dim=64,
                            use_checkpoint=False)
TORCH_UNET = tunet.UNetConfig(model_channels=32, channel_mult=(1, 2, 4, 4), num_res_blocks=2,
                              attention_ds=(1, 2, 4), num_heads=4, context_dim=64)
JAX_VAE = jvae.VAEConfig(ch=32, ch_mult=(1, 2, 4, 4), num_res_blocks=1)
TORCH_VAE = tvae.VAEConfig(ch=32, ch_mult=(1, 2, 4, 4), num_res_blocks=1)
JAX_TEXT = jclip.CLIPTextConfig(vocab_size=49408, hidden_size=64, intermediate_size=128,
                                num_layers=2, num_heads=4)
TORCH_TEXT = tclip.CLIPTextConfig(vocab_size=49408, hidden_size=64, intermediate_size=128,
                                  num_layers=2, num_heads=4)


def randomized(tree, seed):
    """numpy copy of a JAX pytree; all-zero leaves become uniform noise
    (kernels at +-1/sqrt(fan_in), vectors at +-0.1)."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree.flatten(tree)
    out = []
    for leaf in leaves:
        a = np.asarray(leaf, np.float32)
        if not a.any():
            bound = 1.0 / np.sqrt(np.prod(a.shape[:-1])) if a.ndim > 1 else 0.1
            a = rng.uniform(-bound, bound, a.shape).astype(np.float32)
        out.append(a)
    return jax.tree.unflatten(treedef, out)


def port_module(module, np_tree):
    """Load a JAX numpy tree into the port's module (strict)."""
    module.load_state_dict(convert.from_jax_params(np_tree), strict=True)
    return module.eval()


def tiny_models(seed=0):
    """(jax unet, vae, text params as numpy trees; port unet, vae, text
    modules on the CPU in float32), all holding the same weights."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    ju = randomized(junet.init_params(k1, JAX_UNET), seed + 1)
    jv = randomized(jvae.init_params(k2, JAX_VAE), seed + 2)
    jt = randomized(jclip.init_params(k3, JAX_TEXT), seed + 3)
    tu = port_module(tunet.UNet(TORCH_UNET, device="cpu"), ju)
    tv = port_module(tvae.VAE(TORCH_VAE, device="cpu"), jv)
    tt = port_module(tclip.CLIPTextModel(TORCH_TEXT, device="cpu"), jt)
    return (ju, jv, jt), (tu, tv, tt)


def named(tree):
    """A JAX tree's leaves as numpy arrays under the port's parameter names."""
    return {k: v.numpy() for k, v in convert.from_jax_params(
        jax.tree.map(np.asarray, tree)).items()}


def t(a):
    """numpy / JAX array -> float32 CPU tensor."""
    return torch.from_numpy(np.array(a, np.float32))


def merge_gaps(x, h, w, ratio, align=256):
    """The margins of ToMe's decisions on metric x [B, N, C] (float64):
    (the least gap between the best and the second-best destination score
    of any merged source, the gap in the sorted best scores at the merge
    boundary r). Where both exceed the two packages' fp32 rounding of the
    scores, both make the same merges."""
    src, dst = tome_partition(h, w, 2, 2)
    r = tome_merge_count(h * w, ratio, len(src), align)
    m = x.double()
    m = m / (m.norm(dim=-1, keepdim=True) + 1e-6)
    scores = torch.einsum("bsc,bdc->bsd", m[:, src], m[:, dst])
    top2 = scores.topk(2, dim=-1).values
    best = top2[..., 0].sort(dim=-1, descending=True)
    merged = best.indices[:, :r]
    top2_gap = torch.gather(top2[..., 0] - top2[..., 1], 1, merged).min().item()
    boundary = (best.values[:, r - 1] - best.values[:, r]).min().item()
    return top2_gap, boundary


def assert_close(actual, expected, atol, rtol=0.0):
    a = actual.detach().cpu().numpy() if isinstance(actual, torch.Tensor) else np.asarray(actual)
    np.testing.assert_allclose(a, np.asarray(expected), atol=atol, rtol=rtol)


# -- Stage-1 training ----------------------------------------------------------

HIDDEN = 576       # the 512-d face vector is zero-padded into the text width
VOCAB = 1024       # the word vocabulary of adaface_fixtures has ~600 tokens


def _train_cfgs(eos):
    jt = jclip.CLIPTextConfig(vocab_size=VOCAB, hidden_size=HIDDEN, intermediate_size=2 * HIDDEN,
                              num_layers=2, num_heads=8, eos_token_id=eos)
    tt = tclip.CLIPTextConfig(vocab_size=VOCAB, hidden_size=HIDDEN, intermediate_size=2 * HIDDEN,
                              num_layers=2, num_heads=8, eos_token_id=eos)
    unet = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1, attention_ds=(1, 2),
                num_heads=4, context_dim=HIDDEN)
    return jt, tt, junet.UNetConfig(**unet, use_checkpoint=False), tunet.UNetConfig(**unet)


def keeping_grads(tx):
    """optax `tx` that also keeps the gradients it was given in its state, so
    a JAX step hands them back beside the updated parameters."""
    def update(g, state, params=None):
        upd, inner = tx.update(g, state[0], params)
        return upd, (inner, g)
    return optax.GradientTransformation(
        lambda p: (tx.init(p), jax.tree.map(jax.numpy.zeros_like, p)), update)


def train_env(d):
    """Tiny Stage-1 models in both packages, holding the same weights:
    the frozen UNets and text encoders, the SubjBasisGenerator tree, and
    one word vocabulary (written into directory `d`) for both tokenizers."""
    jtok = build_word_vocab(d)
    ttok = TorchTokenizer.from_files(str(d / "vocab.json"), str(d / "merges.txt"))
    jt, tt, ju, tu = _train_cfgs(jtok.eos_id)
    # random weights made by the port (jax.random would compile an init per
    # leaf shape), in the JAX layout, with every zero leaf re-randomized
    gen = torch.Generator().manual_seed(0)
    tree = lambda module, seed: jax.tree.map(jax.numpy.asarray, randomized(
        module_tree(reset_parameters(module, gen)), seed))
    jscfg = jsbg.SubjBasisConfig(output_dim=HIDDEN, text_cfg=jt)
    tscfg = tsbg.SubjBasisConfig(output_dim=HIDDEN, text_cfg=tt)
    jp = {"unet": tree(tunet.UNet(tu), 1), "text": tree(tclip.CLIPTextModel(tt), 2),
          "arc2face_text": tree(tclip.CLIPTextModel(tt), 3),
          "teacher_unet": tree(tunet.UNet(tu), 4)}
    jsp = tree(tsbg.SubjBasisGenerator(tscfg), 5)
    jfrozen = jsteps.FrozenSD(unet=jp["unet"], text=jp["text"], arc2face_text=jp["arc2face_text"],
                              teacher_unet=jp["teacher_unet"], unet_cfg=ju, text_cfg=jt,
                              arc2face_text_cfg=jt)
    tfrozen = tsteps.FrozenSD(port_module(tunet.UNet(tu), jp["unet"]),
                              port_module(tclip.CLIPTextModel(tt), jp["text"]),
                              port_module(tclip.CLIPTextModel(tt), jp["arc2face_text"]),
                              port_module(tunet.UNet(tu), jp["teacher_unet"]))
    return dict(jtok=jtok, ttok=ttok, jfrozen=jfrozen, tfrozen=tfrozen, jscfg=jscfg,
                tscfg=tscfg, jsp=jsp, ju=ju, jt=jt)


# -- ArcFace ---------------------------------------------------------------------

def arcface_pair(seed, **cfg):
    """(JAX ArcFace params, JAX config, the port's ArcFace module on the
    CPU) holding the same weights: the JAX init with every BatchNorm's
    affine and running statistics and every PReLU slope perturbed, so that
    none of them is an identity."""
    jcfg = jarcface.IResNetConfig(**cfg)
    rng = np.random.default_rng(seed)

    def perturb(tree):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                if isinstance(v, (dict, list)):
                    out[k] = perturb(v)
                else:
                    a = np.asarray(v, np.float32)
                    if a.ndim == 1:
                        a = a + 0.2 * rng.standard_normal(a.shape).astype(np.float32)
                        a = np.abs(a) + 0.3 if k == "var" else a
                    out[k] = a
            return out
        return [perturb(v) for v in tree]

    jp = perturb(jarcface.init_params(jax.random.PRNGKey(seed), jcfg))
    model = port_module(tarcface.ArcFace(tarcface.IResNetConfig(**cfg), device="cpu"), jp)
    return jax.tree.map(jax.numpy.asarray, jp), jcfg, model


# -- the product path ------------------------------------------------------------------

ARCFACE_TINY = dict(layers=(1, 1, 1, 1), planes=(8, 8, 16, 16), num_features=512, input_size=32)


def wrapper_env(d):
    """Both packages' AdaFacePipeline over the tiny Stage-1 models of
    `train_env` (same weights, one word vocabulary, float32, CPU), a tiny
    VAE and a shared tiny ArcFace trunk behind centre-crop embedders."""
    from adaprompt_tpu import pipeline as jpipe
    from adaprompt_tpu.adaface import wrapper as jwrap
    from adaprompt_tpu.eval import face_eval as jfe
    from adaprompt_tpu_torch import pipeline as tpipe
    from adaprompt_tpu_torch.adaface import wrapper as twrap
    from adaprompt_tpu_torch.eval import face_eval as tfe
    env = train_env(d)
    jv = randomized(jvae.init_params(jax.random.PRNGKey(7), JAX_VAE), 8)
    tv = port_module(tvae.VAE(TORCH_VAE, device="cpu"), jv)
    jf, tf = env["jfrozen"], env["tfrozen"]
    jp = jpipe.StableDiffusionPipeline(
        jpipe.SDParams(unet=jf.unet, vae=jax.tree.map(jax.numpy.asarray, jv), text=dict(jf.text)),
        tokenizer=env["jtok"], unet_cfg=env["ju"], vae_cfg=JAX_VAE, text_cfg=env["jt"],
        compute_dtype=jax.numpy.float32)
    tp = tpipe.StableDiffusionPipeline(tf.unet, tv, tf.text, env["ttok"])
    ja, jacfg, ta = arcface_pair(9, **ARCFACE_TINY)
    crop = lambda im: jfe.center_crop_detector(im, ARCFACE_TINY["input_size"])
    jada = jwrap.AdaFacePipeline(jp, env["jsp"], env["jscfg"], jf.arc2face_text, env["jt"],
                                 face_embedder=jfe.FaceSimilarityEvaluator(ja, jacfg,
                                                                           detector=crop))
    sbg = port_module(tsbg.SubjBasisGenerator(env["tscfg"]), jax.tree.map(np.asarray, env["jsp"]))
    tada = twrap.AdaFacePipeline(tp, sbg, env["tscfg"], tf.arc2face_text, tf.arc2face_text.cfg,
                                 face_embedder=tfe.FaceSimilarityEvaluator(ta))
    return dict(env, jada=jada, tada=tada)


# -- the evaluation path -------------------------------------------------------------

EVAL_VIT = dict(image_size=32, patch_size=8, hidden_size=64, intermediate_size=128,
                num_layers=2, num_heads=4)
EVAL_CLIP_VISION = dict(EVAL_VIT, projection_dim=32)
EVAL_CLIP_TEXT = dict(hidden_size=48, intermediate_size=96, num_layers=2, num_heads=4)


def dino_pair(seed):
    """(JAX DINO params, JAX config, the port's DINO on the CPU): the tiny
    ViT of EVAL_VIT on the same weights, zero biases re-randomized."""
    from adaprompt_tpu.models import dino as jdino
    from adaprompt_tpu_torch.models import dino as tdino
    jcfg = jdino.ViTConfig(**EVAL_VIT)
    jp = randomized(jdino.init_params(jax.random.PRNGKey(seed), jcfg), seed + 1)
    tm = port_module(tdino.DINO(tdino.ViTConfig(**EVAL_VIT), device="cpu"), jp)
    return jax.tree.map(jax.numpy.asarray, jp), jcfg, tm


def scorer_pair(jtok, ttok, seed):
    """Both packages' CLIPScorer over tiny text and vision towers
    (EVAL_CLIP_TEXT, EVAL_CLIP_VISION) on the same weights, each with its
    own tokenizer of one vocabulary."""
    from adaprompt_tpu.eval import clip_scorer as jscorer
    from adaprompt_tpu.models import clip_vision as jcv
    from adaprompt_tpu_torch.eval import clip_scorer as tscorer
    from adaprompt_tpu_torch.models import clip_vision as tcv
    jtcfg = jclip.CLIPTextConfig(vocab_size=VOCAB, **EVAL_CLIP_TEXT, eos_token_id=jtok.eos_id)
    jvcfg = jcv.CLIPVisionConfig(**EVAL_CLIP_VISION)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    tree = {"text": randomized(jclip.init_params(k1, jtcfg), seed + 1),
            "text_projection": np.asarray(jax.random.normal(k3, (48, 32)) * 0.02, np.float32),
            "vision": randomized(jcv.init_params(k2, jvcfg), seed + 2)}
    jp = jscorer.CLIPScorerParams(text=jax.tree.map(jax.numpy.asarray, tree["text"]),
                                  text_projection=jax.numpy.asarray(tree["text_projection"]),
                                  vision=jax.tree.map(jax.numpy.asarray, tree["vision"]))
    ts = port_module(tscorer.CLIPScorer(
        ttok, tclip.CLIPTextConfig(vocab_size=VOCAB, **EVAL_CLIP_TEXT, eos_token_id=ttok.eos_id),
        tcv.CLIPVisionConfig(**EVAL_CLIP_VISION), device="cpu"), tree)
    return jscorer.CLIPScorer(jp, jtok, jtcfg, jvcfg), ts
