"""Port models vs the JAX package on shared weights (tiny configs, CPU,
float32): layers, CLIP text, UNet, VAE, and the tokenizer. Weights are the
JAX package's init with every zero leaf re-randomized, converted by
convert.from_jax_params."""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from adaprompt_tpu.models import clip_text as jclip, unet as junet, vae as jvae
from adaprompt_tpu.ops import layers as jlayers
from adaprompt_tpu.pipeline import DEFAULT_NEGATIVE_PROMPT
from adaprompt_tpu.utils.tokenizer import CLIPTokenizer as JaxTokenizer
from adaprompt_tpu_torch.ops import layers as tlayers
from adaprompt_tpu_torch.utils.tokenizer import CLIPTokenizer as TorchTokenizer
from torch_port_helpers import JAX_TEXT, JAX_UNET, JAX_VAE, assert_close, t, tiny_models


@pytest.fixture(scope="module")
def models():
    return tiny_models(0)


# -- layers -------------------------------------------------------------------

@pytest.mark.parametrize("activation,eps", [(None, 1e-6), ("silu", 1e-5)])
def test_group_norm(activation, eps):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 5, 64)).astype(np.float32) * 3 + 1
    w, b = rng.standard_normal(64).astype(np.float32), rng.standard_normal(64).astype(np.float32)
    out_j = jlayers.group_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), eps=eps,
                               activation=activation)
    out_t = tlayers.group_norm(t(x), t(w), t(b), eps=eps, activation=activation)
    assert_close(out_t, out_j, atol=1e-5)


def test_layer_norm_linear_conv():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    w, b = rng.standard_normal(16).astype(np.float32), rng.standard_normal(16).astype(np.float32)
    assert_close(tlayers.layer_norm(t(x), t(w), t(b)),
                 jlayers.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)), atol=1e-5)
    lw = rng.standard_normal((16, 24)).astype(np.float32)          # JAX [in, out]
    lb = rng.standard_normal(24).astype(np.float32)
    assert_close(tlayers.linear(t(x), t(lw.T), t(lb)),
                 jlayers.linear(jnp.asarray(x), jnp.asarray(lw), jnp.asarray(lb)), atol=1e-4)
    cw = rng.standard_normal((3, 3, 16, 8)).astype(np.float32)     # HWIO
    cb = rng.standard_normal(8).astype(np.float32)
    tw = t(cw.transpose(3, 2, 0, 1)).contiguous(memory_format=torch.channels_last)
    for stride, pad in [(1, 1), (2, 1), (2, ((0, 1), (0, 1)))]:
        out_j = jlayers.conv2d(jnp.asarray(x), jnp.asarray(cw), jnp.asarray(cb), stride=stride,
                               padding=pad)
        out_t = tlayers.conv2d(t(x), tw, t(cb), stride=stride, padding=pad)
        assert_close(out_t, out_j, atol=1e-4)
    assert_close(tlayers.quick_gelu(t(x)), jlayers.quick_gelu(jnp.asarray(x)), atol=1e-6)
    assert_close(tlayers.gelu(t(x)), jlayers.gelu(jnp.asarray(x)), atol=1e-6)


# -- CLIP text ------------------------------------------------------------------

@pytest.mark.parametrize("skip_weights", [None, (1.0, 1.0), (0.2, 0.3, 0.5)])
def test_clip_encode(models, skip_weights):
    (_, _, jt), (_, _, tt) = models
    ids = np.asarray(TorchTokenizer.fallback()(["a photo of a cat", "2 dogs, 1 ball!"]))
    w = None if skip_weights is None else np.asarray(skip_weights, np.float32)
    out_j, pooled_j = jclip.encode(jt, jnp.asarray(ids), cfg=JAX_TEXT, return_pooled=True,
                                   hidden_state_layer_weights=None if w is None else jnp.asarray(w))
    with torch.no_grad():
        out_t, pooled_t = tt.encode(torch.from_numpy(ids).long(), return_pooled=True,
                                    hidden_state_layer_weights=None if w is None else t(w))
    assert out_t.shape == (2, 77, 64)
    assert_close(out_t, out_j, atol=2e-5)
    assert_close(pooled_t, pooled_j, atol=2e-5)


def test_clip_inputs_embeds(models):
    (_, _, jt), (_, _, tt) = models
    rng = np.random.default_rng(2)
    ids = np.asarray(TorchTokenizer.fallback()(["z z z"]))
    embeds = rng.standard_normal((1, 77, 64)).astype(np.float32) * 0.02
    w = np.asarray([1.0, 1.0], np.float32)
    out_j = jclip.encode(jt, jnp.asarray(ids), cfg=JAX_TEXT, inputs_embeds=jnp.asarray(embeds),
                         hidden_state_layer_weights=jnp.asarray(w))
    with torch.no_grad():
        out_t = tt.encode(torch.from_numpy(ids).long(), inputs_embeds=t(embeds),
                          hidden_state_layer_weights=t(w))
    assert_close(out_t, out_j, atol=2e-5)


# -- UNet -------------------------------------------------------------------------

def _unet_inputs(rng, b=2, hw=32, L=16):
    x = rng.standard_normal((b, hw, hw, 4)).astype(np.float32)
    ts = np.asarray([981, 21][:b], np.int32)
    ctx = (rng.standard_normal((L, b, 77, 64)) * 0.5).astype(np.float32)
    return x, ts, ctx


@pytest.mark.parametrize("hoisted,masked", [(False, False), (True, False), (True, True)])
def test_unet_forward_layerwise_context(models, hoisted, masked):
    """L=16 layerwise contexts; with K/V hoisted by precompute_cross_kv the
    port takes its fused cross-attention path at the 1024-token layers (the
    JAX CPU path runs unfused); with an img_mask, self-attention takes a key
    bias. Both packages agree."""
    (ju, _, _), (tu, _, _) = models
    rng = np.random.default_rng(3)
    x, ts, ctx = _unet_inputs(rng)
    mask = None
    if masked:
        mask = np.zeros((2, 256, 256, 1), np.float32)
        mask[:, 40:230, 16:200] = 1.0
    kv_j = junet.precompute_cross_kv(ju, jnp.asarray(ctx), cfg=JAX_UNET) if hoisted else None
    eps_j = junet.forward(ju, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
                          cross_kv=kv_j, img_mask=None if mask is None else jnp.asarray(mask),
                          cfg=JAX_UNET)
    with torch.no_grad():
        kv_t = tu.precompute_cross_kv(t(ctx)) if hoisted else None
        if hoisted:
            for li, (k, v) in kv_t.items():
                assert_close(k, kv_j[li][0], atol=1e-5)
                assert_close(v, kv_j[li][1], atol=1e-5)
        eps_t = tu(t(x), torch.from_numpy(ts), t(ctx), cross_kv=kv_t,
                   img_mask=None if mask is None else t(mask))
    assert eps_t.shape == x.shape
    assert float(np.abs(np.asarray(eps_j)).max()) > 1e-2     # not a vacuous zero eps
    assert_close(eps_t, eps_j, atol=2e-4, rtol=1e-4)


def test_unet_img_mask_and_context_k(models):
    """img_mask -> per-key bias on self-attention (the flash path at 1024
    tokens), plus a separate K context."""
    (ju, _, _), (tu, _, _) = models
    rng = np.random.default_rng(4)
    x, ts, ctx = _unet_inputs(rng, L=1)
    ctx_k = (rng.standard_normal(ctx.shape) * 0.5).astype(np.float32)
    mask = np.zeros((2, 256, 256, 1), np.float32)
    mask[:, 32:200, 64:220] = 1.0
    eps_j = junet.forward(ju, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
                          context_k=jnp.asarray(ctx_k), img_mask=jnp.asarray(mask), cfg=JAX_UNET)
    with torch.no_grad():
        eps_t = tu(t(x), torch.from_numpy(ts), t(ctx), context_k=t(ctx_k), img_mask=t(mask))
    assert_close(eps_t, eps_j, atol=2e-4, rtol=1e-4)


def test_unet_unported_options_raise(models):
    """What the UNet still refuses: activation capture with DeepCache (a
    sampler-only path, as the JAX package asserts) and an unknown quant."""
    _, (tu, _, _) = models
    x = torch.zeros(1, 8, 8, 4)
    with pytest.raises(ValueError, match="deep-cache"):
        tu(x, torch.zeros(1), torch.zeros(1, 77, 64), capture_ca=True, cache_depth=2)
    with pytest.raises(ValueError, match="unknown quant"):
        tu(x, torch.zeros(1), torch.zeros(1, 77, 64),
           cfg=dataclasses.replace(tu.cfg, quant="int4"))


def test_unet_fused_conv(models, monkeypatch):
    """UNetConfig(fused_conv=True) in bf16 on the CPU, the eligibility table
    patched to the tiny UNet's counterparts of the three SD-1.5 shapes: the
    fused GroupNorm-SiLU-conv (here its plain version) takes exactly the
    eligible ResBlock convs, with the weights packed once per pass, and the
    output stays within 2e-2 relative L2 of the unfused bf16 forward (which
    normalizes in bf16 where the fused form normalizes in float32). In
    float32 nothing is eligible, as in the JAX package."""
    import dataclasses
    from adaprompt_tpu_torch.models import unet as tunet
    from adaprompt_tpu_torch.ops import conv_halo as tch
    _, (tu, _, _) = models
    shapes = tunet.resblock_conv_shapes(tu.cfg, 32)
    assert len(shapes) == 44
    sd_shapes = tunet.resblock_conv_shapes(tunet.SD15_UNET_CONFIG, 64)
    assert sum(s in tch._FUSED_TABLE for s in sd_shapes) == 9       # 7 + 1 + 1
    table = {(32, 32, 32), (16, 32, 64), (16, 96, 64)}                # SD's keys at 1/10 width
    monkeypatch.setattr(tch, "_FUSED_TABLE", table)
    want = sum(s in table for s in shapes)
    assert want == 9
    calls, packs = [], []
    plain, pack = tch.gn_silu_conv3x3_halo_reference, tch.pack_conv_weight
    monkeypatch.setattr(tch, "gn_silu_conv3x3_halo_reference",
                        lambda x, *a, **k: calls.append(tuple(x.shape[1:])) or plain(x, *a, **k))
    monkeypatch.setattr(tch, "pack_conv_weight", lambda w: packs.append(1) or pack(w))
    rng = np.random.default_rng(11)
    x, ts, ctx = _unet_inputs(rng, L=1)
    bf = torch.bfloat16
    model = tunet.UNet(tu.cfg).to(bf)
    model.load_state_dict({k: v.to(bf) for k, v in tu.state_dict().items()})
    fused = dataclasses.replace(tu.cfg, fused_conv=True)
    args = (t(x).to(bf), torch.from_numpy(ts), t(ctx).to(bf))
    with torch.no_grad():
        eps = model(*args).float()
        assert not calls and not packs
        eps_fused = model(*args, cfg=fused).float()
        assert len(calls) == want and len(packs) == want
        assert sorted(c[0] for c in calls) == [16, 16] + [32] * 7
        hoisted = model.pack_fused_conv_weights()
        assert len(hoisted) == want
        eps_hoisted = model(*args, cfg=fused, fused_conv_weights=hoisted).float()
        assert len(calls) == 2 * want and len(packs) == 2 * want    # none packed in the pass
        ref = tu(t(x), torch.from_numpy(ts), t(ctx))
        assert torch.equal(tu(t(x), torch.from_numpy(ts), t(ctx), cfg=fused), ref)
        assert len(calls) == 2 * want                                # float32: none eligible
    assert torch.equal(eps_hoisted, eps_fused)
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    assert rel(eps_fused, eps) <= 2e-2 and eps.abs().max() > 1e-2
    assert rel(eps_fused, ref) <= 5e-2
    # the option constructs a model, and recompute under autograd stays a CPU matter
    assert tunet.UNet(tunet.UNetConfig(model_channels=32, num_heads=4, context_dim=64,
                                       fused_conv=True)).cfg.fused_conv


def test_timestep_embedding():
    from adaprompt_tpu_torch.models.unet import timestep_embedding
    ts = np.asarray([1, 500, 981], np.int32)
    for dim in (320, 33):
        # arguments reach ~1000 rad, where a 1-ulp difference between the two
        # libraries' float32 exp moves cos/sin by up to ~1e-4
        assert_close(timestep_embedding(torch.from_numpy(ts), dim),
                     junet.timestep_embedding(jnp.asarray(ts), dim), atol=1e-4)


# -- VAE -------------------------------------------------------------------------

def test_vae_decode(models):
    (_, jv, _), (_, tv, _) = models
    z = np.random.default_rng(5).standard_normal((2, 8, 8, 4)).astype(np.float32)
    img_j = jvae.decode(jv, jnp.asarray(z), cfg=JAX_VAE)
    with torch.no_grad():
        img_t = tv.decode(t(z))
    assert img_t.shape == (2, 64, 64, 3)
    assert_close(img_t, img_j, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("fg_mask", [False, True])
def test_vae_encode(models, fg_mask):
    (_, jv, _), (_, tv, _) = models
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    mask = None
    if fg_mask:
        fg = (rng.random((2, 64, 64, 1)) < 0.5).astype(np.float32)
        mask = {"fg_mask": fg}
    mean_j, logvar_j = jvae.encode(jv, jnp.asarray(x), cfg=JAX_VAE,
                                   mask=None if mask is None else {"fg_mask": jnp.asarray(fg)})
    with torch.no_grad():
        mean_t, logvar_t = tv.encode(t(x), mask=None if mask is None else {"fg_mask": t(fg)})
    assert mean_t.shape == (2, 8, 8, 4)
    assert_close(mean_t, mean_j, atol=2e-4, rtol=1e-4)
    assert_close(logvar_t, logvar_j, atol=2e-4, rtol=1e-4)


def test_sample_latent_moments():
    from adaprompt_tpu_torch.models.vae import sample_latent
    mean = torch.full((4, 16, 16, 4), 0.5)
    logvar = torch.full((4, 16, 16, 4), np.log(0.25))
    z = sample_latent(mean, logvar, torch.Generator().manual_seed(0))
    assert abs(z.mean().item() - 0.5) < 0.02 and abs(z.std().item() - 0.5) < 0.02


# -- tokenizer ---------------------------------------------------------------------

@pytest.mark.parametrize("text", [DEFAULT_NEGATIVE_PROMPT,
                                  "a photo of 3 cats, 2 dogs & 1 bird!!",
                                  "it's 12:30 -- don't re-use `x_1` (v2.0)?",
                                  "Café naïve résumé; 100% über-cool"])
def test_tokenizer_ids_match_jax(text):
    ids_j = JaxTokenizer.fallback()([text, "short"])
    ids_t = TorchTokenizer.fallback()([text, "short"])
    np.testing.assert_array_equal(ids_t, ids_j)
    assert ids_t.dtype == np.int32 and ids_t.shape == (2, 77)
