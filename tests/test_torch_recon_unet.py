"""The UNet's activation capture and subject conv-attention in the port vs
the JAX package (the tiny UNet, CPU, float32, shared weights, same
numpy-seeded inputs): capture_ca with an img_mask, the context gradient
with and without block recompute, conv_attn with its layer gating. Each
tolerance is stated."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaprompt_tpu.models import unet as junet
from adaprompt_tpu_torch.models import unet as tunet
from torch_port_helpers import JAX_UNET, assert_close, t, tiny_models


@pytest.fixture(scope="module")
def models():
    return tiny_models(0)


def _leaf(a):
    return t(a).requires_grad_(True)


def _unet_case(seed, b=2, hw=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, hw, hw, 4)).astype(np.float32)
    ts = np.asarray([981, 21][:b], np.int32)
    ctx = (rng.standard_normal((1, b, 77, 64)) * 0.5).astype(np.float32)
    mask = np.zeros((b, 256, 256, 1), np.float32)
    mask[:, 40:230, 16:200] = 1.0
    return x, ts, ctx, mask


def test_unet_capture_matches_jax(models):
    """capture_ca=True with an img_mask: eps equal to the plain forward's,
    and q, attn, attnscore and outfeat at the 12 distillation layers
    against JAX's."""
    (ju, _, _), (tu, _, _) = models
    x, ts, ctx, mask = _unet_case(8)
    eps_j, caps_j = junet.forward(ju, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
                                  img_mask=jnp.asarray(mask), capture_ca=True, cfg=JAX_UNET)
    with torch.no_grad():
        args = (t(x), torch.from_numpy(ts), t(ctx))
        eps_t, caps_t = tu(*args, img_mask=t(mask), capture_ca=True)
        plain = tu(*args, img_mask=t(mask))
    # the capturing layers' cross-attention is the plain fp32 einsum, not
    # dot_product_attention's plain version: equal up to fp32 summation order
    assert_close(eps_t, plain.numpy(), atol=1e-5)
    assert_close(eps_t, eps_j, atol=2e-4, rtol=1e-4)
    assert set(caps_t) == {"q", "attn", "attnscore", "outfeat"}
    for key, tol in (("q", 1e-4), ("attn", 1e-5), ("attnscore", 1e-4), ("outfeat", 2e-4)):
        assert list(caps_t[key]) == list(caps_j[key]) == list(tunet.DISTILL_LAYER_INDICES)
        for li, v in caps_t[key].items():
            assert v.shape == caps_j[key][li].shape, (key, li)
            assert_close(v, caps_j[key][li], atol=tol, rtol=1e-4)


def test_unet_capture_gradient_under_block_recompute(models):
    """d(loss on eps and the attention scores)/d(context) is the same with
    block recompute (torch.utils.checkpoint, the captures as the
    checkpointed function's outputs) and without (fp32: 1e-6 of the
    largest entry)."""
    _, (tu, _, _) = models
    x, ts, ctx, mask = _unet_case(9, b=1)
    rng = np.random.default_rng(10)
    w = {li: rng.standard_normal(v).astype(np.float32) for li, v in
         ((li, (1, 4, hw * hw, 77)) for li, hw in zip(tunet.DISTILL_LAYER_INDICES,
                                                     (8, 8, 4, 8, 8, 8, 16, 16, 16, 32, 32, 32)))}
    g = rng.standard_normal(x.shape).astype(np.float32)

    grads = []
    for recompute in (True, False):
        tu.cfg = dataclasses.replace(tu.cfg, use_checkpoint=recompute)
        c = _leaf(ctx)
        eps, caps = tu(t(x), torch.from_numpy(ts), c, img_mask=t(mask), capture_ca=True)
        ((eps * t(g)).sum() + sum((caps["attnscore"][li] * t(w[li])).sum() for li in w)).backward()
        grads.append(c.grad)
    tu.cfg = dataclasses.replace(tu.cfg, use_checkpoint=True)
    assert grads[1].abs().max() > 0
    assert_close(grads[0], grads[1].numpy(), atol=1e-6 * grads[1].abs().max().item())


@pytest.mark.parametrize("kernel_size", [3, {1: 2, 12: 3, 22: 4, 24: 1}], ids=["int3", "dict"])
def test_unet_conv_attn_matches_jax(models, kernel_size):
    """conv_attn with an int kernel size and with a per-layer dict, mix
    weight 0.5, with capture: eps and the 12 layers' attention scores
    against JAX's; an int size equals the dict that gives it to every
    cross-attention layer but 6-10 (the gating), and moves eps."""
    (ju, _, _), (tu, _, _) = models
    x, ts, ctx, mask = _unet_case(11)
    pos = np.stack([np.arange(5, 21), np.arange(9, 25)])          # [B, M=16]
    conv_j = {"subj_pos": jnp.asarray(pos), "kernel_size": kernel_size, "mix_weight": 0.5}
    conv_t = lambda ks: {"subj_pos": torch.from_numpy(pos), "kernel_size": ks, "mix_weight": 0.5}
    eps_j, caps_j = junet.forward(ju, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
                                  img_mask=jnp.asarray(mask), capture_ca=True, conv_attn=conv_j,
                                  cfg=JAX_UNET)
    with torch.no_grad():
        args = (t(x), torch.from_numpy(ts), t(ctx))
        eps_t, caps_t = tu(*args, img_mask=t(mask), capture_ca=True,
                           conv_attn=conv_t(kernel_size))
        eps_only = tu(*args, img_mask=t(mask), conv_attn=conv_t(kernel_size))
        plain = tu(*args, img_mask=t(mask))
        if isinstance(kernel_size, int):
            gated = {li: kernel_size for li, ca in tu.l2ca.items() if ca not in (6, 7, 8, 9, 10)}
            assert len(gated) == 11
            assert_close(tu(*args, img_mask=t(mask), conv_attn=conv_t(gated)),
                         eps_only.numpy(), atol=0)
    assert_close(eps_t, eps_j, atol=2e-4, rtol=1e-4)
    assert_close(eps_only, eps_t.numpy(), atol=1e-5)     # as in test_unet_capture_matches_jax
    assert (eps_t - plain).abs().max() > 1e-4      # far beyond fp32 rounding (1e-6)
    for li in tunet.DISTILL_LAYER_INDICES:
        assert_close(caps_t["attnscore"][li], caps_j["attnscore"][li], atol=1e-4, rtol=1e-4)
