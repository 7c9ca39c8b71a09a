"""Shared pieces of the port's parity tests (tests/test_torch_*.py): tiny
configurations for both packages, and JAX parameter trees with every
zero-initialized leaf re-randomized, so that no layer (the UNet's
zero_module convs above all) makes a parity test pass vacuously."""

import jax
import numpy as np
import torch

from adaprompt_tpu.models import clip_text as jclip, unet as junet, vae as jvae
from adaprompt_tpu_torch import convert
from adaprompt_tpu_torch.models import clip_text as tclip, unet as tunet, vae as tvae

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


def t(a):
    """numpy / JAX array -> float32 CPU tensor."""
    return torch.from_numpy(np.array(a, np.float32))


def assert_close(actual, expected, atol, rtol=0.0):
    a = actual.detach().cpu().numpy() if isinstance(actual, torch.Tensor) else np.asarray(actual)
    np.testing.assert_allclose(a, np.asarray(expected), atol=atol, rtol=rtol)
