"""StableDiffusionPipeline — the port's txt2img engine on PyTorch and CUDA.

Port of `adaprompt_tpu/pipeline.py`: CLIP text encoding with clip-skip
weights, the cross-attention K/V hoisted out of the loop, DDIM (or
DPM-Solver++(2M), `sampler="dpmpp"`) with CFG annealed 4 -> 1 over a (cond,
uncond) batch, and the VAE decode to uint8. `fast=FastConfig()` turns on
the serving accelerations (ToMe, DeepCache, the CFG tail); with
`quant="int8"` at construction, `generate(sampler="dpmpp", num_steps=20,
fast=FastConfig())` is the composed serving stack. Public layouts are the
JAX package's: latents [B, h, w, 4], images [B, H, W, 3] uint8, contexts
[L, B, 77, 768].

Entry points run on CUDA unless the caller passes device="cpu"; on a host
without CUDA they raise rather than fall back to the CPU. `distribute(mesh)`
serves one prompt batch over the ranks of a device mesh (`parallel/mesh.py`):
each rank holds all three models and denoises its block of the rows, and
every rank returns the whole batch. The CLIP text
encoder keeps float32 weights (as the JAX pipeline's parameters are
float32); the UNet and the VAE hold their weights in the compute dtype.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from adaprompt_tpu_torch.models import clip_text, unet as unet_mod, vae as vae_mod
from adaprompt_tpu_torch.models.clip_text import SD15_TEXT_CONFIG, CLIPTextConfig, CLIPTextModel
from adaprompt_tpu_torch.models.unet import SD15_UNET_CONFIG, UNet, UNetConfig
from adaprompt_tpu_torch.models.vae import (SD15_VAE_CONFIG, SD_SCALE_FACTOR, VAE, VAEConfig,
                                            sample_latent)
from adaprompt_tpu_torch.ops.layers import reset_parameters
from adaprompt_tpu_torch.parallel import mesh as mesh_mod
from adaprompt_tpu_torch.sampling import ddim, dpm
from adaprompt_tpu_torch.sampling.schedule import SD15_SCHEDULE, DiffusionSchedule
from adaprompt_tpu_torch.utils import torch_port
from adaprompt_tpu_torch.utils.tokenizer import CLIPTokenizer

# PuLID-style default negative prompt (AdaFace wrapper default)
DEFAULT_NEGATIVE_PROMPT = (
    "flaws in the eyes, flaws in the face, lowres, non-HDRi, low quality, "
    "worst quality, artifacts, noise, text, watermark, glitch, mutated, ugly, "
    "disfigured, hands, partially rendered objects, partially rendered eyes, "
    "deformed eyeballs, cross-eyed, blurry, mutation, duplicate, out of frame, "
    "cropped, mutilated, bad anatomy, deformed, bad proportions, nude, naked, "
    "nsfw, topless, bare breasts"
)


@dataclasses.dataclass(frozen=True)
class FastConfig:
    """Opt-in serving accelerations, each a published approximation of the
    exact sampler (quality to be validated per checkpoint):
      * tome_ratio: ToMe token merging in the 64x64 transformer blocks
        (ops/tome.py, arXiv:2303.17604); 0 disables. tome_mlp merges for
        the feed-forward too;
      * cache_interval / cache_depth: DeepCache deep-feature reuse
        (UNet cache_depth, arXiv:2312.00858); interval 1 disables;
      * cfg_tail_frac: the final fraction of the steps runs condition-only
        with the guidance scale pinned to exactly 1 (arXiv:2404.07724); 0
        disables."""
    tome_ratio: float = 0.5
    tome_mlp: bool = True
    cache_interval: int = 3
    cache_depth: int = 3
    cfg_tail_frac: float = 0.3


def resolve_device(device=None) -> torch.device:
    """`device`, CUDA by default; raises when CUDA is asked for and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


class StableDiffusionPipeline:
    """Holds the three models; every generate() runs eagerly on their device."""

    def __init__(self, unet: UNet, vae: VAE, text: CLIPTextModel,
                 tokenizer: CLIPTokenizer | None = None,
                 sched: DiffusionSchedule = SD15_SCHEDULE,
                 quant: str | None = None):
        """quant="int8": the UNet's w8a8 fused cross-attention and GEGLU
        kernels (forward only); the weights stay as given and are quantized
        once per generate."""
        self.unet, self.vae, self.text = unet, vae, text
        self.unet_cfg = (unet.cfg if quant is None
                         else dataclasses.replace(unet.cfg, quant=quant))
        self.tokenizer = tokenizer or CLIPTokenizer.load()
        self.sched = sched
        self.device = unet.out["conv"].weight.device
        self.compute_dtype = unet.out["conv"].weight.dtype
        self.mesh = None

    @classmethod
    def random_init(cls, seed: int = 0, *, device=None, dtype=torch.bfloat16,
                    unet_cfg: UNetConfig = SD15_UNET_CONFIG,
                    vae_cfg: VAEConfig = SD15_VAE_CONFIG,
                    text_cfg: CLIPTextConfig = SD15_TEXT_CONFIG,
                    tokenizer: CLIPTokenizer | None = None,
                    quant: str | None = None) -> "StableDiffusionPipeline":
        """Random weights from `seed`, made directly on the device (no
        checkpoint assets needed). UNet and VAE in `dtype`, CLIP in float32."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        unet = reset_parameters(UNet(unet_cfg, device=device, dtype=dtype), gen)
        vae = reset_parameters(VAE(vae_cfg, device=device, dtype=dtype), gen)
        text = reset_parameters(CLIPTextModel(text_cfg, device=device), gen)
        return cls(unet, vae, text, tokenizer, quant=quant)

    @classmethod
    def from_checkpoint(cls, path: str, *, device=None, dtype=torch.bfloat16,
                        tokenizer: CLIPTokenizer | None = None,
                        unet_cfg: UNetConfig = SD15_UNET_CONFIG,
                        vae_cfg: VAEConfig = SD15_VAE_CONFIG,
                        text_cfg: CLIPTextConfig = SD15_TEXT_CONFIG) -> "StableDiffusionPipeline":
        """A full SD-1.5 checkpoint (.ckpt / .safetensors / .npz, LDM key
        layout) on the device: UNet and VAE in `dtype`, CLIP in float32, as
        `random_init` makes them. Each model is put on the device as it is
        built, so the host holds the file's arrays and one model's view of
        them at a time."""
        device = resolve_device(device)
        parts = torch_port.split_sd_checkpoint(torch_port.load_state_dict(path))

        def build(module, state):
            module.load_state_dict(state, strict=True)
            return module

        unet = build(UNet(unet_cfg, device=device, dtype=dtype),
                     unet_mod.from_torch(parts.pop("unet"), unet_cfg))
        vae = build(VAE(vae_cfg, device=device, dtype=dtype),
                    vae_mod.from_torch(parts.pop("vae"), vae_cfg))
        text = build(CLIPTextModel(text_cfg, device=device),
                     clip_text.from_torch(parts.pop("text"), text_cfg))
        return cls(unet, vae, text, tokenizer)

    # -- multi-card serving ------------------------------------------------------

    def distribute(self, mesh=None) -> "StableDiffusionPipeline":
        """Serve over a device mesh (by default all the ranks of the
        initialised process group, pure dp): the weights replicated, each
        rank holding the three models whole (serving keeps no optimizer state,
        and whole weights keep the denoising loop free of gathers); generate()
        splits its batch over dp and gathers the images, so a batch must be
        divisible by the dp size."""
        self.mesh = mesh or mesh_mod.make_mesh()
        for m in (self.unet, self.vae, self.text):
            mesh_mod.replicate(m, self.mesh)
        return self

    def _shard_batch(self, cond, uncond, x_T):
        """This rank's rows of the contexts [L, B, 77, D] and of x_T [B, h, w, 4]."""
        dp = self.mesh["dp"].size()
        b = x_T.shape[0]
        if b % dp:
            raise ValueError(
                f"batch {b} not divisible by the mesh dp size {dp}; pad the "
                "prompt list or use a smaller mesh")
        return (mesh_mod.take_rows(cond, self.mesh, 1), mesh_mod.take_rows(uncond, self.mesh, 1),
                mesh_mod.take_rows(x_T, self.mesh))

    # -- text encoding ---------------------------------------------------------

    def tokenize(self, prompts) -> np.ndarray:
        return self.tokenizer(prompts, max_length=self.text.cfg.max_positions)

    @torch.inference_mode()
    def encode_prompt(self, prompts, skip_weights=(1.0, 1.0),
                      inputs_embeds: torch.Tensor | None = None) -> torch.Tensor:
        """Prompts -> [B, 77, 768] conditioning (float32). skip_weights are the
        clip-skip weights over the last N hidden states."""
        ids = torch.as_tensor(self.tokenize(prompts), device=self.device).long()
        return self.text.encode(ids, inputs_embeds=inputs_embeds,
                                hidden_state_layer_weights=torch.tensor(skip_weights,
                                                                        dtype=torch.float32))

    # -- generation -------------------------------------------------------------

    def generate(self, prompts, *, negative_prompt: str | None = None,
                 num_steps: int = 50, guidance_scale=(4.0, 1.0),
                 height: int = 512, width: int = 512, seed: int = 0,
                 skip_weights=(1.0, 1.0),
                 context: torch.Tensor | None = None,
                 context_uncond: torch.Tensor | None = None,
                 return_latents: bool = False,
                 fast: FastConfig | None = None, sampler: str = "ddim") -> np.ndarray:
        """Text to uint8 images [B, H, W, 3] (latents [B, H/8, W/8, 4] with
        return_latents). Either `prompts` or a precomputed `context`
        ([L, B, 77, 768] or [B, 77, 768]) is given. sampler: "ddim" (the
        reference's) or "dpmpp" (DPM-Solver++(2M); pass ~20 steps); `fast`
        composes with either."""
        if sampler not in ("ddim", "dpmpp"):
            raise ValueError(f"unknown sampler {sampler!r}")
        if context is None:
            cond = self.encode_prompt(prompts, skip_weights)[None]      # [1, B, 77, D]
        else:
            cond = context if context.ndim == 4 else context[None]
        b = cond.shape[1]
        if context_uncond is None:
            neg = negative_prompt if negative_prompt is not None else DEFAULT_NEGATIVE_PROMPT
            uncond = self.encode_prompt([neg] * b, skip_weights)[None]
        else:
            uncond = context_uncond if context_uncond.ndim == 4 else context_uncond[None]
        if uncond.shape[0] != cond.shape[0]:
            uncond = uncond.expand(cond.shape)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        x_T = torch.randn((b, height // 8, width // 8, 4), generator=gen,
                          device=self.device, dtype=torch.float32)
        cond, uncond = cond.to(self.device), uncond.to(self.device)
        if self.mesh is not None:
            # x_T is drawn whole from the seed; each rank takes its rows
            cond, uncond, x_T = self._shard_batch(cond, uncond, x_T)
        args = (self.unet, self.vae, cond, uncond, x_T,
                num_steps, _as_pair(guidance_scale), return_latents)
        if fast is not None:
            out = _generate_fast(*args, fast, self.unet_cfg, self.sched, self.compute_dtype,
                                 sampler)
        else:
            out = _generate(*args, self.sched, self.compute_dtype, sampler, self.unet_cfg)
        if self.mesh is not None:
            out = mesh_mod.gather_rows(out, self.mesh)
        return out.cpu().numpy()

    @torch.inference_mode()
    def decode_latents(self, z) -> np.ndarray:
        z = torch.as_tensor(z, device=self.device)
        return _to_uint8(self.vae.decode((z / SD_SCALE_FACTOR).to(self.compute_dtype))).cpu().numpy()

    @torch.inference_mode()
    def encode_image(self, images, generator: torch.Generator | None = None) -> torch.Tensor:
        """[-1, 1] float images [B, H, W, 3] -> scaled latents: the mean when
        `generator` is None, a sample drawn with it otherwise."""
        x = torch.as_tensor(images, device=self.device).to(self.compute_dtype)
        mean, logvar = self.vae.encode(x)
        z = mean if generator is None else sample_latent(mean, logvar, generator)
        return z.float() * SD_SCALE_FACTOR


def _as_pair(g):
    if isinstance(g, (tuple, list)):
        return (float(g[0]), float(g[1]))
    return (float(g), min(2.0, float(g)))


def _to_uint8(img: torch.Tensor) -> torch.Tensor:
    img = (img.float() + 1.0) * 127.5
    return img.round().clamp(0, 255).to(torch.uint8)


def _decode(vae: VAE, z, return_latents, dt):
    if return_latents:
        return z
    return _to_uint8(vae.decode((z / SD_SCALE_FACTOR).to(dt)))


def eps_model(unet: UNet, ctx: torch.Tensor, dt, cfg: UNetConfig) -> ddim.EpsModel:
    """The eps model of one sampling run over the context ctx [L, 2B, S, D]
    (cond first) in dtype dt: the cross-attention K/V hoisted out of the
    loop (and, under quant="int8", the int8 weights; under fused_conv, the
    fused convs' repacked weights), then (x, t) -> float32 eps, x cast to
    dt. What `_generate` and the translate CLI sample with."""
    cross_kv = unet.precompute_cross_kv(ctx)
    int8_weights = unet.quantize_int8() if cfg.quant == "int8" else None
    conv_weights = unet.pack_fused_conv_weights() if cfg.fused_conv else None

    def model_fn(x, t):
        return unet(x.to(dt), t, ctx, cross_kv=cross_kv, int8_weights=int8_weights,
                    fused_conv_weights=conv_weights, cfg=cfg).float()
    return model_fn


@torch.inference_mode()
def _generate(unet: UNet, vae: VAE, cond, uncond, x_T, num_steps, guidance,
              return_latents, sched, dt, sampler="ddim", unet_cfg: UNetConfig | None = None):
    """The main path after text encoding: the hoisted eps model
    (`eps_model`), the sampler over the (cond, uncond) batch, the decode
    to uint8.
    cond/uncond [L, B, 77, D]; x_T [B, h, w, 4] float32."""
    ctx = torch.cat([cond, uncond], dim=1).to(dt)              # [L, 2B, 77, D]
    model_fn = eps_model(unet, ctx, dt, unet.cfg if unet_cfg is None else unet_cfg)
    sample = dpm.dpmpp_sample if sampler == "dpmpp" else ddim.ddim_sample
    z = sample(model_fn, x_T, num_steps=num_steps, guidance_scale=guidance, sched=sched)
    return _decode(vae, z, return_latents, dt)


@torch.inference_mode()
def _generate_fast(unet: UNet, vae: VAE, cond, uncond, x_T, num_steps, guidance,
                   return_latents, fast: FastConfig, unet_cfg: UNetConfig, sched, dt,
                   sampler="ddim"):
    """The FastConfig serving path (ToMe + DeepCache + CFG tail) under
    either sampler. Steps in the CFG tail run the plain batch against the
    cond halves of the context and of every hoisted K/V."""
    cfg = dataclasses.replace(unet_cfg, tome_ratio=fast.tome_ratio, tome_mlp=fast.tome_mlp)
    ctx = torch.cat([cond, uncond], dim=1).to(dt)              # [L, 2B, 77, D]
    cross_kv = unet.precompute_cross_kv(ctx)
    int8_weights = unet.quantize_int8() if cfg.quant == "int8" else None
    conv_weights = unet.pack_fused_conv_weights() if cfg.fused_conv else None
    depth = fast.cache_depth if fast.cache_interval > 1 else 1
    cond_only = (ctx[:, :cond.shape[1]],
                 {li: (k[:cond.shape[1]], v[:cond.shape[1]]) for li, (k, v) in cross_kv.items()})

    def run(x, t, cache):
        c, kv = (ctx, cross_kv) if x.shape[0] == ctx.shape[1] else cond_only
        eps, cache = unet(x.to(dt), t, c, cross_kv=kv, cache_depth=depth, cache=cache,
                          int8_weights=int8_weights, fused_conv_weights=conv_weights, cfg=cfg)
        return eps.float(), cache

    sample = dpm.dpmpp_sample_fast if sampler == "dpmpp" else ddim.ddim_sample_fast
    z = sample(lambda x, t: run(x, t, None), lambda x, t, cache: run(x, t, cache)[0], x_T,
               num_steps=num_steps, guidance_scale=guidance, sched=sched,
               cache_interval=fast.cache_interval, cfg_tail_frac=fast.cfg_tail_frac)
    return _decode(vae, z, return_latents, dt)
