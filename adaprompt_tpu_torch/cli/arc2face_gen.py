"""Arc2Face teacher generation CLI: an ArcFace ID embedding -> the
Arc2Face text encoder's prompt embeddings (21 tokens) -> DDIM with the
Arc2Face UNet. For checking the teacher before distillation.

Port of `adaprompt_tpu/cli/arc2face_gen.py` (the reference's
scripts-private/arc2face_test.py). `--arc2face_ckpt` is either a full
LDM-layout checkpoint, whose UNet and text encoder both become the teacher's,
or a diffusers UNet2DConditionModel state dict (the layout the Arc2Face UNet
is published in), read by `utils/diffusers_port.unet_from_diffusers`, with
the pipeline's own text encoder. The face id is the mean L2-normalized
ArcFace embedding of `--ref_images`, or a random face from numpy's
generator seeded `--seed` (the JAX CLI's draw) when there is none. The
negative context is the same encoder on a zero face.

    python -m adaprompt_tpu_torch.cli.arc2face_gen --ckpt v1-5-pruned-emaonly.ckpt \\
        --arc2face_ckpt arc2face/unet/diffusion_pytorch_model.bin \\
        --ref_images photos/alice --arcface_ckpt glint360k_r100.pth --outdir out/
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from adaprompt_tpu_torch.adaface import arc2face as a2f
from adaprompt_tpu_torch.cli import common
from adaprompt_tpu_torch.cli.txt2img import face_id
from adaprompt_tpu_torch.models import clip_text, unet as unet_mod
from adaprompt_tpu_torch.utils import torch_port


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    common.add_model_args(p)
    p.add_argument("--arc2face_ckpt", type=str, default=None)
    p.add_argument("--ref_images", type=str, default=None,
                   help="photos for ID extraction (random face if absent)")
    p.add_argument("--n_samples", type=int, default=4)
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--guidance_scale", type=float, default=3.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--outdir", type=str, default="outputs/arc2face")
    p.add_argument("--arcface_ckpt", type=str, default=None)
    return p.parse_args(argv)


def load_teacher(path: str, pipe):
    """The Arc2Face text encoder from `path`, whose UNet replaces the
    pipeline's: an LDM checkpoint's UNet and text encoder, or a diffusers
    UNet state dict and the pipeline's own text encoder."""
    from adaprompt_tpu_torch.utils.diffusers_port import unet_from_diffusers
    sd = torch_port.load_state_dict(path)
    parts = torch_port.split_sd_checkpoint(sd)
    unet = unet_mod.UNet(pipe.unet.cfg, device=pipe.device, dtype=pipe.compute_dtype)
    if parts["unet"]:
        unet.load_state_dict(unet_mod.from_torch(parts["unet"], pipe.unet.cfg), strict=True)
        text = clip_text.CLIPTextModel(pipe.text.cfg, device=pipe.device)
        text.load_state_dict(clip_text.from_torch(parts["text"], pipe.text.cfg), strict=True)
    else:
        unet.load_state_dict(unet_from_diffusers(sd, pipe.unet.cfg), strict=True)
        text = pipe.text
    pipe.unet = unet.eval()
    return text


def main(argv=None):
    args = parse_args(argv)
    pipe = common.load_pipeline(args)
    if args.arc2face_ckpt:
        a2f_text = load_teacher(args.arc2face_ckpt, pipe)
    else:
        print("WARNING: no arc2face ckpt — teacher = current SD weights.")
        a2f_text = pipe.text

    rng = np.random.default_rng(args.seed)
    faceid = face_id(args, pipe.device)
    if faceid is None:
        faceid = rng.standard_normal((1, 512)).astype(np.float32)
        faceid /= np.linalg.norm(faceid, axis=-1, keepdims=True)

    # the teacher's conditioning: 21 tokens, no padding (the reference's
    # ddpm.py:5427); the negative one from a zero face
    with torch.no_grad():
        ctx, _ = a2f.forward_face_embs(a2f_text, pipe.tokenizer,
                                       torch.as_tensor(faceid, device=pipe.device),
                                       input_max_length=21)
        neg_ctx, _ = a2f.forward_face_embs(a2f_text, pipe.tokenizer,
                                           torch.zeros((1, 512), device=pipe.device),
                                           input_max_length=21)
    cond = ctx.repeat(args.n_samples, 1, 1)
    uncond = neg_ctx.repeat(args.n_samples, 1, 1)
    imgs = pipe.generate(None, context=cond[None], context_uncond=uncond[None],
                         num_steps=args.ddim_steps, guidance_scale=args.guidance_scale,
                         seed=args.seed)
    paths = common.save_images(imgs, args.outdir, prefix="arc2face")
    print(f"saved {len(paths)} teacher generations to {args.outdir}")
    return paths


if __name__ == "__main__":
    main()
