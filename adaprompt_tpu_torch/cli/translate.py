"""img2img "translation" CLI: re-denoise a folder of face photos with a
subject's AdaFace conditioning, from `--ref_img_strength` of the way up the
noise schedule (DDIM `stochastic_encode`, then `ddim_decode`).

Port of `adaprompt_tpu/cli/translate.py` (the reference's
adaface-translate.py). Each photo is read as PNG or `.npy` (other formats
through PIL, imported only for them), resized to 512x512 with PIL's
BICUBIC filter in numpy (`utils/resize.pil_bicubic`), encoded to the VAE's
mean latent, noised to DDIM step `t_start - 1` (t_start = num_steps *
ref_img_strength) with a generator seeded `seed + i` and decoded over the
last t_start steps. The eps model is `pipeline.eps_model`, the one a
generate samples with: the cross-attention K/V hoisted once for all the
photos (the fused cross-attention kernel reads them), where the JAX CLI
calls the UNet's forward without hoisting; the function is the same.
The result is saved under the photo's own name: a `.png` through the
port's PNG writer, any other extension through PIL (a `.jpg` photo gives a
JPEG, as in the JAX CLI); without PIL such a file raises.

    python -m adaprompt_tpu_torch.cli.translate --in_folder photos/alice \\
        --ckpt v1-5-pruned-emaonly.ckpt --adaface_ckpt embeddings_gs-1000.pt \\
        --arcface_ckpt glint360k_r100.pth --prompt "portrait of a z" --outdir out/
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from adaprompt_tpu_torch.cli import common
from adaprompt_tpu_torch.pipeline import eps_model
from adaprompt_tpu_torch.sampling import ddim
from adaprompt_tpu_torch.utils.png import read_image, write_png
from adaprompt_tpu_torch.utils.resize import pil_bicubic

IMAGE_SIZE = 512        # every photo is resized to IMAGE_SIZE x IMAGE_SIZE, as in the JAX CLI


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    common.add_model_args(p)
    p.add_argument("--in_folder", type=str, required=True)
    p.add_argument("--subject", type=str, default=None,
                   help="photos for ID extraction (default: in_folder)")
    p.add_argument("--prompt", type=str, default="portrait of a z")
    p.add_argument("--adaface_ckpt", type=str, default=None)
    p.add_argument("--subject_string", type=str, default="z")
    p.add_argument("--num_steps", type=int, default=50)
    p.add_argument("--ref_img_strength", type=float, default=0.8)
    p.add_argument("--guidance_scale", type=float, default=4.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--outdir", type=str, default="outputs/translate")
    p.add_argument("--arcface_ckpt", type=str, default=None)
    return p.parse_args(argv)


def save_image(path: str, img: np.ndarray) -> str:
    """uint8 [H, W, 3] to `path` in the format of its extension."""
    if os.path.splitext(path)[1].lower() == ".png":
        return write_png(path, img)
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"{path}: writing {os.path.splitext(path)[1] or 'extension-less'} "
                           "images needs PIL, which is not installed here; give the photos "
                           "as .png") from None
    Image.fromarray(img).save(path)
    return path


def main(argv=None):
    args = parse_args(argv)
    t_start = int(args.num_steps * args.ref_img_strength)
    if not 1 <= t_start <= args.num_steps:
        raise SystemExit(f"--num_steps {args.num_steps} x --ref_img_strength "
                         f"{args.ref_img_strength} gives {t_start} steps; need 1..num_steps")
    pipe = common.load_pipeline(args)
    sbg, scfg = common.load_subj_basis(args, pipe)

    from adaprompt_tpu_torch.adaface.wrapper import AdaFacePipeline
    from adaprompt_tpu_torch.eval.face_eval import FaceSimilarityEvaluator, list_images
    face_embedder = FaceSimilarityEvaluator(common.load_arcface(args.arcface_ckpt, pipe.device))
    ada = AdaFacePipeline(pipe, sbg, scfg, pipe.text, pipe.text.cfg,
                          face_embedder=face_embedder, subject_string=args.subject_string)
    ada.generate_adaface_embeddings(image_paths=list_images(args.subject or args.in_folder),
                                    seed=args.seed)
    cond, uncond = ada.encode_prompt(args.prompt)

    paths, out = list_images(args.in_folder), []
    os.makedirs(args.outdir, exist_ok=True)
    with torch.inference_mode():
        ctx = torch.cat([cond, uncond])[None].to(pipe.compute_dtype)    # [1, 2, 77, D]
        model_fn = eps_model(pipe.unet, ctx, pipe.compute_dtype, pipe.unet_cfg)
        for i, path in enumerate(paths):
            img = pil_bicubic(read_image(path), IMAGE_SIZE, IMAGE_SIZE)
            z0 = pipe.encode_image(img.astype(np.float32)[None] / np.float32(127.5) - 1.0)
            gen = torch.Generator(device=pipe.device).manual_seed(args.seed + i)
            z_t = ddim.stochastic_encode(z0, t_start - 1, gen, num_steps=args.num_steps,
                                         sched=pipe.sched)
            z = ddim.ddim_decode(model_fn, z_t, t_start, num_steps=args.num_steps,
                                 guidance_scale=args.guidance_scale, sched=pipe.sched)
            out.append(save_image(os.path.join(args.outdir, os.path.basename(path)),
                                  pipe.decode_latents(z)[0]))
    print(f"translated {len(out)} images to {args.outdir}")
    return out


if __name__ == "__main__":
    main()
