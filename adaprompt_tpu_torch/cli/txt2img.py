"""Research-path txt2img CLI: an SD checkpoint and an AdaFace checkpoint,
the zero-shot ID embedding of reference photos, subject embeddings spliced
into the prompt, DDIM (or DPM-Solver++) with annealed CFG, PNGs out.

Port of `adaprompt_tpu/cli/txt2img.py` (the reference's
scripts/stable_txt2img.py), on the port's pipeline and its zlib PNG codec.
The photos are read as PNG or `.npy` (other formats need PIL). Unlike the
JAX CLI, only "no face found" falls back to a random face: any other error
of the face embedding (a file it cannot read, a fault on the card) raises.
`--compare_with` scores the generations against a folder of photos by CLIP
image and text similarity (against the first prompt) and DINO similarity,
with the random-weight ViT-B/32 scorer and DINO ViT-S/16 of
`common.random_scorers`.

    python -m adaprompt_tpu_torch.cli.txt2img --prompt "a z riding a bike" \\
        --ckpt v1-5-pruned-emaonly.ckpt --adaface_ckpt embeddings_gs-1000.pt \\
        --ref_images subjects/alice --n_samples 4 --scale 4 1 --outdir out/
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from adaprompt_tpu_torch.adaface import arc2face as a2f
from adaprompt_tpu_torch.adaface import conditioner as cond_mod
from adaprompt_tpu_torch.cli import common
from adaprompt_tpu_torch.pipeline import DEFAULT_NEGATIVE_PROMPT


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    common.add_model_args(p)
    p.add_argument("--prompt", type=str, default="a photo of a z")
    p.add_argument("--from_file", type=str, default=None,
                   help="file with one prompt per line")
    p.add_argument("--adaface_ckpt", type=str, default=None,
                   help=".npz (native) or embeddings_gs-*.pt (reference)")
    p.add_argument("--ref_images", type=str, default=None,
                   help="folder of subject photos")
    p.add_argument("--subject_string", type=str, default="z")
    p.add_argument("--n_samples", type=int, default=4)
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--sampler", type=str, default="ddim", choices=("ddim", "dpmpp"),
                   help="ddim = reference semantics; dpmpp = DPM-Solver++(2M), ~20-25 steps "
                        "match DDIM-50 (pass a smaller --ddim_steps)")
    p.add_argument("--scale", type=float, nargs="+", default=[4.0, 1.0])
    p.add_argument("--compel_cfg_weight_level", type=float, default=0.0,
                   help="compel-style prompt weighting: push the cond embeddings away from the "
                        "empty-prompt embeddings by 1.1**level; 0 disables")
    p.add_argument("--H", type=int, default=512)
    p.add_argument("--W", type=int, default=512)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--outdir", type=str, default="outputs/txt2img")
    p.add_argument("--neg_prompt", type=str, default=DEFAULT_NEGATIVE_PROMPT)
    p.add_argument("--clip_skip_weights", type=float, nargs="+", default=[1.0, 1.0])
    p.add_argument("--compare_with", type=str, default=None,
                   help="score generations against this folder (CLIP/DINO)")
    p.add_argument("--calc_face_sim", action="store_true")
    p.add_argument("--arcface_ckpt", type=str, default=None)
    return p.parse_args(argv)


def face_id(args, device) -> np.ndarray | None:
    """The mean L2-normalized ArcFace embedding [1, 512] of the photos in
    --ref_images; None when there are none or no photo shows a face."""
    if not args.ref_images:
        return None
    from adaprompt_tpu_torch.eval.face_eval import FaceSimilarityEvaluator, list_images
    fe = FaceSimilarityEvaluator(common.load_arcface(args.arcface_ckpt, device))
    embs = [e[0] for e in fe.embed_folder(list_images(args.ref_images)) if len(e)]
    if not embs:
        return None
    m = np.mean(np.stack(embs), axis=0, keepdims=True)
    return m / np.linalg.norm(m, axis=-1, keepdims=True)


def main(argv=None):
    args = parse_args(argv)
    # cheap inputs are checked before any model is loaded
    if args.ddim_steps < 1:
        raise SystemExit(f"--ddim_steps must be >= 1, got {args.ddim_steps}")
    if args.n_samples < 1:
        raise SystemExit(f"--n_samples must be >= 1, got {args.n_samples}")
    prompts = [args.prompt]
    if args.from_file:
        if not os.path.isfile(args.from_file):
            raise SystemExit(f"--from_file not found: {args.from_file}")
        with open(args.from_file) as f:
            prompts = [ln.strip() for ln in f if ln.strip()]
        if not prompts:
            raise SystemExit(f"no prompts in {args.from_file}")
    if args.ref_images and not os.path.isdir(args.ref_images):
        raise SystemExit(f"--ref_images folder not found: {args.ref_images}")

    pipe = common.load_pipeline(args)
    sbg, scfg = common.load_subj_basis(args, pipe)
    faceid = face_id(args, pipe.device)
    if faceid is None:
        if args.ref_images:
            print("no face found in --ref_images; using a random face")
        rng = np.random.default_rng(args.seed)
        faceid = rng.standard_normal((1, 512)).astype(np.float32)
        faceid /= np.linalg.norm(faceid, axis=-1, keepdims=True)

    tok = pipe.tokenizer
    with torch.no_grad():
        _, core_id = a2f.forward_face_embs(pipe.text, tok,
                                           torch.as_tensor(faceid, device=pipe.device),
                                           input_max_length=22)
        subj_embs, _ = sbg(tok, core_id, is_training=False)
    specs = cond_mod.make_placeholders(tok, (args.subject_string,), (),
                                       num_vectors_subj=scfg.num_out_embs_per_layer)
    pc = cond_mod.PromptConditioner(pipe.text, tok, specs)

    sw = tuple(args.clip_skip_weights)
    guidance = tuple(args.scale) if len(args.scale) > 1 else args.scale[0]
    all_paths = []
    with torch.no_grad():
        empty_ctx = (pc([""] * args.n_samples, {}, skip_weights=sw)
                     if args.compel_cfg_weight_level else None)
        for pi, prompt in enumerate(prompts):
            cond = pc([prompt] * args.n_samples, {args.subject_string: subj_embs},
                      skip_weights=sw)
            if empty_ctx is not None:
                from adaprompt_tpu_torch.adaface.compel_cfg import apply_compel_cfg
                cond = apply_compel_cfg(cond, empty_ctx, args.compel_cfg_weight_level)
            uncond = pc([args.neg_prompt] * args.n_samples, {}, skip_weights=sw)
            imgs = pipe.generate(None, context=cond, context_uncond=uncond,
                                 num_steps=args.ddim_steps, guidance_scale=guidance,
                                 height=args.H, width=args.W, seed=args.seed + pi,
                                 sampler=args.sampler)
            all_paths += common.save_images(imgs, args.outdir, prefix=f"p{pi:03d}")
    print(f"saved {len(all_paths)} images to {args.outdir}")

    if args.compare_with:
        from adaprompt_tpu_torch.eval import harness
        scorer, dev = common.random_scorers(tok, pipe.device)
        scores = harness.compare_folders(scorer, dev, args.compare_with, args.outdir, prompts[0])
        print(f"sim_img={scores.sim_img:.3f} sim_text={scores.sim_text:.3f} "
              f"sim_dino={scores.sim_dino:.3f}")
    return all_paths


if __name__ == "__main__":
    main()
