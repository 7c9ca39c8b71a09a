"""Product-path inference CLI: photos of one subject in, personalized
txt2img PNGs out, through `AdaFacePipeline` (token-table update and prompt
rewrite).

Port of `adaprompt_tpu/cli/infer.py` (the reference's adaface-infer.py).
The Arc2Face encoder is the SD pipeline's own CLIP text model, as in the
JAX CLI. Here it is the very module whose token table `AdaFacePipeline`
grows by the 16 subject rows; the Arc2Face prompt reads none of those rows,
so its output is the same as on the table before the growth.

    python -m adaprompt_tpu_torch.cli.infer --subject photos/alice \\
        --ckpt v1-5-pruned-emaonly.ckpt --adaface_ckpt embeddings_gs-1000.pt \\
        --arcface_ckpt glint360k_r100.pth --prompt "portrait of a z" --outdir out/
"""

from __future__ import annotations

import argparse

from adaprompt_tpu_torch.cli import common


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    common.add_model_args(p)
    p.add_argument("--subject", type=str, required=True, help="folder of subject photos")
    p.add_argument("--prompt", type=str, default="portrait of a z")
    p.add_argument("--adaface_ckpt", type=str, default=None)
    p.add_argument("--subject_string", type=str, default="z")
    p.add_argument("--out_image_count", type=int, default=4)
    p.add_argument("--num_steps", type=int, default=50)
    p.add_argument("--sampler", type=str, default="ddim", choices=("ddim", "dpmpp"),
                   help="dpmpp = DPM-Solver++(2M); ~20-25 steps match DDIM-50 "
                        "(pass a smaller --num_steps)")
    p.add_argument("--guidance_scale", type=float, default=4.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--noise_level", type=float, default=0.0)
    p.add_argument("--outdir", type=str, default="outputs/infer")
    p.add_argument("--arcface_ckpt", type=str, default=None)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    pipe = common.load_pipeline(args)
    sbg, scfg = common.load_subj_basis(args, pipe)

    from adaprompt_tpu_torch.adaface.wrapper import AdaFacePipeline
    from adaprompt_tpu_torch.eval.face_eval import FaceSimilarityEvaluator, list_images
    face_embedder = FaceSimilarityEvaluator(common.load_arcface(args.arcface_ckpt, pipe.device))
    ada = AdaFacePipeline(pipe, sbg, scfg, pipe.text, pipe.text.cfg,
                          face_embedder=face_embedder, subject_string=args.subject_string,
                          num_inference_steps=args.num_steps)
    subj_embs = ada.generate_adaface_embeddings(image_paths=list_images(args.subject),
                                                noise_level=args.noise_level, seed=args.seed)
    if subj_embs is None:
        raise SystemExit("no usable face embeddings extracted")
    imgs = ada(args.prompt, guidance_scale=args.guidance_scale,
               out_image_count=args.out_image_count, seed=args.seed, sampler=args.sampler)
    paths = common.save_images(imgs, args.outdir)
    print(f"saved {len(paths)} images to {args.outdir}")
    return paths


if __name__ == "__main__":
    main()
