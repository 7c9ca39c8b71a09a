"""Batch subject generation and evaluation CLI: personalize from each
subject's photos, generate every prompt of a DreamBooth (or community)
prompt set, and score the samples against the photos by CLIP image and text
similarity, DINO similarity and ArcFace identity similarity into
`<outdir>/scores.csv`.

Port of `adaprompt_tpu/cli/gen_eval.py` (the reference's
scripts/gen_subjects_and_eval.py), over the port's `cli/common` loaders,
`AdaFacePipeline` and `eval/harness.compare_folders`. The CLIP ViT-B/32
scorer and the DINO ViT-S/16 score with random weights from fixed seeds,
as the JAX CLI's do. Prompt `pi` is generated with seed `--seed + pi`; a
subject whose photos show no face is skipped.

    python -m adaprompt_tpu_torch.cli.gen_eval --subjects_root subjects/ \\
        --ckpt v1-5-pruned-emaonly.ckpt --adaface_ckpt embeddings_gs-1000.pt \\
        --arcface_ckpt glint360k_r100.pth --max_prompts 4 --outdir out/
"""

from __future__ import annotations

import argparse
import csv
import os

from adaprompt_tpu_torch.cli import common
from adaprompt_tpu_torch.eval.prompts import format_prompt_list

SCORE_COLUMNS = ["subject", "sim_img", "sim_text", "sim_dino", "sim_face"]


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    common.add_model_args(p)
    p.add_argument("--subjects_root", type=str, required=True)
    p.add_argument("--subjects", type=str, nargs="*", default=None)
    p.add_argument("--adaface_ckpt", type=str, default=None)
    p.add_argument("--subject_string", type=str, default="z")
    p.add_argument("--prompt_set", type=str, default="dreambench",
                   choices=["dreambench", "community", "all"])
    p.add_argument("--n_per_prompt", type=int, default=4)
    p.add_argument("--max_prompts", type=int, default=None)
    p.add_argument("--num_steps", type=int, default=50)
    p.add_argument("--guidance_scale", type=float, default=4.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--outdir", type=str, default="outputs/gen_eval")
    p.add_argument("--arcface_ckpt", type=str, default=None)
    p.add_argument("--use_fp_trick", action="store_true", default=True)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    pipe = common.load_pipeline(args)
    sbg, scfg = common.load_subj_basis(args, pipe)

    from adaprompt_tpu_torch.adaface.wrapper import AdaFacePipeline
    from adaprompt_tpu_torch.data.dataset import scan_subject_folders
    from adaprompt_tpu_torch.eval import harness
    from adaprompt_tpu_torch.eval.face_eval import FaceSimilarityEvaluator

    face_embedder = FaceSimilarityEvaluator(common.load_arcface(args.arcface_ckpt, pipe.device))
    scorer, dino_eval = common.random_scorers(pipe.tokenizer, pipe.device)

    rows = []
    for subj in scan_subject_folders(args.subjects_root, subject_names=args.subjects):
        ada = AdaFacePipeline(pipe, sbg, scfg, pipe.text, pipe.text.cfg,
                              face_embedder=face_embedder, subject_string=args.subject_string)
        if ada.generate_adaface_embeddings(image_paths=subj.image_paths, seed=args.seed) is None:
            print(f"skip {subj.name}: no face")
            continue
        prompts, short_prompts, _ = format_prompt_list(
            args.subject_string, class_token=subj.cls_delta_string,
            class_long_token=subj.cls_delta_string, broad_class=subj.broad_class,
            prompt_set_name=args.prompt_set, use_fp_trick=args.use_fp_trick)
        if args.max_prompts:
            prompts = prompts[: args.max_prompts]
        subj_out = os.path.join(args.outdir, subj.name)
        for pi, prompt in enumerate(prompts):
            imgs = ada(prompt, out_image_count=args.n_per_prompt, num_steps=args.num_steps,
                       guidance_scale=args.guidance_scale, seed=args.seed + pi)
            common.save_images(imgs, subj_out, prefix=f"p{pi:03d}")
        scores = harness.compare_folders(scorer, dino_eval, os.path.dirname(subj.image_paths[0]),
                                         subj_out, short_prompts[0], face_evaluator=face_embedder)
        rows.append({"subject": subj.name, "sim_img": scores.sim_img,
                     "sim_text": scores.sim_text, "sim_dino": scores.sim_dino,
                     "sim_face": scores.sim_face})
        print(rows[-1])

    os.makedirs(args.outdir, exist_ok=True)
    csv_path = os.path.join(args.outdir, "scores.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=SCORE_COLUMNS)
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {csv_path}")
    return rows


if __name__ == "__main__":
    main()
