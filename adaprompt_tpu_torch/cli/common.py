"""Shared CLI plumbing: the SD pipeline, the ArcFace trunk and the
SubjBasisGenerator from checkpoints (or random weights), the evaluation
CLIs' random-weight scorers, and PNG output.

Port of `adaprompt_tpu/cli/common.py` and of `load_subj_basis` of
`adaprompt_tpu/cli/txt2img.py`. Every CLI takes `--device` (CUDA by
default; on a host without CUDA the models raise rather than fall back to
the CPU): tests pass `--device cpu`.
"""

from __future__ import annotations

import os

import torch

from adaprompt_tpu_torch.pipeline import StableDiffusionPipeline
from adaprompt_tpu_torch.utils.png import write_png
from adaprompt_tpu_torch.utils.tokenizer import CLIPTokenizer


def add_model_args(p):
    p.add_argument("--ckpt", type=str, default=os.environ.get("ADAPROMPT_SD_CKPT"),
                   help="SD-1.5 checkpoint (.ckpt/.safetensors); random init if absent")
    p.add_argument("--tokenizer_dir", type=str,
                   default=os.environ.get("ADAPROMPT_TOKENIZER_DIR"),
                   help="dir with vocab.json + merges.txt (fallback vocab otherwise)")
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--fp32", dest="bf16", action="store_false")
    p.add_argument("--device", type=str, default="cuda",
                   help="the models' device; 'cpu' runs on the host (slow at full size)")


def load_pipeline(args) -> StableDiffusionPipeline:
    """The SD pipeline from --ckpt, or with random weights (and a WARNING)
    when there is none; UNet and VAE in bf16 unless --fp32."""
    tok = CLIPTokenizer.load(args.tokenizer_dir)
    dt = torch.bfloat16 if args.bf16 else torch.float32
    if args.ckpt and os.path.exists(args.ckpt):
        return StableDiffusionPipeline.from_checkpoint(args.ckpt, device=args.device, dtype=dt,
                                                       tokenizer=tok)
    print("WARNING: no SD checkpoint found — using random weights "
          "(compile/benchmark mode).")
    return StableDiffusionPipeline.random_init(0, device=args.device, dtype=dt, tokenizer=tok)


def load_subj_basis(args, pipe: StableDiffusionPipeline):
    """(SubjBasisGenerator on the pipeline's device, its config) from
    --adaface_ckpt: a native .npz (its 'subj_basis' tree) or a reference
    `embeddings_gs-*.pt` (the generator of --subject_string); random weights
    (and a WARNING) when there is none."""
    from adaprompt_tpu_torch import convert
    from adaprompt_tpu_torch.adaface import checkpoint as ckpt_mod
    from adaprompt_tpu_torch.adaface import subj_basis_generator as sbg
    from adaprompt_tpu_torch.ops.layers import reset_parameters
    scfg = sbg.SubjBasisConfig(placeholder_is_bg=False, text_cfg=pipe.text.cfg)
    if args.adaface_ckpt is None:
        print("WARNING: no adaface ckpt — random SubjBasisGenerator.")
        gen = torch.Generator(device=pipe.device).manual_seed(1)
        return reset_parameters(sbg.SubjBasisGenerator(scfg, device=pipe.device), gen), scfg
    if args.adaface_ckpt.endswith(".npz"):
        trees, _ = ckpt_mod.load_checkpoint(args.adaface_ckpt)
        state = convert.from_jax_params(trees["subj_basis"])
    else:
        ref = ckpt_mod.load_reference_checkpoint(args.adaface_ckpt)
        state = sbg.from_torch(ref["subj_basis_generators"][args.subject_string], scfg)
    return sbg.from_state(state, scfg, device=pipe.device), scfg


def load_arcface(path: str | None, device):
    """The IResNet-100 trunk from an insightface `.pth` at `path` (or an
    `.onnx` export, its initializers read without an ONNX runtime), or with
    random weights from seed 2 when `path` is None."""
    from adaprompt_tpu_torch.models import arcface
    from adaprompt_tpu_torch.pipeline import resolve_device
    from adaprompt_tpu_torch.utils.torch_port import load_state_dict
    cfg, device = arcface.IRESNET100, resolve_device(device)
    if path is None:
        return arcface.ArcFace.random_init(2, cfg, device=device)
    model = arcface.ArcFace(cfg, device=device)
    state = (arcface.from_onnx(path, cfg) if path.endswith(".onnx")
             else arcface.from_torch(load_state_dict(path), cfg))
    model.load_state_dict(state, strict=True)
    return model.eval()


def random_scorers(tokenizer, device):
    """(CLIPScorer, DINOEvaluator) with random weights (ViT-B/32 from seed
    0, DINO ViT-S/16 from seed 3) on `device`: what gen_eval and txt2img's
    --compare_with score with, as the JAX CLIs do."""
    from adaprompt_tpu_torch.eval.clip_scorer import CLIPScorer
    from adaprompt_tpu_torch.eval.dino_eval import DINOEvaluator
    from adaprompt_tpu_torch.models.dino import DINO
    return (CLIPScorer.random_init(0, tokenizer=tokenizer, device=device),
            DINOEvaluator(DINO.random_init(3, device=device)))


def save_images(images, outdir, prefix="sample") -> list[str]:
    """uint8 [N, H, W, 3] -> `<outdir>/<prefix>-00000.png`, ... (zlib PNG)."""
    os.makedirs(outdir, exist_ok=True)
    return [write_png(os.path.join(outdir, f"{prefix}-{i:05d}.png"), img)
            for i, img in enumerate(images)]
