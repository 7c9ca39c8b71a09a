"""Training CLI: Stage-1 and Stage-2 distillation over folders of photos.

Port of `adaprompt_tpu/cli/train.py`. The models go on `--device` (CUDA by
default; on a host without CUDA they raise); tests pass `--device cpu`.

Stage-1 (Arc2Face distillation):
  python -m adaprompt_tpu_torch.cli.train --stage 1 \\
      --data_roots /data/vggface2 /data/ffhq \\
      --ckpt v1-5-pruned-emaonly.ckpt --arc2face_ckpt arc2face.ckpt \\
      --arcface_ckpt glint360k_r100.pth --max_steps 120000 --bs 4

Stage-2 (compositional distillation):
  python -m adaprompt_tpu_torch.cli.train --stage 2 \\
      --data_roots ... --adaface_ckpt runs/s1/embeddings_gs-120000.npz \\
      --clip_ckpt clip-vit-b32.bin --max_steps 60000 --bs 3

Each subject is a folder of photos, with `<stem>_mask.png` foreground masks
beside them (`data/dataset.py`). Signals wait for the step they arrive in
to end, since a step updates its leaves one by one in Python: then SIGUSR1
saves the full trainer state and training goes on, and SIGINT raises
KeyboardInterrupt (a second SIGINT at once). An exception or interrupt
raised between steps saves the full state of the last step and is raised
again; one raised part-way through a step is raised again with nothing
saved, since the trainer then holds no step's state. `--resume_state` takes
a saved state up at its step. `--profile_dir` writes a torch.profiler trace
of steps start+2 to start+4. `--overlay_source` (a folder of backgrounds
with .txt captions, or a .tar of them) composites examples over backgrounds
with probability `--overlay_prob` (`data/overlays.py`), as JAX's CLI does; no
trainer of either package reads the composites' `wds_*` fields.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import signal
import time

import numpy as np
import torch

from adaprompt_tpu_torch.adaface import subj_basis_generator as sbg_mod
from adaprompt_tpu_torch.cli import common
from adaprompt_tpu_torch.data import dataset as ds
from adaprompt_tpu_torch.data.overlays import BackgroundOverlayProvider
from adaprompt_tpu_torch.models import clip_text, unet as unet_mod
from adaprompt_tpu_torch.ops.layers import reset_parameters
from adaprompt_tpu_torch.train import steps as steps_mod
from adaprompt_tpu_torch.train import trainer as trainer_mod
from adaprompt_tpu_torch.utils import torch_port


def parse_args(argv=None):
    from adaprompt_tpu_torch.utils.config import add_config_args, apply_config_files
    p = argparse.ArgumentParser()
    add_config_args(p)   # --base yaml(s) + --set dotlist
    common.add_model_args(p)
    p.add_argument("--data_roots", type=str, nargs="+", required=True)
    p.add_argument("--stage", type=int, default=1, choices=(1, 2),
                   help="hyperparameter preset: 1 = Arc2Face distillation, "
                        "2 = compositional")
    p.add_argument("--arc2face_ckpt", type=str, default=None,
                   help="arc2face UNet+text-encoder checkpoint")
    p.add_argument("--arcface_ckpt", type=str, default=None,
                   help="ArcFace IResNet-100 weights (.pth or .onnx) for REAL face "
                        "identity embeddings (required unless --synthetic_faces)")
    p.add_argument("--synthetic_faces", action="store_true",
                   help="train on random face ids (smoke runs only)")
    p.add_argument("--detector", type=str, default=None,
                   help="face detector: 'retinaface:<Resnet50_Final.pth|.onnx>' "
                        "(the reference's RetinaFace; the default when "
                        "$ADAPROMPT_RETINAFACE_CKPT is set), 'bisenet:<79999_iter.pth>' "
                        "(parsing detection + alignment; the default when "
                        "$ADAPROMPT_BISENET_CKPT is set), 'cascade:<opencv_xml_path>' "
                        "(needs cv2), or 'center_crop' (the default otherwise); the "
                        "RetinaFace and BiSeNet models run on --device")
    p.add_argument("--clip_ckpt", type=str, default=None,
                   help="CLIP ViT-B/32 weights (a transformers CLIPModel state dict) "
                        "for compositional teacher filtering")
    p.add_argument("--no_teacher_filter", action="store_true",
                   help="explicit opt-in: run compositional iterations "
                        "WITHOUT the CLIP teacher filter (every fresh "
                        "compos iter treated as teachable; the reference "
                        "keeps only ~30-40%%). Smoke runs only.")
    p.add_argument("--adaface_ckpt", type=str, default=None,
                   help="start the SubjBasisGenerator from this .npz checkpoint")
    p.add_argument("--resume_state", type=str, default=None,
                   help="full trainer_state-*.npz (params+optimizer+step)")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--bs", type=int, default=None)
    p.add_argument("--accum", type=int, default=2)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--optimizer", type=str, default="Prodigy")
    p.add_argument("--d_coef", type=float, default=None)
    p.add_argument("--warm_up_steps", type=int, default=None)
    p.add_argument("--composition_regs_iter_gap", type=int, default=None)
    p.add_argument("--arc2face_distill_iter_prob", type=float, default=None)
    p.add_argument("--max_num_denoising_steps", type=int, default=None)
    p.add_argument("--num_candidate_teachers", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out_dir", type=str, default="runs/adaprompt")
    p.add_argument("--ckpt_every", type=int, default=500)
    p.add_argument("--overlay_source", type=str, default=None,
                   help="background-overlay dir or .tar (wds role)")
    p.add_argument("--overlay_prob", type=float, default=0.0)
    p.add_argument("--fsdp", type=int, default=1,
                   help="fsdp axis size (multi-card training is not ported yet: > 1 raises)")
    p.add_argument("--sample_every", type=int, default=0,
                   help="save a sample strip every N steps")
    p.add_argument("--num_steps", type=int, default=None,
                   help="steps to run this invocation (default: max_steps)")
    p.add_argument("--num_workers", type=int, default=2,
                   help="data-loader worker threads (0 = synchronous)")
    p.add_argument("--mode", type=str, default="zeroshot",
                   choices=("zeroshot", "static"),
                   help="zeroshot = train the SubjBasisGenerator (AdaFace); "
                        "static = legacy per-subject textual-inversion "
                        "embeddings (StaticLayerwiseEmbedding)")
    p.add_argument("--static_rank", type=int, default=6,
                   help="static mode: LoRA-style basis rank r")
    p.add_argument("--num_vectors_per_subj_token", type=int, default=16)
    p.add_argument("--use_conv_attn_kernel_size", type=int, default=None,
                   help="subject-token conv attention kernel size; requires "
                        "num_vectors_per_subj_token >= ks*ks")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of a few steps here")
    args = p.parse_args(argv)
    return apply_config_files(args, p, argv)


def build_trainer_config(args) -> trainer_mod.TrainerConfig:
    base = (trainer_mod.TrainerConfig() if args.stage == 1
            else trainer_mod.TrainerConfig.stage2())
    overrides = dict(
        grad_accum=args.accum, optimizer_type=args.optimizer,
        num_candidate_teachers=args.num_candidate_teachers,
        seed=args.seed, ckpt_every=args.ckpt_every, out_dir=args.out_dir,
        compute_dtype="bfloat16" if args.bf16 else "float32")
    for name in ("max_steps", "d_coef", "warm_up_steps",
                 "composition_regs_iter_gap", "arc2face_distill_iter_prob",
                 "max_num_denoising_steps", "use_conv_attn_kernel_size"):
        v = getattr(args, name)
        if v is not None:
            overrides[name] = v
    return dataclasses.replace(base, **overrides)


def load_teacher(path: str, pipe):
    """The Arc2Face teacher UNet (in the pipeline's UNet dtype) and text
    encoder (float32) from a checkpoint in the SD layout, or from bare UNet /
    CLIP text state dicts where the file holds no SD prefixes."""
    a2f_sd = torch_port.load_state_dict(path)
    parts = torch_port.split_sd_checkpoint(a2f_sd)
    unet = unet_mod.UNet(pipe.unet.cfg, device=pipe.device, dtype=pipe.compute_dtype)
    unet.load_state_dict(unet_mod.from_torch(parts["unet"] or a2f_sd, pipe.unet.cfg), strict=True)
    text = clip_text.CLIPTextModel(pipe.text.cfg, device=pipe.device)
    text.load_state_dict(clip_text.from_torch(parts["text"] or a2f_sd, pipe.text.cfg), strict=True)
    return unet.requires_grad_(False), text.requires_grad_(False)


def train_static(args, pipe, frozen):
    """Legacy textual-inversion mode: one StaticLayerwiseEmbedding trained by
    masked reconstruction over the subjects' photos; `static_emb_gs-N.npz`
    checkpoints."""
    from adaprompt_tpu_torch.adaface import checkpoint as ckpt_mod
    from adaprompt_tpu_torch.adaface import conditioner as cond_mod
    from adaprompt_tpu_torch.adaface import static_embedder as se
    from adaprompt_tpu_torch.models.vae import SD_SCALE_FACTOR

    tok, dev = pipe.tokenizer, pipe.device
    cfg = build_trainer_config(args)
    scfg = se.StaticEmbedderConfig(num_vectors=args.num_vectors_per_subj_token,
                                   rank=args.static_rank,
                                   out_emb_dim=pipe.text.cfg.hidden_size)
    emb = se.StaticLayerwiseEmbedding(scfg, torch.Generator(device=dev).manual_seed(args.seed),
                                      device=dev)
    params = {"static_emb": emb}
    state = steps_mod.TrainState(params, trainer_mod.build_optimizer(
        cfg, steps_mod.trainable_parameters(params)))
    step_fn = trainer_mod.make_static_recon_step(
        frozen, scfg, compute_dtype=torch.bfloat16 if args.bf16 else torch.float32)

    subjects = ds.scan_subject_folders(args.data_roots)
    dset = ds.PersonalizedDataset(subjects, size=args.size, seed=args.seed,
                                  num_vectors_per_subj_token=scfg.num_vectors)
    it = ds.make_batch_iterator(dset, ds.SubjectSampler(subjects, seed=args.seed),
                                batch_size=args.bs or 4,
                                num_workers=args.num_workers)
    spec = cond_mod.make_placeholders(tok, ("z",), (),
                                      num_vectors_subj=scfg.num_vectors)[0]
    fp = steps_mod.frozen_params(frozen)

    os.makedirs(args.out_dir, exist_ok=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    n = args.num_steps or cfg.max_steps
    for i in range(n):
        raw = next(it)
        imgs = torch.as_tensor(np.asarray(raw["image"]), device=dev).to(pipe.compute_dtype)
        ids = np.asarray(tok([c for c in raw["caption"]]))
        bi, pos = cond_mod.find_placeholder_indices(ids, spec)
        b = imgs.shape[0]
        with torch.no_grad():
            z0 = (pipe.vae.encode(imgs)[0] * SD_SCALE_FACTOR).float()
        batch = {"z0": z0,
                 "caption_ids": torch.as_tensor(ids, device=dev).long(),
                 "subj_bi": torch.as_tensor(bi if len(bi) == b else np.arange(b),
                                            device=dev).long(),
                 "subj_pos": torch.as_tensor(pos if len(pos) == b else np.full(b, 1),
                                             device=dev).long(),
                 "fg_mask": None, "aug_mask": None,
                 "skip_weights": torch.tensor([0.5, 0.5], device=dev)}
        state, metrics = step_fn(state, fp, batch, gen)
        if (i + 1) % cfg.ckpt_every == 0 or i == n - 1:
            ckpt_mod.save_checkpoint(
                os.path.join(args.out_dir, f"static_emb_gs-{i + 1}.npz"),
                {"static_emb": ckpt_mod.module_tree(state.params["static_emb"])},
                meta={"step": i + 1, "mode": "static"})
        print(f"step {i}: loss {float(metrics['loss_recon']):.4f}")
    return state


def main(argv=None):
    args = parse_args(argv)
    pipe = common.load_pipeline(args)
    tok = pipe.tokenizer

    allow_self_teacher = False
    if args.arc2face_ckpt and os.path.exists(args.arc2face_ckpt):
        teacher_unet, a2f_text = load_teacher(args.arc2face_ckpt, pipe)
    else:
        # no Arc2Face teacher: distilling against the student's own frozen
        # SD UNet is meaningless for a real run; allowed only under the
        # same explicit smoke-run opt-in as random face ids
        if not args.synthetic_faces and args.mode != "static":
            raise SystemExit(
                "no --arc2face_ckpt: a real training run would distill "
                "against the student's own frozen UNet. Pass "
                "--arc2face_ckpt, or --synthetic_faces for a smoke run "
                "that accepts the self-teacher fallback.")
        print("WARNING: no arc2face ckpt — teacher uses the SD UNet/text "
              "weights (smoke-run fallback).")
        teacher_unet, a2f_text = pipe.unet, pipe.text
        allow_self_teacher = True

    frozen = steps_mod.FrozenSD(unet=pipe.unet, text=pipe.text, arc2face_text=a2f_text,
                                teacher_unet=teacher_unet)

    if args.mode == "static":
        return train_static(args, pipe, frozen)

    # the subject vectors take the text encoder's width (SD-1.5's 768, the
    # config's default, at full width)
    scfg = sbg_mod.SubjBasisConfig(placeholder_is_bg=False, output_dim=pipe.text.cfg.hidden_size,
                                   text_cfg=pipe.text.cfg)
    sbg = reset_parameters(sbg_mod.SubjBasisGenerator(scfg, device=pipe.device),
                           torch.Generator(device=pipe.device).manual_seed(args.seed))

    # real identity embeddings: the ArcFace trunk on host-detected crops
    face_embedder = None
    if args.arcface_ckpt:
        from adaprompt_tpu_torch.eval.face_eval import FaceSimilarityEvaluator, make_detector
        face_embedder = FaceSimilarityEvaluator(
            common.load_arcface(args.arcface_ckpt, pipe.device),
            detector=make_detector(args.detector, device=pipe.device))
    elif not args.synthetic_faces:
        raise SystemExit(
            "--arcface_ckpt is required: without it every iteration distills "
            "against a random identity. Pass --synthetic_faces to opt into "
            "that for smoke tests.")

    cfg = build_trainer_config(args)
    if allow_self_teacher:
        cfg = dataclasses.replace(cfg, allow_self_teacher=True)

    # CLIP teacher filtering of the compositional iterations
    clip_scorer = None
    if cfg.composition_regs_iter_gap > 0:
        if args.clip_ckpt:
            from adaprompt_tpu_torch.eval.clip_scorer import CLIPScorer
            clip_scorer = CLIPScorer.from_torch(torch_port.load_state_dict(args.clip_ckpt),
                                                tokenizer=tok, device=pipe.device)
        elif not args.no_teacher_filter:
            # refuse rather than silently train on a worse distribution:
            # the reference's filter keeps only ~30-40% of fresh compos iters
            raise SystemExit(
                "compositional training without --clip_ckpt disables the "
                "CLIP teacher filter: EVERY fresh compositional iteration "
                "would be treated as teachable (the reference keeps only "
                "~30-40%). Pass --clip_ckpt, or opt in "
                "explicitly with --no_teacher_filter.")
        else:
            print("=" * 70)
            print("WARNING: --no_teacher_filter — CLIP teacher filtering "
                  "DISABLED;\nevery compositional iteration is treated as "
                  "teachable. The training\ndistribution differs materially "
                  "from the reference Stage-2 run.\n(metrics.jsonl carries "
                  "teacher_filter_disabled=1 on compos iters.)")
            print("=" * 70)
            cfg = dataclasses.replace(cfg, no_teacher_filter=True)

    subjects = ds.scan_subject_folders(args.data_roots)
    print(f"{len(subjects)} subjects, {sum(len(s.image_paths) for s in subjects)} images")
    overlay = None
    if args.overlay_source:
        overlay = BackgroundOverlayProvider(args.overlay_source, size=args.size, seed=args.seed)
    dset = ds.PersonalizedDataset(subjects, size=args.size, seed=args.seed,
                                  num_vectors_per_subj_token=scfg.num_out_embs_per_layer,
                                  overlay_provider=overlay, overlay_prob=args.overlay_prob)
    bs = args.bs or (4 if args.stage == 1 else 3)
    it = ds.make_batch_iterator(dset, ds.SubjectSampler(subjects, seed=args.seed),
                                batch_size=bs, num_workers=args.num_workers)

    tr = trainer_mod.AdaPromptTrainer(frozen, pipe.vae, tok, scfg, sbg, it, cfg,
                                      face_embedder=face_embedder, clip_scorer=clip_scorer,
                                      synthetic_faces=args.synthetic_faces)
    start = 0
    if args.resume_state:
        meta = tr.load_full_state(args.resume_state)
        start = int(meta["step"])
        print(f"resumed full trainer state at step {start}")
    elif args.adaface_ckpt:
        tr.load_checkpoint(args.adaface_ckpt)

    num_devices = torch.cuda.device_count() if pipe.device.type == "cuda" else 1
    if num_devices > 1 or args.fsdp > 1:
        tr.distribute(fsdp=args.fsdp)

    # Signals wait for the end of the step they arrive in: the step updates
    # its leaves one by one, so a state written, or an interrupt raised,
    # part-way through it would belong to no step. A second SIGINT raises at
    # once, for a step that does not end.
    held = []

    def _hold(signum, frame):
        if signum == signal.SIGINT and signal.SIGINT in held:
            raise KeyboardInterrupt
        held.append(signum)

    handlers = {}
    for sig in (signal.SIGUSR1, signal.SIGINT):
        with contextlib.suppress(ValueError, OSError):   # not the main thread
            handlers[sig] = signal.signal(sig, _hold)

    n = args.num_steps or cfg.max_steps
    prof = None
    done, in_step = start, False      # steps whose state the trainer holds
    t0 = time.time()
    try:
        for i in range(start, n):
            if args.profile_dir and i == start + 2:
                prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]
                                              + ([torch.profiler.ProfilerActivity.CUDA]
                                                 if pipe.device.type == "cuda" else []))
                prof.start()
            in_step = True
            tr.train_step(i)
            in_step, done = False, i + 1
            if prof is not None and (i == start + 4 or i == n - 1):
                prof.stop()
                os.makedirs(args.profile_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(args.profile_dir, "trace.json"))
                print(f"profiler trace written to {args.profile_dir}")
                prof = None
            if args.sample_every and (i + 1) % args.sample_every == 0:
                tr.log_samples(i + 1)
            if (i + 1) % cfg.ckpt_every == 0 or i == n - 1:
                tr.save_checkpoint(i + 1)
            if signal.SIGUSR1 in held:
                held.remove(signal.SIGUSR1)
                print(f"SIGUSR1: saved {tr.save_full_state(done)}")
            if signal.SIGINT in held:
                raise KeyboardInterrupt
    except BaseException:
        if in_step:
            print(f"step {done} raised part-way: the trainer holds no step's state, "
                  "so none is saved")
            raise
        # checkpoint on interrupt or crash (the reference's melk())
        path = tr.save_full_state(done)
        print(f"interrupted: saved full trainer state to {path}")
        raise
    finally:
        for sig, handler in handlers.items():
            signal.signal(sig, handler)
    print(f"trained {n - start} steps in {time.time() - t0:.1f}s")
    return tr


if __name__ == "__main__":
    main()
