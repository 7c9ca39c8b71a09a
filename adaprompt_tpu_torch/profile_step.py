"""Where the time of a txt2img generate, of Stage-1 training steps, of a
generate through the int8 serving stack, or of a personalized generate goes
on the card.

    python -m adaprompt_tpu_torch.profile_step [--steps 5] [--flash exp2|ilv|nomax ...]
    python -m adaprompt_tpu_torch.profile_step --train [--flash exp2|ilv|nomax ...]
    python -m adaprompt_tpu_torch.profile_step --serve [int8|bf16] [--trace out.json]
    python -m adaprompt_tpu_torch.profile_step --personalize [on|off] [--steps 5]

Default: runs the full-width SD-1.5 pipeline (random weights from seed 0,
bf16, 2 prompts, 512x512) once to warm up, then once more with `steps` DDIM
steps under torch.profiler. --train: builds the full-width Stage-1 trainer
(random weights, bs 4, 512x512, Prodigy with gradient accumulation 2),
takes training steps 0 and 1 (ND 1 and 5 from seed 0) to warm up, then
profiles steps 2 and 3 (ND 1 both; step 3 applies the accumulated update).
--flash (these two modes): the UNet's self-attention takes that form of the
flash kernels, `UNetConfig(flash_variant=FlashVariant(...))`; several names
combine (`--flash ilv exp2`), and the device time by class then shows the
chosen forward kernel under its own name.
--serve: the full-width pipeline with quant="int8" (or, with `--serve
bf16`, without it; random weights from seed 0, bf16, 2 prompts, 512x512),
one 4-step warm-up, then one generate with sampler="dpmpp", 20 steps and
FastConfig() (ToMe 0.5, DeepCache 3/3, CFG tail 0.3) under the profiler.
--personalize: the full-width AdaFacePipeline (random weights from seed 0,
IResNet-100 ArcFace, bf16 UNet) with UNetConfig.fused_conv on (default) or
off; one warm-up, then three seeded 512x512 photos ->
generate_adaface_embeddings -> 2 images with `steps` DDIM steps under the
profiler. The count of device kernels is printed too: the difference
between `off` and `on` is what the fused GroupNorm-SiLU-conv removed.
Prints the device time by kernel class (the port's CUDA kernels,
convolutions, matrix products, the rest), the top kernels by device time,
and the device's busy share of the wall time. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import time

PROMPTS = ["a portrait photo of a person, detailed, studio lighting",
           "a photo of a red car parked by the sea"]
OUR_KERNELS = {"flash_fwd_kernel": "flash_attention_fwd",
               "flash_bwd_kernel": "flash_attention_bwd",
               "flash_bwd_prepass_kernel": "flash_attention_bwd",     # delta, dQ scratch zeroed
               "flash_bwd_dq_convert_kernel": "flash_attention_bwd",  # dQ scratch -> bf16
               "fused_cross_kernel": "fused_cross_attention",
               "geglu_kernel": "geglu_fwd",
               "fused_cross_int8_kernel": "fused_cross_attention_int8",
               "geglu_int8_kernel": "geglu_int8",
               "conv3x3_halo_kernel<true>": "gn_silu_conv3x3_halo",
               "conv3x3_halo_kernel": "conv3x3_halo",
               "conv3x3_im2col_kernel": "conv3x3_im2col",
               "flash_fwd_ilv_kernel": "flash_attention_fwd_ilv",
               "flash_fwd_nomax_kernel": "flash_attention_fwd_nomax",
               "nomax_key_max_kernel": "flash_attention_fwd_nomax",     # its pre-pass over K
               "flash_fwd_int8_kernel": "flash_attention_int8",
               "fused_self_kernel": "fused_self_attention"}


def kernel_class(name: str) -> str:
    for key, label in OUR_KERNELS.items():
        if key in name:
            return label
    low = name.lower()
    if "conv" in low or "implicit_gemm" in low or "xmma_fprop" in low or "nhwc" in low:
        return "convolution (cuDNN)"
    if "gemm" in low or "cutlass" in low or "nvjet" in low or "sm90_xmma" in low:
        return "matrix product (cuBLAS)"
    if "reduce" in low or "norm" in low:
        return "reduction / normalization"
    return "elementwise and other"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    ap.add_argument("--flash", nargs="+", default=[], choices=("exp2", "ilv", "nomax"),
                    help="the flash kernels' form in the UNet's self-attention "
                         "(the default generate and --train)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--train", action="store_true",
                      help="profile two Stage-1 training steps instead of a generate")
    mode.add_argument("--serve", nargs="?", const="int8", choices=("int8", "bf16"),
                      help="profile one serving-stack generate (dpmpp-20, FastConfig()), "
                           "with the int8 kernels (default) or in bf16")
    mode.add_argument("--personalize", nargs="?", const="on", choices=("on", "off"),
                      help="profile one personalization and generate through AdaFacePipeline, "
                           "with UNetConfig.fused_conv on (default) or off")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA card")
    if args.flash and (args.serve or args.personalize):
        raise SystemExit("profile_step: --flash goes with the default generate or --train")
    from adaprompt_tpu_torch.models.unet import UNetConfig
    from adaprompt_tpu_torch.ops.attention import FlashVariant
    flash_cfg = UNetConfig(flash_variant=FlashVariant(**{name: True for name in args.flash}))
    flash = f", flash {'+'.join(args.flash)}" if args.flash else ""
    if args.train:
        import tempfile
        from adaprompt_tpu_torch.train.trainer import (AdaPromptTrainer, TrainerConfig,
                                                       synthetic_raw_batches)
        tmp = tempfile.TemporaryDirectory()
        tr = AdaPromptTrainer.random_init(0, synthetic_raw_batches(0),
                                          TrainerConfig(seed=0, out_dir=tmp.name), device="cuda",
                                          unet_cfg=flash_cfg)
        work = lambda: [tr.train_step(i) for i in (2, 3)]
        for i in (0, 1):                                           # build + warm up
            tr.train_step(i)
        what = f"2 Stage-1 training steps (ND 1, bs 4){flash}"
    elif args.serve:
        from adaprompt_tpu_torch.pipeline import FastConfig, StableDiffusionPipeline
        pipe = StableDiffusionPipeline.random_init(
            0, device="cuda", dtype=torch.bfloat16,
            quant="int8" if args.serve == "int8" else None)
        kw = dict(sampler="dpmpp", fast=FastConfig())
        pipe.generate(PROMPTS, num_steps=4, seed=1, **kw)         # build + warm up
        work = lambda: pipe.generate(PROMPTS, num_steps=20, seed=0, **kw)
        what = f"{args.serve} serving-stack generate (dpmpp-20, FastConfig())"
    elif args.personalize:
        import numpy as np
        from adaprompt_tpu_torch.adaface.wrapper import AdaFacePipeline
        ada = AdaFacePipeline.random_init(
            0, unet_cfg=UNetConfig(fused_conv=args.personalize == "on"))
        rng = np.random.default_rng(0)
        photos = [rng.integers(0, 256, (512, 512, 3)).astype(np.uint8) for _ in range(3)]

        def work():
            ada.generate_adaface_embeddings(images_np=photos, seed=0)
            ada("portrait of a z person", out_image_count=2, num_steps=args.steps, seed=0)

        ada.generate_adaface_embeddings(images_np=photos, seed=1)     # build + warm up
        ada("portrait of a z person", out_image_count=2, num_steps=2, seed=1)
        what = (f"personalization (3 photos) and generate of 2 images with {args.steps} DDIM "
                f"steps, fused_conv {args.personalize}")
    else:
        from adaprompt_tpu_torch.pipeline import StableDiffusionPipeline
        pipe = StableDiffusionPipeline.random_init(0, device="cuda", dtype=torch.bfloat16,
                                                   unet_cfg=flash_cfg)
        pipe.generate(PROMPTS, num_steps=2, seed=1)                # build + warm up
        work = lambda: pipe.generate(PROMPTS, num_steps=args.steps, seed=0)
        what = f"generate with {args.steps} DDIM steps{flash}"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if args.trace:
        prof.export_chrome_trace(args.trace)

    by_class, kernels, n_launches = {}, [], 0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if getattr(ev, "is_user_annotation", False) or ev.key.startswith("Optimizer."):
            continue        # a span over kernels counted on their own (e.g. Prodigy.step)
        cls = kernel_class(ev.key)
        by_class[cls] = by_class.get(cls, 0.0) + dev_us / 1e3
        kernels.append((dev_us / 1e3, ev.count, ev.key[:90]))
        n_launches += ev.count
    busy_ms = sum(by_class.values())
    print(f"card: {torch.cuda.get_device_name(0)}; {what}: "
          f"wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}% of wall; idle {100 - 100 * busy_ms / wall_ms:.1f}%); "
          f"{n_launches} device kernels and copies")
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {cls:32s} {ms:10.3f} ms  {100 * ms / busy_ms:5.1f}%")
    print("top kernels by device time (ms, launches, name):")
    for ms, n, name in sorted(kernels, reverse=True)[:20]:
        print(f"  {ms:10.3f} {n:6d}  {name}")
    print(json.dumps({"work": what, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                      "device_launches": n_launches, "by_class_ms": by_class}))


if __name__ == "__main__":
    main()
