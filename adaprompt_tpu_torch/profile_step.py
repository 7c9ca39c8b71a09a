"""Where the time of a txt2img generate, or of Stage-1 training steps,
goes on the card.

    python -m adaprompt_tpu_torch.profile_step [--steps 5] [--trace out.json]
    python -m adaprompt_tpu_torch.profile_step --train [--trace out.json]

Default: runs the full-width SD-1.5 pipeline (random weights from seed 0,
bf16, 2 prompts, 512x512) once to warm up, then once more with `steps` DDIM
steps under torch.profiler. --train: builds the full-width Stage-1 trainer
(random weights, bs 4, 512x512, Prodigy with gradient accumulation 2),
takes training steps 0 and 1 (ND 1 and 5 from seed 0) to warm up, then
profiles steps 2 and 3 (ND 1 both; step 3 applies the accumulated update).
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
               "flash_bwd_dq_kernel": "flash_attention_bwd",
               "flash_bwd_dkv_kernel": "flash_attention_bwd",
               "fused_cross_kernel": "fused_cross_attention",
               "geglu_kernel": "geglu_fwd"}


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
    ap.add_argument("--train", action="store_true",
                    help="profile two Stage-1 training steps instead of a generate")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA card")
    if args.train:
        import tempfile
        from adaprompt_tpu_torch.train.trainer import (AdaPromptTrainer, TrainerConfig,
                                                       synthetic_raw_batches)
        tmp = tempfile.TemporaryDirectory()
        tr = AdaPromptTrainer.random_init(0, synthetic_raw_batches(0),
                                          TrainerConfig(seed=0, out_dir=tmp.name), device="cuda")
        work = lambda: [tr.train_step(i) for i in (2, 3)]
        for i in (0, 1):                                           # build + warm up
            tr.train_step(i)
        what = "2 Stage-1 training steps (ND 1, bs 4)"
    else:
        from adaprompt_tpu_torch.pipeline import StableDiffusionPipeline
        pipe = StableDiffusionPipeline.random_init(0, device="cuda", dtype=torch.bfloat16)
        pipe.generate(PROMPTS, num_steps=2, seed=1)                # build + warm up
        work = lambda: pipe.generate(PROMPTS, num_steps=args.steps, seed=0)
        what = f"generate with {args.steps} DDIM steps"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if args.trace:
        prof.export_chrome_trace(args.trace)

    by_class, kernels = {}, []
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
    busy_ms = sum(by_class.values())
    print(f"card: {torch.cuda.get_device_name(0)}; {what}: "
          f"wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}% of wall; idle {100 - 100 * busy_ms / wall_ms:.1f}%)")
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {cls:32s} {ms:10.3f} ms  {100 * ms / busy_ms:5.1f}%")
    print("top kernels by device time (ms, launches, name):")
    for ms, n, name in sorted(kernels, reverse=True)[:20]:
        print(f"  {ms:10.3f} {n:6d}  {name}")
    print(json.dumps({"work": what, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                      "by_class_ms": by_class}))


if __name__ == "__main__":
    main()
