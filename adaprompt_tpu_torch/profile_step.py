"""Where the time of a txt2img generate goes on the card.

    python -m adaprompt_tpu_torch.profile_step [--steps 5] [--trace out.json]

Runs the full-width SD-1.5 pipeline (random weights from seed 0, bf16, 2
prompts, 512x512) once to warm up, then once more with `steps` DDIM steps
under torch.profiler, and prints the device time by kernel class (the
port's three CUDA kernels, convolutions, matrix products, the rest), the
top kernels by device time, and the device's busy share of the wall time.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import time

PROMPTS = ["a portrait photo of a person, detailed, studio lighting",
           "a photo of a red car parked by the sea"]
OUR_KERNELS = {"flash_fwd_kernel": "flash_attention_fwd",
               "fused_cross_kernel": "fused_cross_attention",
               "geglu_kernel": "geglu"}


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
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile
    from adaprompt_tpu_torch.pipeline import StableDiffusionPipeline

    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA card")
    pipe = StableDiffusionPipeline.random_init(0, device="cuda", dtype=torch.bfloat16)
    pipe.generate(PROMPTS, num_steps=2, seed=1)                    # build + warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.generate(PROMPTS, num_steps=args.steps, seed=0)
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
        cls = kernel_class(ev.key)
        by_class[cls] = by_class.get(cls, 0.0) + dev_us / 1e3
        kernels.append((dev_us / 1e3, ev.count, ev.key[:90]))
    busy_ms = sum(by_class.values())
    print(f"card: {torch.cuda.get_device_name(0)}; generate with {args.steps} DDIM steps: "
          f"wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}% of wall; idle {100 - 100 * busy_ms / wall_ms:.1f}%)")
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {cls:32s} {ms:10.3f} ms  {100 * ms / busy_ms:5.1f}%")
    print("top kernels by device time (ms, launches, name):")
    for ms, n, name in sorted(kernels, reverse=True)[:20]:
        print(f"  {ms:10.3f} {n:6d}  {name}")
    print(json.dumps({"steps": args.steps, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                      "by_class_ms": by_class}))


if __name__ == "__main__":
    main()
