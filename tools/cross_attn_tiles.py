"""Tile variants of the fused cross-attention B2 on the card, B2 alone.

    python3 tools/cross_attn_tiles.py [variant ...]      # from the repo root

Builds each variant of adaprompt_tpu_torch/csrc/fused_cross_attention.cu
(the source with one to three tile lines replaced; all variants by default)
into adaprompt_tpu_torch/csrc/build/tiles/, one nvcc each, in parallel;
then, at B2's four main-path shapes (C=320 N=4096 and C=640 N=1024 at B=4
and 2, 8 heads, 77 keys), holds each against the plain version
(attention.fused_cross_attention_reference) and prints the relative error,
the C call's time (CUDA events, 20 calls), each kernel's device time
(torch.profiler, 20 calls) and each kernel's resources (fused_cross_describe).
The committed tiles also run chip_smoke.CROSS_RAGGED. Needs a CUDA card.
"""

import ctypes
import math
import os
import shutil
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke  # noqa: E402
from adaprompt_tpu_torch.ops import attention as A, cuda_build  # noqa: E402

SRC = cuda_build.CSRC / "fused_cross_attention.cu"
Q_MT = "  static constexpr int MT = HDP <= 80 ? 2 : 1;"
Q_GEMM = "  using Gemm = BlockGemm<64 * MT, HDP, 64, 4, 1, HDP <= 48 ? 3 : 2>;"
Q_MIN = "  static constexpr int MIN_BLOCKS = 2;"
OUT_GEMM = "using Out = BlockGemm<128, 160, 64, 4, 2, 4>;            // tiles of out"
OUT_MIN = "constexpr int OUT_MIN_BLOCKS = 1;"
VARIANTS = {   # name -> [(line of the committed source, its replacement)]
    "committed": [],
    # the q-attention kernel: 64-row tiles (one m16 tile a warp), 3 stages
    "q_bm64": [(Q_MT, "  static constexpr int MT = 1;"),
               (Q_GEMM, "  using Gemm = BlockGemm<64 * MT, HDP, 64, 4, 1, 3>;"),
               (Q_MIN, "  static constexpr int MIN_BLOCKS = 3;")],
    # 2 or 3 ring stages at every head dim
    "q_st2": [(Q_GEMM, "  using Gemm = BlockGemm<64 * MT, HDP, 64, 4, 1, 2>;"),
              (Q_MIN, "  static constexpr int MIN_BLOCKS = 3;")],
    "q_st3": [(Q_GEMM, "  using Gemm = BlockGemm<64 * MT, HDP, 64, 4, 1, 3>;")],
    # the out kernel's tile
    "out_64x160": [(OUT_GEMM, "using Out = BlockGemm<64, 160, 64, 4, 2, 3>;"),
                   (OUT_MIN, "constexpr int OUT_MIN_BLOCKS = 2;")],
    "out_128x64": [(OUT_GEMM, "using Out = BlockGemm<128, 64, 64, 4, 2, 3>;"),
                   (OUT_MIN, "constexpr int OUT_MIN_BLOCKS = 2;")],
    "out_64x64": [(OUT_GEMM, "using Out = BlockGemm<64, 64, 64, 2, 2, 3>;"),
                  (OUT_MIN, "constexpr int OUT_MIN_BLOCKS = 3;")],
}
SHAPES = ((4, 4096, 320), (4, 1024, 640), (2, 4096, 320), (2, 1024, 640))   # B, N, C


def build(names):
    """{variant: (fused_cross_attention_fwd, fused_cross_describe)} of the
    variants that built; prints ptxas's register and spill lines."""
    root = cuda_build.BUILD_DIR / "tiles"
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for name in names:
        d = root / name
        d.mkdir(parents=True)
        for header in cuda_build.CSRC.glob("*.cuh"):
            shutil.copy(header, d)
        src = SRC.read_text()
        for old, new in VARIANTS[name]:
            if old not in src:
                raise SystemExit(f"{name}: the source has no line {old!r}")
            src = src.replace(old, new)
        (d / "k.cu").write_text(src)
        cmd = [cuda_build.nvcc(), *cuda_build.FLAGS, "-o", str(d / "k.so"), str(d / "k.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    fns = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        print(f"build {name}: rc={proc.returncode}", flush=True)
        if proc.returncode != 0:
            print(out[-3000:])
            continue
        for line in out.splitlines():
            if "Used" in line or "spill" in line:
                print("   ", line.strip())
        lib = ctypes.CDLL(str(root / name / "k.so"))
        fwd, describe = lib.fused_cross_attention_fwd, lib.fused_cross_describe
        fwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                                      ctypes.c_void_p]
        describe.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fwd.restype = describe.restype = ctypes.c_int
        fns[name] = (fwd, describe)
    return fns


def inputs(b, n, c, h, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    bf = torch.bfloat16
    x = torch.randn(b, n, c, device="cuda", generator=g).to(bf)
    w = lambda: ((torch.rand(c, c, device="cuda", generator=g) * 2 - 1) / math.sqrt(c)).to(bf)
    wq, wo = w(), w()
    k = torch.randn(b, 77, h, c // h, device="cuda", generator=g).to(bf)
    v = torch.randn(b, 77, h, c // h, device="cuda", generator=g).to(bf)
    bo = (torch.rand(c, device="cuda", generator=g) * 2 - 1) / math.sqrt(c)
    return x, wq, k, v, wo, bo, (c // h) ** -0.5, h


def call(fwd, args):
    x, wq, k, v, wo, bo, scale, h = args
    b, n, c = x.shape
    o, out = torch.empty_like(x), torch.empty_like(x)
    cuda_build.check(fwd(x.data_ptr(), wq.data_ptr(), k.data_ptr(), v.data_ptr(),
                         wo.data_ptr(), bo.data_ptr(), o.data_ptr(), out.data_ptr(), b, n, c, h,
                         k.shape[1], scale, torch.cuda.current_stream().cuda_stream),
                     "fused_cross_attention_fwd")
    return out


def per_kernel_ms(fwd, args, iters=20):
    from torch.profiler import ProfilerActivity, profile
    call(fwd, args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call(fwd, args)
        torch.cuda.synchronize()
    ms = {"q": 0.0, "out": 0.0}
    for e in prof.key_averages():
        if "cross_q_attn_kernel" in e.key:
            ms["q"] += e.device_time_total / iters / 1e3
        elif "cross_out_kernel" in e.key:
            ms["out"] += e.device_time_total / iters / 1e3
    return ms


def rel_err(fwd, args):
    out = call(fwd, args)
    ref = A.fused_cross_attention_reference(*args)
    torch.cuda.synchronize()
    return (out.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()


def main():
    names = sys.argv[1:] or list(VARIANTS)
    print(chip_smoke.card_line(), flush=True)
    for name, (fwd, describe) in build(names).items():
        for b, n, c in SHAPES:
            args = inputs(b, n, c, 8, n + c + b)
            err = rel_err(fwd, args)
            ms = chip_smoke.time_ms(lambda: call(fwd, args), 20)
            pk = per_kernel_ms(fwd, args)
            i = (ctypes.c_int * 14)()
            cuda_build.check(describe(b, n, c, 8, ctypes.addressof(i)), "fused_cross_describe")
            print(f"{name} C={c} N={n} B={b}: rel={err:.3e} call_ms={ms:.4f} "
                  f"q_ms={pk['q']:.4f} out_ms={pk['out']:.4f} "
                  f"q[regs={i[0]} smem={i[1]} {i[2]}x{i[3]} blocks/SM={i[4]} grid={i[5]} "
                  f"lmem={i[6]}] out[regs={i[7]} smem={i[8]} {i[9]}x{i[10]} "
                  f"blocks/SM={i[11]} grid={i[12]} lmem={i[13]}]", flush=True)
        if name == "committed":
            for b, n, c, h in chip_smoke.CROSS_RAGGED:
                err = rel_err(fwd, inputs(b, n, c, h, n + c))
                print(f"  ragged B={b} N={n} C={c} H={h}: rel={err:.3e}", flush=True)


if __name__ == "__main__":
    main()
