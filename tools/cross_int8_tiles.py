"""Variants of the int8 fused cross-attention B5 on the card, B5 alone.

    python3 tools/cross_int8_tiles.py [variant ...]      # from the repo root

Builds each variant of adaprompt_tpu_torch/csrc/fused_cross_attention_int8.cu
(the source with one to three lines replaced; all variants by default) into
adaprompt_tpu_torch/csrc/build/tiles_cross_int8/, one nvcc each, in
parallel; then, at B5's four serving shapes (C=320 N=4096 and C=640 N=1024
at B=4 and 2, 8 heads, 77 keys), holds each against the plain version
(attention.fused_cross_attention_int8_reference) and prints the relative
error, the C call's time (CUDA events, 20 calls), each of its four kernels'
device time (torch.profiler, 20 calls) and their resources
(fused_cross_int8_describe). The committed source also runs
chip_smoke.CROSS_RAGGED and the max|o|-in-the-last-head cases. Needs a CUDA
card.
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
from adaprompt_tpu_torch.ops.quant import quantize_weight  # noqa: E402

SRC = cuda_build.CSRC / "fused_cross_attention_int8.cu"
Q_MT = "  static constexpr int MT = HDP <= 80 ? 2 : 1;"
Q_GEMM = "  using Gemm = BlockGemmS8<64 * MT, HDP, 128, 4, 1, HDP <= 48 ? 3 : 2>;"
Q_MIN = "  static constexpr int MIN_BLOCKS = 2;"
OUT = "struct Out : BlockGemmS8<128, 160, 128, 4, 2, 4> {      // tiles of out"
VARIANTS = {   # name -> [(line of the committed source, its replacement)]
    "committed": [],
    # the softmax's exponential as exp2f of scores scaled by scale*log2(e), as the bf16 kernel
    "exp2": [("          s[mt][j][e] = expf(s[mt][j][e] - m);",
              "          s[mt][j][e] = exp2f(s[mt][j][e] - m);"),
             ("                S, scale, s, nullptr};", "                S, scale * kLog2e, s, nullptr};")],
    # the row passes a warp a row, as B6's, or 16 lanes a row at C=320
    "rows_warp": [("constexpr int MIN_ROW_LANES = 8;", "constexpr int MIN_ROW_LANES = 32;")],
    "rows_16": [("constexpr int MIN_ROW_LANES = 8;", "constexpr int MIN_ROW_LANES = 16;")],
    # the q-attention kernel: 64-row tiles (one m16 tile a warp) at three
    # blocks an SM, or three ring stages at every head dim
    "q_bm64": [(Q_MT, "  static constexpr int MT = 1;"),
               (Q_GEMM, "  using Gemm = BlockGemmS8<64 * MT, HDP, 128, 4, 1, 3>;"),
               (Q_MIN, "  static constexpr int MIN_BLOCKS = 3;")],
    "q_st3": [(Q_GEMM, "  using Gemm = BlockGemmS8<64 * MT, HDP, 128, 4, 1, 3>;")],
    # each kernel launched after its predecessor has ended
    "serial_launches": [("attr.val.programmaticStreamSerializationAllowed = 1;",
                         "attr.val.programmaticStreamSerializationAllowed = 0;")],
    # the out kernel: three ring stages, 128-row tiles at every shape, or 64-row ones
    "out_st3": [(OUT, "struct Out : BlockGemmS8<128, 160, 128, 4, 2, 3> {")],
    "out_128_only": [("  return 2 * (int)(grid.x * grid.y) <= card().sms;", "  return false;")],
    "out_64_only": [(OUT, "struct Out : BlockGemmS8<64, 160, 128, 4, 2, 3> {"),
                    ("  static constexpr int MIN_BLOCKS = 1;",
                     "  static constexpr int MIN_BLOCKS = 2;")],
}
SHAPES = ((4, 4096, 320), (4, 1024, 640), (2, 4096, 320), (2, 1024, 640))   # B, N, C
KERNELS = chip_smoke.CROSS_INT8_KERNELS


def build(names):
    """{variant: (workspace, fwd, describe)} of the variants that built;
    prints ptxas's register and spill lines. A replaced line may lie in the
    source or in a header it includes (launch_after is int8_rows.cuh's)."""
    root = cuda_build.BUILD_DIR / "tiles_cross_int8"
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for name in names:
        d = root / name
        d.mkdir(parents=True)
        files = {"k.cu": SRC.read_text()}
        files.update({h.name: h.read_text() for h in cuda_build.CSRC.glob("*.cuh")})
        for old, new in VARIANTS[name]:
            hits = [f for f, text in files.items() if old in text]
            if not hits:
                raise SystemExit(f"{name}: no source has the line {old!r}")
            files[hits[0]] = files[hits[0]].replace(old, new)
        for f, text in files.items():
            (d / f).write_text(text)
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
        ws, fwd = lib.fused_cross_int8_workspace, lib.fused_cross_attention_int8_fwd
        describe = lib.fused_cross_int8_describe
        ws.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                        + [ctypes.c_float, ctypes.c_void_p])
        describe.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        ws.restype = fwd.restype = describe.restype = ctypes.c_int
        fns[name] = (ws, fwd, describe)
    return fns


def inputs(b, n, c, h, seed, peak_last=False):
    """B5's operands as the serving stack gives them (chip_smoke's
    _case_cross_int8); with peak_last V of the last head is 30x larger."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    bf = torch.bfloat16
    x = torch.randn(b, n, c, device="cuda", generator=g).to(bf)
    w = lambda: ((torch.rand(c, c, device="cuda", generator=g) * 2 - 1) / math.sqrt(c)).to(bf)
    wq, wo = w(), w()
    k = torch.randn(b, 77, h, c // h, device="cuda", generator=g).to(bf)
    v = torch.randn(b, 77, h, c // h, device="cuda", generator=g).to(bf)
    if peak_last:
        v[:, :, -1] *= 30
    bo = (torch.rand(c, device="cuda", generator=g) * 2 - 1) / math.sqrt(c)
    return (x, *quantize_weight(wq), k, v, *quantize_weight(wo), bo, (c // h) ** -0.5, h)


def call(fns, args):
    ws, fwd, _ = fns
    x, wq_q, wq_s, k, v, wo_q, wo_s, bo, scale, h = args
    b, n, c = x.shape
    nbytes = ctypes.c_longlong()
    cuda_build.check(ws(b, n, c, h, ctypes.addressof(nbytes)), "fused_cross_int8_workspace")
    work = torch.empty(nbytes.value, dtype=torch.uint8, device="cuda")
    out = torch.empty_like(x)
    cuda_build.check(fwd(x.data_ptr(), wq_q.data_ptr(), wq_s.data_ptr(), k.data_ptr(),
                         v.data_ptr(), wo_q.data_ptr(), wo_s.data_ptr(), bo.data_ptr(),
                         out.data_ptr(), work.data_ptr(), b, n, c, h, k.shape[1], scale,
                         torch.cuda.current_stream().cuda_stream),
                     "fused_cross_attention_int8_fwd")
    return out


def per_kernel_ms(fns, args, iters=20):
    from torch.profiler import ProfilerActivity, profile
    call(fns, args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call(fns, args)
        torch.cuda.synchronize()
    ms = dict.fromkeys(KERNELS, 0.0)
    for e in prof.key_averages():
        for k in KERNELS:
            if k in e.key:
                ms[k] += e.device_time_total / iters / 1e3
    return ms


def rel_err(fns, args):
    out = call(fns, args)
    ref = A.fused_cross_attention_int8_reference(*args)
    torch.cuda.synchronize()
    return (out.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()


def main():
    names = sys.argv[1:] or list(VARIANTS)
    print(chip_smoke.card_line(), flush=True)
    for name, fns in build(names).items():
        for b, n, c in SHAPES:
            args = inputs(b, n, c, 8, n + c + b)
            err = rel_err(fns, args)
            ms = chip_smoke.time_ms(lambda: call(fns, args), 20)
            pk = per_kernel_ms(fns, args)
            i = (ctypes.c_int * 28)()
            cuda_build.check(fns[2](b, n, c, 8, ctypes.addressof(i)), "fused_cross_int8_describe")
            print(f"{name} C={c} N={n} B={b}: rel={err:.3e} call_ms={ms:.4f} "
                  + " ".join(f"{k[len('cross_int8_'):-len('_kernel')]}_ms={pk[k]:.4f}"
                             for k in KERNELS), flush=True)
            for k, kernel in enumerate(KERNELS):
                r = i[7 * k:7 * k + 7]
                print(f"    {kernel}: regs={r[0]} smem={r[1]} {r[2]}x{r[3]} blocks/SM={r[4]} "
                      f"grid={r[5]} lmem={r[6]}", flush=True)
        if name == "committed":
            for b, n, c, h in chip_smoke.CROSS_RAGGED:
                err = rel_err(fns, inputs(b, n, c, h, n + c))
                print(f"  ragged B={b} N={n} C={c} H={h}: rel={err:.3e}", flush=True)
            for b, n, c in ((2, 4096, 320), (1, 1000, 640)):
                err = rel_err(fns, inputs(b, n, c, 8, n + c, peak_last=True))
                print(f"  max|o| in the last head B={b} N={n} C={c}: rel={err:.3e}", flush=True)


if __name__ == "__main__":
    main()
