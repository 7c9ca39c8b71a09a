"""Tile variants of the int8 fused GEGLU B6 on the card, B6 alone.

    python3 tools/geglu_int8_tiles.py [variant ...]      # from the repo root

Builds each variant of adaprompt_tpu_torch/csrc/geglu_int8.cu (the source
with one or two tile lines replaced; all variants by default) into
adaprompt_tpu_torch/csrc/build/tiles_int8/, one nvcc each, in parallel;
then, at B6's four serving shapes (C=320 M=8192 and 4096, C=640 M=4096 and
2048), holds each against the plain version (geglu.geglu_int8_reference)
and prints the relative error, the C call's time (CUDA events, 20 calls),
each of its four kernels' device time (torch.profiler, 20 calls) and their
resources (geglu_int8_describe). The committed tiles also run
chip_smoke.GEGLU_INT8_RAGGED and the max|g|-in-the-last-columns cases.
Needs a CUDA card.
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
from adaprompt_tpu_torch.ops import cuda_build, geglu as G  # noqa: E402
from adaprompt_tpu_torch.ops.quant import quantize_weight  # noqa: E402

SRC = cuda_build.CSRC / "geglu_int8.cu"
PROJ = "using Proj = BlockGemmS8<128, 128, 128, 4, 2, 3>;   // tiles of h: 64 g columns"
PROJ_MIN = "constexpr int PROJ_MIN_BLOCKS = 2;"
OUT = "struct Out : BlockGemmS8<128, 160, 128, 4, 2, 4> {      // tiles of out"
VARIANTS = {   # name -> [(line of the committed source, its replacement)]
    "committed": [],
    # the proj kernel: 64 bytes deep in K (no wasted half tile at C=320),
    # or 64-row tiles with a 2-stage ring and three blocks an SM
    "proj_bk64": [(PROJ, "using Proj = BlockGemmS8<128, 128, 64, 4, 2, 4>;")],
    "proj_64x128": [(PROJ, "using Proj = BlockGemmS8<64, 128, 128, 2, 4, 2>;"),
                    (PROJ_MIN, "constexpr int PROJ_MIN_BLOCKS = 3;")],
    # each kernel launched after its predecessor has ended
    "serial_launches": [("attr.val.programmaticStreamSerializationAllowed = 1;",
                         "attr.val.programmaticStreamSerializationAllowed = 0;")],
    # the out kernel: 128-row tiles at every shape, or 64-row ones
    "out_128_only": [("  return 2 * (int)(grid.x * grid.y) <= card().sms;", "  return false;")],
    "out_64_only": [(OUT, "struct Out : BlockGemmS8<64, 160, 128, 4, 2, 3> {"),
                    ("  static constexpr int MIN_BLOCKS = 1;",
                     "  static constexpr int MIN_BLOCKS = 2;")],
}
SHAPES = ((4 * 2048, 320), (2 * 2048, 320), (4 * 1024, 640), (2 * 1024, 640))   # M, C
KERNELS = chip_smoke.GEGLU_INT8_KERNELS


def build(names):
    """{variant: (workspace, fwd, describe)} of the variants that built;
    prints ptxas's register and spill lines."""
    root = cuda_build.BUILD_DIR / "tiles_int8"
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
        ws, fwd, describe = lib.geglu_int8_workspace, lib.geglu_int8_fwd, lib.geglu_int8_describe
        ws.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        describe.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        ws.restype = fwd.restype = describe.restype = ctypes.c_int
        fns[name] = (ws, fwd, describe)
    return fns


def inputs(m, c, seed, peak_last=False):
    g = torch.Generator(device="cuda").manual_seed(seed)
    f = 4 * c
    u = lambda *s, fan: (torch.rand(*s, device="cuda", generator=g) * 2 - 1) / math.sqrt(fan)
    x = torch.randn(m, c, device="cuda", generator=g).to(torch.bfloat16)
    w1 = u(2 * f, c, fan=c).to(torch.bfloat16)
    if peak_last:
        w1[f - 64:f] *= 30
    w2 = u(c, f, fan=f).to(torch.bfloat16)
    return (x, *quantize_weight(w1), u(2 * f, fan=c), *quantize_weight(w2), u(c, fan=f))


def call(fns, args):
    ws, fwd, _ = fns
    x, w1_q, w1_s, b1, w2_q, w2_s, b2 = args
    m, c = x.shape
    nbytes = ctypes.c_longlong()
    cuda_build.check(ws(m, c, c * 4, ctypes.addressof(nbytes)), "geglu_int8_workspace")
    work = torch.empty(nbytes.value, dtype=torch.uint8, device="cuda")
    out = torch.empty_like(x)
    cuda_build.check(fwd(x.data_ptr(), w1_q.data_ptr(), w1_s.data_ptr(), b1.data_ptr(),
                         w2_q.data_ptr(), w2_s.data_ptr(), b2.data_ptr(), out.data_ptr(),
                         work.data_ptr(), m, c, 4 * c, torch.cuda.current_stream().cuda_stream),
                     "geglu_int8_fwd")
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
    ref = G.geglu_int8_reference(*args)
    torch.cuda.synchronize()
    return (out.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()


def main():
    names = sys.argv[1:] or list(VARIANTS)
    print(chip_smoke.card_line(), flush=True)
    for name, fns in build(names).items():
        for m, c in SHAPES:
            args = inputs(m, c, m + c)
            err = rel_err(fns, args)
            ms = chip_smoke.time_ms(lambda: call(fns, args), 20)
            pk = per_kernel_ms(fns, args)
            i = (ctypes.c_int * 28)()
            cuda_build.check(fns[2](m, c, 4 * c, ctypes.addressof(i)), "geglu_int8_describe")
            print(f"{name} C={c} M={m}: rel={err:.3e} call_ms={ms:.4f} "
                  + " ".join(f"{k.split('_', 2)[2][:-7]}_ms={pk[k]:.4f}" for k in KERNELS),
                  flush=True)
            for k, kernel in enumerate(KERNELS):
                r = i[7 * k:7 * k + 7]
                print(f"    {kernel}: regs={r[0]} smem={r[1]} {r[2]}x{r[3]} blocks/SM={r[4]} "
                      f"grid={r[5]} lmem={r[6]}", flush=True)
        if name == "committed":
            for m, c in chip_smoke.GEGLU_INT8_RAGGED:
                print(f"  ragged M={m} C={c}: rel={rel_err(fns, inputs(m, c, m + c)):.3e}",
                      flush=True)
            for m, c in ((2048, 320), (1000, 640)):
                err = rel_err(fns, inputs(m, c, m + c, peak_last=True))
                print(f"  max|g| in the last 64 columns M={m} C={c}: rel={err:.3e}", flush=True)


if __name__ == "__main__":
    main()
