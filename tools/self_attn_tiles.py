"""Tile variants of the fused self-attention B11 on the card, B11 alone.

    python3 tools/self_attn_tiles.py [variant ...]      # from the repo root

Builds each variant of adaprompt_tpu_torch/csrc/fused_self_attention.cu
(the source with one or two tile lines replaced; all variants by default)
into adaprompt_tpu_torch/csrc/build/tiles/, one nvcc each, in parallel;
then, at B11's four timed shapes (C=320 N=4096 and C=640 N=1024, B=4, 8
heads, with and without a key bias), holds each against the plain version
(attention.fused_self_attention_reference) and prints the relative error,
the C call's time (CUDA events, 20 calls), each kernel's device time
(torch.profiler, 20 calls) and each kernel's resources (fused_self_describe).
For the committed tiles it also times, in the same run, the K|V product, B1's
forward at the same shape, the chain the UNet runs instead (three linears,
B1, the out-projection) and the library call (chip_smoke.mha_library), and
checks chip_smoke.SELF_RAGGED and the card-only tests' head dims, and that two
calls give equal bits. Needs a CUDA card.
"""

import ctypes
import os
import shutil
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke  # noqa: E402
from adaprompt_tpu_torch.ops import attention as A, cuda_build  # noqa: E402

SRC = cuda_build.CSRC / "fused_self_attention.cu"
MT = "  static constexpr int MT = HDP <= 80 ? 2 : 1;           // m16 row tiles a warp"
GEMM = "  using Gemm = BlockGemm<64 * MT, QC, 64, 4, 1, HDP <= 48 ? 3 : 2>;"
NSTAGE = "  static constexpr int NSTAGE = HDP <= 64 ? 3 : 2;       // K/V stages in the ring"
GRID_DEV = "  const int hc = blockIdx.x, n0 = blockIdx.y * G::BM, b = blockIdx.z;"
GRID_HOST = "  const dim3 grid(a.H * Cfg::NCH, (a.N + Cfg::Gemm::BM - 1) / Cfg::Gemm::BM, a.B);"
VARIANTS = {   # name -> [(line of the committed source, its replacement)]
    "committed": [],
    # 64-row tiles (one m16 tile a warp) at every head dim
    "bm64": [(MT, "  static constexpr int MT = 1;")],
    # two or three K/V stages at every head dim
    "kv2": [(NSTAGE, "  static constexpr int NSTAGE = 2;")],
    "kv3": [(NSTAGE, "  static constexpr int NSTAGE = 3;")],
    # the prologue's ring two deep at every head dim
    "gemm2": [(GEMM, "  using Gemm = BlockGemm<64 * MT, QC, 64, 4, 1, 2>;")],
    # grid (row tile, head, batch row): a head's row tiles are neighbours, as B1's
    "rows_first": [(GRID_DEV, "  const int hc = blockIdx.y, n0 = blockIdx.x * G::BM, "
                              "b = blockIdx.z;"),
                   (GRID_HOST, "  const dim3 grid((a.N + Cfg::Gemm::BM - 1) / Cfg::Gemm::BM, "
                                "a.H * Cfg::NCH, a.B);")],
}
SHAPES = ((4, 4096, 320, False), (4, 4096, 320, True), (4, 1024, 640, False),
          (4, 1024, 640, True))   # B, N, C, key bias
# the card-only tests' head dims and ragged row counts (B, N, C, H, key bias)
RAGGED = chip_smoke.SELF_RAGGED + ((2, 127, 64, 8, True), (1, 50, 320, 8, True),
                                   (2, 129, 1280, 8, False), (1, 300, 320, 2, False),
                                   (2, 129, 336, 2, True), (2, 77, 1280, 4, True),
                                   (1, 200, 400, 1, False), (1, 100, 912, 2, True))

# the mangled names' tags of the q-attention kernel at hd = 40, 80, 160 and
# 480 and of the out kernel, whose ptxas lines build() prints
TAGS = ("ILi48ELi5ELi48E", "ILi80ELi10ELi80E", "ILi160ELi20ELi160E", "ILi480ELi10ELi80E",
        "self_out_kernel")


def build(names):
    """{variant: (fused_self_attention_fwd, fused_self_describe)} of the
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
        fn = None
        for line in out.splitlines():
            if "Function properties for" in line:
                fn = line.split("for", 1)[1].strip()
            elif ("Used" in line or "spill" in line) and fn and any(tag in fn for tag in TAGS):
                print("   ", next(tag for tag in TAGS if tag in fn), line.strip())
        lib = ctypes.CDLL(str(root / name / "k.so"))
        fwd, describe = lib.fused_self_attention_fwd, lib.fused_self_describe
        fwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                                      ctypes.c_void_p]
        describe.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fwd.restype = describe.restype = ctypes.c_int
        fns[name] = (fwd, describe)
    return fns


def inputs(b, n, c, h, biased, seed):
    return chip_smoke.self_inputs(torch.Generator(device="cuda").manual_seed(seed), b, n, c, h,
                                  biased)


def call(fwd, args, kv=None, o=None, out=None):
    x, wq, wk, wv, wo, bo, scale, h, bias = args
    b, n, c = x.shape
    kv = A.packed_kv(x, wk, wv).contiguous() if kv is None else kv
    o = torch.empty_like(x) if o is None else o
    out = torch.empty_like(x) if out is None else out
    cuda_build.check(fwd(x.data_ptr(), wq.data_ptr(), kv.data_ptr(), wo.data_ptr(),
                         bo.data_ptr(), bias.data_ptr() if bias is not None else None,
                         o.data_ptr(), out.data_ptr(), b, n, c, h, scale,
                         torch.cuda.current_stream().cuda_stream), "fused_self_attention_fwd")
    return out


def per_kernel_ms(fn, iters=20):
    """Device time a call of each of our two kernels and of the rest."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ms = {"q": 0.0, "out": 0.0, "other": 0.0}
    for e in prof.key_averages():
        key = ("q" if "self_q_attn_kernel" in e.key else "out" if "self_out_kernel" in e.key
               else "other")
        ms[key] += e.device_time_total / iters / 1e3
    return ms


def rel_err(out, args):
    ref = A.fused_self_attention_reference(*args)
    torch.cuda.synchronize()
    return (out.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()


def yardsticks(args):
    """The committed B11's neighbours in the same run: the K|V product, B1
    at this shape, the unfused chain, the library call; ms each."""
    x, wq, wk, wv, wo, bo, scale, h, bias = args
    b, n, c = x.shape
    hd = c // h
    bf = torch.bfloat16
    q1, k1, v1 = (torch.randn(b, n, h, hd, device="cuda").to(bf) for _ in "qkv")

    def unfused():
        q, k, v = ((x @ m.t()).reshape(b, n, h, hd) for m in (wq, wk, wv))
        o = A.flash_attention_fwd(q, k, v, bias, scale)[0]
        return o.reshape(b, n, c) @ wo.t() + bo.to(bf)

    lib = chip_smoke.mha_library(*args)
    return {"kv": chip_smoke.time_ms(lambda: A.packed_kv(x, wk, wv), 20),
            "b1": chip_smoke.time_ms(lambda: A.flash_attention_fwd(q1, k1, v1, bias, scale), 20),
            "unfused": chip_smoke.time_ms(unfused, 20),
            "library": chip_smoke.time_ms(lib, 20),
            "library_rel": rel_err(lib(), args),
            "wrapper": chip_smoke.time_ms(lambda: A.fused_self_attention(*args), 20)}


def main():
    names = sys.argv[1:] or list(VARIANTS)
    print(chip_smoke.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, (fwd, describe) in build(names).items():
        for b, n, c, biased in SHAPES:
            args = inputs(b, n, c, 8, biased, n + c + b)
            kv = A.packed_kv(args[0], args[2], args[3]).contiguous()
            o, out = torch.empty_like(args[0]), torch.empty_like(args[0])
            err = rel_err(call(fwd, args, kv, o, out), args)
            ms = chip_smoke.time_ms(lambda: call(fwd, args, kv, o, out), 20)
            pk = per_kernel_ms(lambda: call(fwd, args, kv, o, out))
            i = (ctypes.c_int * 14)()
            cuda_build.check(describe(b, n, c, 8, ctypes.addressof(i)), "fused_self_describe")
            print(f"{name} C={c} N={n} B={b} bias={biased}: rel={err:.3e} call_ms={ms:.4f} "
                  f"q_ms={pk['q']:.4f} out_ms={pk['out']:.4f} "
                  f"q[regs={i[0]} smem={i[1]} {i[2]}x{i[3]} blocks/SM={i[4]} grid={i[5]} "
                  f"lmem={i[6]}] out[regs={i[7]} smem={i[8]} {i[9]}x{i[10]} "
                  f"blocks/SM={i[11]} grid={i[12]} lmem={i[13]}]", flush=True)
            if name == "committed":
                y = yardsticks(args)
                same = torch.equal(call(fwd, args, kv), call(fwd, args, kv))
                print(f"  same run: wrapper_ms={y['wrapper']:.4f} kv_ms={y['kv']:.4f} "
                      f"b1_ms={y['b1']:.4f} unfused_ms={y['unfused']:.4f} "
                      f"library_ms={y['library']:.4f} (vs plain {y['library_rel']:.2e}*max); "
                      f"C call / (B1 + out) = {ms / (y['b1'] + pk['out']):.3f}, "
                      f"C call / (kv + B1 + out) = {ms / (y['kv'] + y['b1'] + pk['out']):.3f}, "
                      f"wrapper / unfused = {y['wrapper'] / y['unfused']:.3f}, "
                      f"wrapper / library = {y['wrapper'] / y['library']:.3f}; "
                      f"two calls equal bits {same}", flush=True)
        if name == "committed":
            for b, n, c, h, biased in RAGGED:
                args = inputs(b, n, c, h, biased, n + c)
                err = rel_err(call(fwd, args), args)
                print(f"  ragged B={b} N={n} C={c} H={h} hd={c // h} bias={biased}: "
                      f"rel={err:.3e}", flush=True)


if __name__ == "__main__":
    main()
