"""Variants of the plain 3x3 convs B8 (halo) and B9 (gathered im2col) on the
card, the two kernels alone.

    python3 tools/conv_tiles.py [variant ...]      # from the repo root

Builds each variant of adaprompt_tpu_torch/csrc/conv_halo.cu (the source
with one or two lines replaced; all variants by default) into
adaprompt_tpu_torch/csrc/build/tiles_conv/, one nvcc each, in parallel,
and, as the variant "parent", the source of the parent commit where
_parent_tree/ holds it (`git archive <parent> | tar -x -C _parent_tree`,
done before a chip call: the card's machine has no git). Then, at
chip_smoke.py phase 2's four shapes, holds each kernel against its plain
version and prints the relative error, the C call's time (CUDA events, 20
calls) at 1, 2 and 4 k splits, the planned split's device time
(torch.profiler: the main kernel and the splits' sum), F.conv2d's time and
the kernels' resources (conv_halo_describe). The committed source also runs
tests/test_torch_port_rules.py's RAGGED shapes through the wrappers at
every count of splits and checks that two calls give equal bits. Needs a
CUDA card.
"""

import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke  # noqa: E402
from adaprompt_tpu_torch.ops import conv_halo as CH, cuda_build  # noqa: E402
from adaprompt_tpu_torch.ops.layers import conv2d  # noqa: E402

SRC = cuda_build.CSRC / "conv_halo.cu"
PARENT = Path("_parent_tree/adaprompt_tpu_torch/csrc/conv_halo.cu")
VARIANTS = {   # name -> [(line of the committed source, its replacement)]
    "committed": [],
    # one block an SM: no 128-register cap
    "minb1": [("constexpr int MIN_BLOCKS = 2;", "constexpr int MIN_BLOCKS = 1;")],
    # a 3-deep ring
    "st3": [("constexpr int STAGES = 4;", "constexpr int STAGES = 3;")],
    # k tiles of 64 channels, a 3-deep ring, one block an SM
    "bk64": [("constexpr int BK = 32;", "constexpr int BK = 64;"),
             ("constexpr int STAGES = 4;", "constexpr int STAGES = 3;"),
             ("constexpr int MIN_BLOCKS = 2;", "constexpr int MIN_BLOCKS = 1;")],
}
SHAPES = chip_smoke.CONV_SHAPES
KERNELS = chip_smoke.CONV_KERNELS
DEVICE_KERNELS = ("conv3x3_halo_mma", "conv3x3_halo_sum", "conv3x3_im2col_mma",
                  "conv3x3_im2col_sum")


def split_counts(c):
    """The k split counts the kernels take at C channels: 1 to 4, at most
    one a chunk of 32."""
    return [s for s in (1, 2, 3, 4) if s <= -(-c // 32)]


def build(names):
    """{variant: ctypes library} of the variants that built; prints ptxas's
    register and spill lines."""
    root = cuda_build.BUILD_DIR / "tiles_conv"
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for name in names:
        if name == "parent":
            if PARENT.is_file():
                text = PARENT.read_text()
            else:
                res = subprocess.run(["git", "show", "HEAD:adaprompt_tpu_torch/csrc/conv_halo.cu"],
                                     capture_output=True, text=True)
                if res.returncode != 0:
                    print(f"build parent: no {PARENT} and no git; skipped", flush=True)
                    continue
                text = res.stdout
        else:
            text = SRC.read_text()
            for old, new in VARIANTS[name]:
                if old not in text:
                    raise SystemExit(f"{name}: the source has no line {old!r}")
                text = text.replace(old, new)
        d = root / name
        d.mkdir(parents=True)
        (d / "k.cu").write_text(text)
        for h in cuda_build.CSRC.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        cmd = [cuda_build.nvcc(), *cuda_build.FLAGS, "-o", str(d / "k.so"), str(d / "k.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        print(f"build {name}: rc={proc.returncode}", flush=True)
        if proc.returncode != 0:
            print(out[-4000:])
            continue
        for line in out.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print("   ", line.strip())
        lib = ctypes.CDLL(str(root / name / "k.so"))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.conv3x3_halo_fwd.argtypes = [P] * 5 + [I] * 6 + [P]
        lib.conv3x3_im2col_fwd.argtypes = [P] * 5 + [I] * 6 + [P]
        lib.conv_halo_describe.argtypes = [I] * 7 + [P]
        lib.conv_halo_describe.restype = I
        lib.conv3x3_halo_fwd.restype = lib.conv3x3_im2col_fwd.restype = I
        libs[name] = lib
    return libs


def call(lib, form, args, splits):
    """The C call of one form with `splits` k splits on allocated operands
    (part: the splits' fp32 workspace)."""
    x, packed, bias, out, part = args
    b, h, w, c = x.shape
    o = out.shape[-1]
    ptrs = [t.data_ptr() for t in (x, packed, bias, out, part)]
    stream = torch.cuda.current_stream().cuda_stream
    fn = getattr(lib, f"conv3x3_{form}_fwd")

    def run():
        cuda_build.check(fn(*ptrs, b, h, w, c, o, splits, stream), f"conv3x3_{form}_fwd")
        return out
    return run


def device_ms(run, iters=20):
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if any(k in e.key for k in DEVICE_KERNELS)) / iters / 1e3


def rel(out, ref):
    torch.cuda.synchronize()
    return (out.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()


def describe(lib, shape, halo_splits, im2col_splits):
    b, h, w, c, o = shape
    info = (ctypes.c_int * 14)()
    cuda_build.check(lib.conv_halo_describe(b, h, w, c, o, halo_splits, im2col_splits,
                                            ctypes.addressof(info)), "conv_halo_describe")
    return [info[:7], info[7:]]


def ragged():
    """RAGGED of the card tests through the wrappers at every count of k
    splits (conv_plan forced), and two calls' bits."""
    import dataclasses
    sys.path.insert(0, str(Path.cwd() / "tests"))
    from test_torch_port_rules import RAGGED, _card_case
    plan = CH.conv_plan
    ok = True
    try:
        for b, h, w, c, o in RAGGED:
            x, wt, bias, _, _ = _card_case(h + w + c + o, b, h, w, c, o, 0.0)
            for form in ("halo", "im2col"):
                wrapper = getattr(CH, f"conv3x3_{form}")
                ref = getattr(CH, f"conv3x3_{form}_reference")(x, wt, bias)
                for splits in split_counts(c):
                    CH.conv_plan = lambda *a, n=splits: dataclasses.replace(plan(*a), splits=n)
                    out = wrapper(x, wt, bias)
                    err = rel(out, ref)
                    same = torch.equal(wrapper(x, wt, bias), out)
                    good = err <= chip_smoke.CONV_TOL and same
                    ok &= good
                    print(f"  ragged {form} B={b} H={h} W={w} C={c} O={o} splits={splits}: "
                          f"rel={err:.3e} equal bits {same} {'OK' if good else 'FAIL'}", flush=True)
    finally:
        CH.conv_plan = plan
    return ok


def main():
    names = sys.argv[1:] or list(VARIANTS) + ["parent"]
    print(chip_smoke.card_line(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    libs = build(names)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for shape in SHAPES:
        b, h, w, c, o = shape
        x, weight, bias, _, _ = chip_smoke._conv_inputs(gen, *shape)
        packed = CH.pack_conv_weight(weight)
        ref = CH.conv3x3_halo_reference(x, weight, bias)
        lib_ms = chip_smoke.time_ms(lambda: conv2d(x, weight, bias.to(torch.bfloat16)), 20)
        flops = 18 * b * h * w * c * o
        print(f"shape B={b} H={h} W={w} C={c} O={o}: F.conv2d {lib_ms:.4f} ms "
              f"({flops / lib_ms / 1e9:.0f} TFLOP/s)", flush=True)
        plans = {f: CH.conv_plan(f, b, h, w, c, o) for f in ("halo", "im2col")}
        part = torch.empty((4, b * h * w, o), device="cuda", dtype=torch.float32)
        for name, lib in libs.items():
            res = describe(lib, shape, plans["halo"].splits, plans["im2col"].splits)
            for k, r in zip(KERNELS, res):
                print(f"  {name} {k}: regs={r[0]} smem={r[1]} tile={r[2]}x{r[3]} "
                      f"blocks/SM={r[4]} grid={r[5]} lmem={r[6]}", flush=True)
            for form in ("halo", "im2col"):
                out = torch.empty((b, h, w, o), device="cuda", dtype=torch.bfloat16)
                args = (x, packed, bias.float().contiguous(), out, part)
                planned = plans[form].splits
                for splits in sorted({1, 2, 4, planned} & set(split_counts(c))):
                    run = call(lib, form, args, splits)
                    err = rel(run(), ref)
                    ok &= err <= chip_smoke.CONV_TOL
                    ms = chip_smoke.time_ms(run, 20)
                    tag = f"splits={splits}"
                    dev = f" device_ms={device_ms(run):.4f} planned" if splits == planned else ""
                    print(f"{name} {form} {tag} B={b} H={h} W={w} C={c} O={o}: rel={err:.3e} "
                          f"ms={ms:.4f} ({flops / ms / 1e9:.0f} TFLOP/s, {ms / lib_ms:.2f}x "
                          f"F.conv2d){dev}", flush=True)
    if "committed" in libs:
        ok &= ragged()
    print("conv_tiles: all OK" if ok else "conv_tiles: FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
