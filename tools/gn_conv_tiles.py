"""Variants of the fused GroupNorm-SiLU-conv B7 on the card, beside the parent
commit's B7, the plain halo conv B8 and the unfused pair.

    python3 tools/gn_conv_tiles.py [variant ...]      # from the repo root

Builds each variant of adaprompt_tpu_torch/csrc/conv_halo.cu (the source
with a few lines replaced; all variants by default) into
adaprompt_tpu_torch/csrc/build/tiles_gn_conv/, one nvcc each, in parallel,
and, as the variant "parent", the source of the parent commit where
_parent_tree/ holds it (`git archive <parent> | tar -x -C _parent_tree`,
done before a chip call: the card's machine has no git); the parent's B7
takes an affine made beforehand, so its row adds `gn_affine`'s eager
statistics. Then, at the 14 ResBlock conv shapes of the SD-1.5 UNet at B=4
(chip_smoke.SD15_RESBLOCK_SHAPES), holds each B7 against its plain version
(relative error) and prints, CUDA events over 20 calls: each variant's C
call (statistics, conv, splits' sum), its statistics kernel alone (device
time, queued behind a spin) and B8's C call from the same library, the
unfused pair `group_norm(..., "silu")` + `conv2d`, and the bound. The
committed source also runs through the wrapper at every split count on the
card tests' ragged shapes and checks two calls' bits. Needs a CUDA card.
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
from adaprompt_tpu_torch.ops.layers import conv2d, group_norm  # noqa: E402

SRC = cuda_build.CSRC / "conv_halo.cu"
PARENT = Path("_parent_tree/adaprompt_tpu_torch/csrc/conv_halo.cu")
PASS_LINE = "constexpr int PASS_TAP = 8;"
SILU_LINE = ("      e[k] = pack_bf16(__fdividef(lo, 1.f + __expf(-lo)), "
             "__fdividef(hi, 1.f + __expf(-hi)));")
AB_LOADS = """    float a[8], s[8];
    *reinterpret_cast<float4*>(a) = *reinterpret_cast<const float4*>(ab + c);
    *reinterpret_cast<float4*>(a + 4) = *reinterpret_cast<const float4*>(ab + c + 4);
    *reinterpret_cast<float4*>(s) = *reinterpret_cast<const float4*>(ab + C + c);
    *reinterpret_cast<float4*>(s + 4) = *reinterpret_cast<const float4*>(ab + C + c + 4);
"""
PASS_LOOP = "  for (int p = tid / UNITS; p < HALO_PX; p += STEP) {\n"
AFFINE_LINES = """      const float lo = __uint_as_float(e[k] << 16) * a[2 * k] + s[2 * k];
      const float hi = __uint_as_float(e[k] & 0xffff0000u) * a[2 * k + 1] + s[2 * k + 1];
"""
AFFINE_PAIR = """      const float2 a2 = *reinterpret_cast<const float2*>(ab + c + 2 * k);
      const float2 s2 = *reinterpret_cast<const float2*>(ab + C + c + 2 * k);
      const float lo = __uint_as_float(e[k] << 16) * a2.x + s2.x;
      const float hi = __uint_as_float(e[k] & 0xffff0000u) * a2.y + s2.y;
"""
FIRST_PASS = """  if constexpr (FUSED) {
    cp_async_wait<STAGES - 2>();       // the first chunk's halo (commit group 0) has landed
    __syncthreads();
    gn_silu_pass(Xs, ab, ch.c_lo * BK, C, y0, x0, H, W, tid);
  }
"""
AHEAD_PASS = """      // chunk j + 1's halo, landed; read first after step 9(j + 1)'s barrier
      if (tap == PASS_TAP && j + 1 < ch.nc)
        gn_silu_pass(Xs + (j + 1) % 2 * X_ELEMS, ab, (ch.c_lo + j + 1) * BK, C, y0, x0, H, W,
                     tid);
"""
OWN_PASS = """      // this chunk's halo, before its taps, behind one more barrier
      if (tap == 0) {
        gn_silu_pass(Xs + j % 2 * X_ELEMS, ab, (ch.c_lo + j) * BK, C, y0, x0, H, W, tid);
        __syncthreads();
      }
"""
WALK_UNROLL = "#pragma unroll 4\n  for (int p = t / U; p < n; p += R) {"
VARIANTS = {   # name -> [(text of the committed source, its replacement)]
    "committed": [],
    # the producer pass at its chunk's own tap 0, behind one more barrier
    "own": [(FIRST_PASS, ""), (AHEAD_PASS, OWN_PASS)],
    # the pass during the previous chunk's earliest tap after its halo landed
    "tap3": [(PASS_LINE, "constexpr int PASS_TAP = 3;")],
    # IEEE expf and division in the SiLU
    "expf": [(SILU_LINE, "      e[k] = pack_bf16(lo / (1.f + expf(-lo)), hi / (1.f + expf(-hi)));")],
    # __expf times a round-to-nearest reciprocal
    "rcp": [(SILU_LINE, "      e[k] = pack_bf16(lo * __frcp_rn(1.f + __expf(-lo)), "
                        "hi * __frcp_rn(1.f + __expf(-hi)));")],
    # the unit's affine loaded once a chunk, held across the pixel loop
    "abchunk": [(AB_LOADS, ""), (PASS_LOOP, AB_LOADS.replace("\n    ", "\n  ")[2:] + PASS_LOOP)],
    # each pair's affine loaded where it is used (from L1)
    "abpair": [(AB_LOADS, ""), (AFFINE_LINES, AFFINE_PAIR)],
    # the statistics: 512 threads a block; 8 or 16 pieces a thread in flight
    "stats512": [("constexpr int STATS_THREADS = 1024;", "constexpr int STATS_THREADS = 512;")],
    "unroll8": [(WALK_UNROLL, WALK_UNROLL.replace("unroll 4", "unroll 8"))],
    "unroll16": [(WALK_UNROLL, WALK_UNROLL.replace("unroll 4", "unroll 16"))],
}
P, I, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
B = 4


def build(names):
    """{variant: ctypes library} of the variants that built; prints ptxas's
    register and spill lines."""
    root = cuda_build.BUILD_DIR / "tiles_gn_conv"
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for name in names:
        if name == "parent":
            if not PARENT.is_file():
                print(f"build parent: no {PARENT}; skipped", flush=True)
                continue
            text = PARENT.read_text()
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
        lib.conv3x3_halo_fwd.argtypes = [P] * 5 + [I] * 6 + [P]
        if name == "parent":
            lib.gn_silu_conv3x3_halo_fwd.argtypes = [P] * 5 + [I] * 5 + [P]
        else:
            lib.gn_silu_conv3x3_halo_fwd.argtypes = [P] * 7 + [I] * 6 + [F32, I, P]
            lib.gn_silu_conv_stats.argtypes = [P] * 4 + [I] * 5 + [F32, P]
            lib.gn_silu_conv_describe.argtypes = [I] * 7 + [P]
            lib.gn_silu_conv_workspace.argtypes = [I] * 7 + [P]
        libs[name] = lib
    return libs


def check(err, what):
    cuda_build.check(err, what)


def rel(out, ref):
    torch.cuda.synchronize()
    return (out.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()


def ragged():
    """The card tests' B7 cases through the wrapper (the committed build) at
    every count of k splits, gn_shift 0 and 3, and two calls' bits."""
    import dataclasses
    sys.path.insert(0, str(Path.cwd() / "tests"))
    from test_torch_port_rules import GN_RAGGED, _card_case
    plan = CH.conv_plan
    ok = True
    try:
        for b, h, w, c, o in GN_RAGGED:
            for shift in (0.0, 3.0):
                x, wt, bias, gs, gb = _card_case(h + w + c + o, b, h, w, c, o, shift)
                ref = CH.gn_silu_conv3x3_halo_reference(x, gs, gb, wt, bias)
                for splits in [s for s in (1, 2, 3, 4) if s <= -(-c // 32)]:
                    CH.conv_plan = lambda *a, n=splits: dataclasses.replace(plan(*a), splits=n)
                    out = CH.gn_silu_conv3x3_halo(x, gs, gb, wt, bias)
                    err = rel(out, ref)
                    same = torch.equal(CH.gn_silu_conv3x3_halo(x, gs, gb, wt, bias), out)
                    good = err <= chip_smoke.CONV_TOL and same
                    ok &= good
                    print(f"  ragged B={b} H={h} W={w} C={c} O={o} shift={shift:g} "
                          f"splits={splits}: rel={err:.3e} equal bits {same} "
                          f"{'OK' if good else 'FAIL'}", flush=True)
    finally:
        CH.conv_plan = plan
    return ok


def main():
    names = sys.argv[1:] or list(VARIANTS) + ["parent"]
    print(chip_smoke.card_line(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    libs = build(names)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    ok = True
    for h, c, o in chip_smoke.SD15_RESBLOCK_SHAPES:
        x, weight, bias, gs, gb = chip_smoke._conv_inputs(gen, B, h, h, c, o)
        packed = CH.pack_conv_weight(weight)
        ref = CH.gn_silu_conv3x3_halo_reference(x, gs, gb, weight, bias)
        gs16, gb16, bias16 = (t.to(torch.bfloat16) for t in (gs, gb, bias))
        unfused_ms = chip_smoke.time_ms(
            lambda: conv2d(group_norm(x, gs16, gb16, eps=1e-5, activation="silu"), weight,
                           bias16), 20)
        flops = 18 * B * h * h * c * o
        bound = chip_smoke._conv_bound(B, h, h, c, o, extra_bytes=8 * c)
        splits = CH.conv_plan("halo", B, h, h, c, o).splits
        print(f"shape B={B} H={h} C={c} O={o}: {splits} split(s), unfused {unfused_ms:.4f} ms, "
              f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})", flush=True)
        out = torch.empty((B, h, h, o), device="cuda", dtype=torch.bfloat16)
        part = torch.empty((splits, B * h * h, o), device="cuda", dtype=torch.float32)
        for name, lib in libs.items():
            if name == "parent":
                ab = CH.gn_affine(x, gs, gb)

                def run():
                    check(lib.gn_silu_conv3x3_halo_fwd(
                        x.data_ptr(), ab.data_ptr(), packed.data_ptr(), bias.data_ptr(),
                        out.data_ptr(), B, h, h, c, o, stream), "parent gn_silu_conv3x3_halo_fwd")
                    return out

                err = rel(run(), ref)
                ms = chip_smoke.time_ms(run, 20)
                affine_ms = chip_smoke.time_ms(lambda: CH.gn_affine(x, gs, gb), 20)
                print(f"parent B={B} H={h} C={c} O={o}: rel={err:.3e} ms={ms:.4f} "
                      f"(+ gn_affine {affine_ms:.4f} = {ms + affine_ms:.4f}; "
                      f"{(ms + affine_ms) / unfused_ms:.2f}x unfused)", flush=True)
                ok &= err <= chip_smoke.CONV_TOL
                continue
            nbytes = ctypes.c_longlong()
            check(lib.gn_silu_conv_workspace(B, h, h, c, o, 32, splits,
                                             ctypes.addressof(nbytes)), "workspace")
            work = torch.empty(nbytes.value, dtype=torch.uint8, device="cuda")

            def run():
                check(lib.gn_silu_conv3x3_halo_fwd(
                    x.data_ptr(), gs.data_ptr(), gb.data_ptr(), packed.data_ptr(),
                    bias.data_ptr(), out.data_ptr(), work.data_ptr(), B, h, h, c, o, 32, 1e-5,
                    splits, stream), "gn_silu_conv3x3_halo_fwd")
                return out

            def stats():
                check(lib.gn_silu_conv_stats(x.data_ptr(), gs.data_ptr(), gb.data_ptr(),
                                             work.data_ptr(), B, h, h, c, 32, 1e-5, stream),
                      "gn_silu_conv_stats")

            def halo():
                check(lib.conv3x3_halo_fwd(x.data_ptr(), packed.data_ptr(), bias.data_ptr(),
                                           out.data_ptr(), part.data_ptr(), B, h, h, c, o,
                                           splits, stream), "conv3x3_halo_fwd")

            err = rel(run(), ref)
            ok &= err <= chip_smoke.CONV_TOL
            first = out.clone()
            same = torch.equal(run(), first)
            ok &= same
            ms = chip_smoke.time_ms(run, 20)
            stats_ms = chip_smoke.device_ms(stats, 20)
            halo_ms = chip_smoke.time_ms(halo, 20)
            info = (ctypes.c_int * 14)()
            check(lib.gn_silu_conv_describe(B, h, h, c, o, 32, splits, ctypes.addressof(info)),
                  "gn_silu_conv_describe")
            print(f"{name} B={B} H={h} C={c} O={o}: rel={err:.3e} bits={same} ms={ms:.4f} "
                  f"({flops / ms / 1e9:.0f} TFLOP/s, {ms / unfused_ms:.2f}x unfused) "
                  f"stats_ms={stats_ms:.4f} halo_ms={halo_ms:.4f} "
                  f"({ms / (halo_ms + stats_ms):.2f}x B8 + stats) regs={info[0]} "
                  f"smem={info[1]} blocks/SM={info[4]} grid={info[5]} lmem={info[6]}; "
                  f"stats regs={info[7]} blocks/SM={info[11]} grid={info[12]}", flush=True)
    if "committed" in libs:
        ok &= ragged()
    print("gn_conv_tiles: all OK" if ok else "gn_conv_tiles: FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
