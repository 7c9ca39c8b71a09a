"""Variants of the int8-QK flash attention B10 on the card, B10 alone.

    python3 tools/flash_int8_tiles.py [variant ...]      # from the repo root

Builds each variant of adaprompt_tpu_torch/csrc/flash_attention_int8.cu (the
source with one or two lines replaced; all variants by default) into
adaprompt_tpu_torch/csrc/build/tiles_flash_int8/, one nvcc each, in
parallel; then, at B10's six timed shapes of chip_smoke.py phase 2 (D=40
S=4096, D=40 S=2048, D=80 S=1024 at B=4, 8 heads, without and with key
bias), holds each against the plain version
(attention.flash_attention_int8_reference) and prints the relative error,
the C call's time and its key pass's alone (CUDA events, 20 calls; the key
pass queued behind a spin of the card, chip_smoke.device_ms), each of
its three kernels' device time (torch.profiler, 20 calls), B1's forward at
the same shape, and the kernels' resources (flash_attention_int8_describe).
The committed source also runs the ragged shapes of
tests/test_torch_port_rules.py and checks its operands against
int8_qk_operands (chip_smoke.int8_operands_check). Needs a CUDA card.
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

SRC = cuda_build.CSRC / "flash_attention_int8.cu"
STAGES = "  static constexpr int NSTAGE = DQ <= 64 ? 3 : 2;         // stages of the ring"
MT = "  static constexpr int MT = DQ <= 80 ? 2 : 1;             // m16 row tiles a warp"
KCH = "constexpr int KCH = 256;                  // keys a block of the key sums"
VARIANTS = {   # name -> [(line of the committed source, its replacement)]
    "committed": [],
    # the int32 sums started at the bits of 1.5*2^23 and read as floats less
    # 1.5*2^23 (one FADD) instead of converted by I2F
    "magic": [("constexpr int kAccInit = 0;", "constexpr int kAccInit = 0x4B400000;"),
              ("  return __int2float_rn(acc);",
               "  return __fsub_rn(__int_as_float(acc), 12582912.f);")],
    # the key pass in blocks of 128 threads (key sums over 128-key chunks)
    "keys_128": [(KCH, "constexpr int KCH = 128;"),
                 ("constexpr int KP_THREADS = 256;           // threads a block of the key pass",
                  "constexpr int KP_THREADS = 128;")],
    # two or three ring stages at every head dim
    "st2": [(STAGES, "  static constexpr int NSTAGE = 2;")],
    "st3": [(STAGES, "  static constexpr int NSTAGE = 3;")],
    # 64 query rows a block (one m16 tile a warp) at every head dim
    "mt1": [(MT, "  static constexpr int MT = 1;")],
}
SHAPES = ((4096, 40, False), (4096, 40, True), (2048, 40, False), (2048, 40, True),
          (1024, 80, False), (1024, 80, True))   # S, D, key bias; B=4, H=8
RAGGED = ((1, 300, 203, 3, 64, True), (2, 100, 1000, 2, 128, False), (2, 1, 65, 2, 8, True),
          (1, 129, 63, 4, 24, False), (2, 333, 1, 2, 40, True), (1, 257, 190, 2, 80, True))
KERNELS = chip_smoke.FLASH_INT8_KERNELS


def build(names):
    """{variant: (workspace, fwd, keys, describe)} of the variants that
    built; prints ptxas's register and spill lines."""
    root = cuda_build.BUILD_DIR / "tiles_flash_int8"
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for name in names:
        d = root / name
        d.mkdir(parents=True)
        files = {"k.cu": SRC.read_text()}
        files.update({h.name: h.read_text() for h in cuda_build.CSRC.glob("*.cuh")})
        for old, new in VARIANTS[name]:
            if old not in files["k.cu"]:
                raise SystemExit(f"{name}: the source has no line {old!r}")
            files["k.cu"] = files["k.cu"].replace(old, new)
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
        ws, fwd = lib.flash_attention_int8_workspace, lib.flash_attention_int8_fwd
        keys, describe = lib.flash_attention_int8_keys, lib.flash_attention_int8_describe
        ws.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        keys.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        describe.argtypes = [ctypes.c_int, ctypes.c_void_p]
        ws.restype = fwd.restype = keys.restype = describe.restype = ctypes.c_int
        fns[name] = (ws, fwd, keys, describe)
    return fns


def inputs(b, sq, sk, h, d, biased, seed):
    """B10's operands as chip_smoke's _case_flash_int8 makes them (K off
    centre, ~30% of the keys masked by NEG_BIG)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda n: torch.randn(b, n, h, d, device="cuda", generator=g)
    q, k, v = mk(sq).bfloat16(), (mk(sk) + 0.7).bfloat16(), mk(sk).bfloat16()
    bias = None
    if biased:
        bias = (torch.rand(b, sk, device="cuda", generator=g) < 0.7).float().sub(1.0) * 1e9
    return q, k, v, bias, d ** -0.5


class Call:
    """One variant's C call on allocated operands."""

    def __init__(self, fns, args, keep_q=False):
        self.ws, self.fwd, self.keys, _ = fns
        self.q, self.k, self.v, self.bias, self.scale = args
        b, sq, h, d = self.q.shape
        self.shape = (b, sq, self.k.shape[1], h, d)
        layout = (ctypes.c_longlong * 7)()
        cuda_build.check(self.ws(*self.shape, ctypes.addressof(layout)), "workspace")
        self.work = torch.empty(layout[0], dtype=torch.uint8, device="cuda")
        self.out = torch.empty_like(self.q)
        self.keep_q = int(keep_q)

    def __call__(self):
        b, sq, sk, h, d = self.shape
        stream = torch.cuda.current_stream().cuda_stream
        cuda_build.check(self.fwd(self.q.data_ptr(), self.k.data_ptr(), self.v.data_ptr(),
                                  None if self.bias is None else self.bias.data_ptr(),
                                  self.out.data_ptr(), self.work.data_ptr(), b, sq, sk, h, d,
                                  self.scale, self.keep_q, stream), "flash_attention_int8_fwd")
        return self.out

    def key_pass(self):
        cuda_build.check(self.keys(self.k.data_ptr(), self.work.data_ptr(), *self.shape,
                                   torch.cuda.current_stream().cuda_stream), "keys")


def per_kernel_ms(call, iters=20):
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    ms = dict.fromkeys(KERNELS, 0.0)
    for e in prof.key_averages():
        for k in KERNELS:
            if k in e.key:
                ms[k] += e.device_time_total / iters / 1e3
    return ms


def rel_err(call, args):
    out = call()
    ref = A.flash_attention_int8_reference(*args)
    torch.cuda.synchronize()
    return (out.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()


def main():
    names = sys.argv[1:] or list(VARIANTS)
    print(chip_smoke.card_line(), flush=True)
    for name, fns in build(names).items():
        for d in (40, 80):
            i = (ctypes.c_int * 15)()
            cuda_build.check(fns[3](d, ctypes.addressof(i)), "describe")
            for k, kernel in enumerate(KERNELS):
                r = i[5 * k:5 * k + 5]
                print(f"  {name} D={d} {kernel}: regs={r[0]} smem={r[1]} rows={r[2]} "
                      f"blocks/SM={r[3]} lmem={r[4]}", flush=True)
        for s, d, biased in SHAPES:
            args = inputs(4, s, s, 8, d, biased, s + d + biased)
            call = Call(fns, args)
            err = rel_err(call, args)
            ms = chip_smoke.time_ms(call, 20)
            keys_ms = chip_smoke.device_ms(call.key_pass, 20)
            b1_ms = chip_smoke.time_ms(lambda: A.flash_attention_fwd(*args), 20)
            pk = per_kernel_ms(call)
            print(f"{name} D={d} S={s} B=4 bias={biased}: rel={err:.3e} call_ms={ms:.4f} "
                  f"keys_ms={keys_ms:.4f} b1_ms={b1_ms:.4f} ({ms / b1_ms:.2f}x B1) "
                  + " ".join(f"{k}={pk[k]:.4f}" for k in KERNELS), flush=True)
        if name == "committed":
            for b, sq, sk, h, d, biased in RAGGED:
                args = inputs(b, sq, sk, h, d, biased, sq + sk + d)
                call = Call(fns, args, keep_q=True)
                err = rel_err(call, args)
                ok, detail = chip_smoke.int8_operands_check(*args[:3], call.work)
                print(f"  ragged B={b} Sq={sq} Sk={sk} H={h} D={d} bias={biased}: rel={err:.3e} "
                      f"{detail} {'OK' if ok else 'FAIL'}", flush=True)


if __name__ == "__main__":
    main()
