#!/usr/bin/env python3
"""Drive the PyTorch port's four paths on one NVIDIA H100: SD-1.5 txt2img,
Stage-1 Arc2Face-distillation training, the composed serving stack
(DPM-Solver++ 20 steps with ToMe, DeepCache and the CFG tail, quant="int8"),
and the product path (AdaFacePipeline: photos -> ArcFace -> 16 subject
tokens -> personalized DDIM-50, with UNetConfig.fused_conv); the first two
also under each UNetConfig.flash_variant (two-chain, no-max, exp2).

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero without the final line):
  1. build the thirteen CUDA kernels (eleven sources, one nvcc each, in
     parallel) from adaprompt_tpu_torch/csrc/, and log what the exp2 forms
     of the flash kernels changed in the SASS;
  2. log the four flash kernels' resources at D=40 and 80 (registers,
     shared memory, rows a block, blocks an SM; the three forwards and the
     backward's main kernel); hold each kernel against its plain PyTorch
     version on the card, in bf16, at the paths' shapes (the
     kernels that no path runs, the two plain 3x3 convs, the int8-QK flash
     attention and the fused self-attention, at the UNet's shapes or the JAX
     tests' and ragged ones; the flash variants and exp2 forms each against
     its own plain version, plus the no-max kernel's underflow guard; each
     flash forward and the backward in both forms also at Sq != Sk with both
     ragged, head dims 8 to 128, one key tile, a key tile masked whole and a
     row masked whole, the two-chain one also at 9 key tiles; the backward's
     pre-pass delta against its plain version, and the spread of its
     atomically summed dq over two calls), and time
     kernel, plain version and, where one PyTorch call computes the same
     function, that call as the yardstick (F.scaled_dot_product_attention
     for flash attention forward and backward, F.conv2d for the two plain
     convs); beside the fused GroupNorm-SiLU-conv, which no single call
     computes, the port's own unfused pair (group_norm + conv2d); beside the
     no-max wrapper's call, its kernel alone (kmax made beforehand); the
     backward timed as its C call (pre-pass, kernel and dQ epilogue), its
     wrapper's call beside;
  3. run one full-width UNet forward on the card in bf16, one with
     quant="int8", one with fused_conv and one under each flash variant
     (ilv, nomax, exp2), and the same weights on the CPU
     in fp32 (the int8 one through the int8 kernels' plain versions), and
     bound the relative errors; log the int8 forward's distance from the
     bf16 one;
  4. run one full-width UNet forward and backward with a masked image (the
     training path: flash backward, GEGLU backward, block recompute) on the
     card in bf16, by default and under FlashVariant(exp2=True), and on the
     CPU in fp32, and bound the relative error of the gradient with respect
     to the context;
  5. generate 2 prompts at 512x512 with DDIM-50 through
     StableDiffusionPipeline.generate with random weights from a seed, and
     check that each bf16 forward kernel (B1-B3) was launched 10 times per
     UNet evaluation, and the backward and int8 kernels never;
  6. take 4 Stage-1 training steps (bs 4, 512x512, ND 1 and 5 from seed 0)
     through AdaPromptTrainer.train_step at full width with random
     weights, and check the losses, the gradient norms, that the
     SubjBasisGenerator moved, and every kernel's launch count;
  7. serve 2 prompts at 512x512 through StableDiffusionPipeline.generate
     with sampler="dpmpp", 20 steps and FastConfig(), with quant="int8"
     and in bf16 (the same random weights), timed in turns, and check the
     images and every kernel's exact launch count;
  8. personalize: AdaFacePipeline at full width (random weights, IResNet-100
     behind a centre-crop embedder, UNetConfig(fused_conv=True)), three
     seeded 512x512 photos -> generate_adaface_embeddings -> __call__ for 2
     images (DDIM-50, UNet batch 4); check the subject vectors, the token
     table, the rewritten prompt, the images and every kernel's exact
     launch count; time the personalization latency (photos -> cond/uncond)
     and img/s with fused_conv on and off in turns (on, off, off, on);
  9. the flash variants on the two paths that take them, each run with the
     objects of the phase it follows: right after phase 5, DDIM-50
     generates of the 2 prompts in turns (default, ilv, nomax, exp2, then
     again) with exactly 500 launches of the selected forward kernel and 0
     of the others; right after phase 6, training steps at ND 1 in turns
     (default, exp2, exp2, default; two steps each) with the exp2 forward
     and backward launched as often as the default's;
 10. print the kernels' JSON line (thirteen rows), the card's name and
     power limit, and the final {"ok": true, "device": ...} line.

Needs a CUDA card; imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

H100_BF16_FLOPS = 989e12     # dense, data sheet (SXM, 700 W)
H100_INT8_OPS = 1979e12      # dense int8 tensor-core rate, same data sheet
H100_BYTES_PER_S = 3.35e12
H100_EXP_PER_S = 16 * 132 * 1.83e9   # exponentials: 16/clk/SM, 132 SMs, at the clock the peaks assume

PROMPTS = ["a portrait photo of a person, detailed, studio lighting",
           "a photo of a red car parked by the sea"]
UNET_BATCH = 2 * len(PROMPTS)           # (cond, uncond)
UNET_TOL = 5e-2                          # bf16 card vs fp32 CPU, relative L2
# d(loss)/d(context) through the whole UNet, bf16 card vs fp32 CPU, relative
# L2: the backward rounds the 25 blocks' activation gradients to bf16 and
# the flash backward rounds P and dS to bf16 (measured 3.2e-2)
UNET_GRAD_TOL = 5e-2
# Of the 10 flash self-attention layers of a UNet pass, the first (input
# block 1) comes before any cross-attention: nothing that needs a gradient
# reaches its q, k or v, so autograd runs the backward of the other 9.
FLASH_BWD_PER_PASS = 9
FLASH_BWD_TOL = 1e-2    # max|kernel - plain| / max|plain| per gradient (measured <= 5.1e-3)
TRAIN_STEPS = 4         # seed 0 draws ND = 1, 5, 1, 1
SERVE_STEPS = 20        # dpmpp-20 under FastConfig() (cache 3/3, CFG tail 0.3, ToMe 0.5)
CONV_TOL = 2e-2         # the three 3x3 conv kernels: max|kernel - plain| / max|plain|
PERSONAL_PROMPT = "portrait of a z person"
PERSONAL_IMAGES = 2     # UNet batch 4 with CFG, as the txt2img phase
PERSONAL_SUBJECTS = 5   # timed personalizations (3 photos each) after one warm-up


def log(msg):
    print(msg, flush=True)


FLASH_WRAPPERS = ("flash_attention_fwd", "flash_attention_fwd_ilv", "flash_attention_fwd_nomax",
                  "flash_attention_bwd")     # these also count their exp2-form launches


def zero_counts():
    from adaprompt_tpu_torch.ops import kernel_wrappers
    for name, w in kernel_wrappers().items():
        w.launches = 0
        if name in FLASH_WRAPPERS:
            w.exp2_launches = 0


def read_counts() -> dict:
    """{wrapper: launches} and, for the flash wrappers, {wrapper + ":exp2":
    how many of those were in the exp2 form}."""
    from adaprompt_tpu_torch.ops import kernel_wrappers
    counts = {n: w.launches for n, w in kernel_wrappers().items()}
    counts.update({n + ":exp2": kernel_wrappers()[n].exp2_launches for n in FLASH_WRAPPERS})
    return counts


def nz(counts: dict) -> dict:
    """The nonzero counts, for the log."""
    return {n: c for n, c in counts.items() if c}


def counts_since(before: dict) -> dict:
    return {n: c - before[n] for n, c in read_counts().items()}


def time_ms(fn, iters, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# Phase 1: build
# ---------------------------------------------------------------------------

def phase_build():
    from adaprompt_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    report = cuda_build.build()
    total = time.perf_counter() - t0
    for name, r in report.items():
        usage = [ln.strip() for ln in r["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"build {name}: {r['seconds']:.1f} s; " + " | ".join(usage))
    log(f"phase 1 build: {total:.1f} s for {len(report)} sources")
    sass_exp2_forms()


SASS_OPS = ("MUFU.EX2", "FMUL", "FFMA", "FADD", "FMNMX", "SHFL")


# the mangled template arguments of each flash kernel's D=40 instantiation,
# up to the EXP2 flag: all four are templated on D/8 (the backward's pre-pass
# and dQ epilogue are not templated, so they are not listed)
D40_INSTANCE = {"flash_attention": "ILi5E", "flash_attention_ilv": "ILi5E",
                "flash_attention_nomax": "ILi5E", "flash_attention_bwd": "ILi5E"}


def sass_exp2_forms():
    """Log, for the D=40 instantiation of each flash kernel, how often the
    opcodes of the softmax arithmetic occur in the SASS of its natural-log
    and of its exp2 form (`cuobjdump -sass`; static counts over the whole
    kernel): whether folding log2(e) into q drops a multiply."""
    import re
    import shutil
    from pathlib import Path
    from adaprompt_tpu_torch.ops import cuda_build
    tool = shutil.which("cuobjdump") or str(Path(cuda_build.nvcc()).with_name("cuobjdump"))
    if not Path(tool).exists():
        log("phase 1 sass: cuobjdump not found, exp2 forms not disassembled")
        return
    for lib, tag in D40_INSTANCE.items():
        res = subprocess.run([tool, "-sass", str(cuda_build.library_path(lib))],
                             capture_output=True, text=True, timeout=300, check=True)
        counts, fn = {}, None
        for line in res.stdout.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                counts[fn] = dict.fromkeys(SASS_OPS, 0)
            elif fn:
                for op in SASS_OPS:
                    counts[fn][op] += bool(re.search(rf"\b{re.escape(op)}\b", line))
        for fn, c in sorted(counts.items()):
            if tag in fn:               # <D40, false|true>
                form = "exp2" if tag + "Lb1E" in fn else "natural"
                kernel = re.search(r"flash_\w+?_kernel", fn)
                log(f"phase 1 sass {kernel.group(0) if kernel else fn}<D=40> {form}: "
                    + " ".join(f"{op}={n}" for op, n in c.items()))


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version at the main-path shapes
# ---------------------------------------------------------------------------

def _bound(flops, nbytes, exps=0, int8_ops=0):
    t_ops = (flops / H100_BF16_FLOPS + int8_ops / H100_INT8_OPS) * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "ops_ms": t_ops, "bytes_ms": t_bytes,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "exp_bound_ms": exps / H100_EXP_PER_S * 1e3}


def _compare(out, ref, rel_tol):
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    ok = math.isfinite(err) and err <= rel_tol * scale
    return err, scale, ok


def _variant_tag(variant):
    return "+".join(n for n in ("ilv", "nomax", "exp2") if getattr(variant, n)) or "default"


def _case_flash(gen, s, d, with_bias, variant=None, b=UNET_BATCH, h=8, timed=True, sk=None,
                masked=None):
    """A flash forward kernel (the one `variant` picks, in its exp2 form
    under variant.exp2) against its own plain version, with s queries and sk
    keys (default s); its distance from the default kernel's output is
    logged, unbounded. The key bias drops ~30% of the keys at random, and
    with masked="tile" every key of row 0's first 64-key tile, with
    masked="row" every key of the last row."""
    import torch
    import torch.nn.functional as F
    from adaprompt_tpu_torch.ops import attention as A
    variant = variant or A.FlashVariant()
    sk = sk or s
    mk = lambda n: torch.randn(b, n, h, d, device="cuda", generator=gen).to(torch.bfloat16)
    q, k, v = mk(s), mk(sk), mk(sk)
    bias = None
    if with_bias:
        keep = torch.rand(b, sk, device="cuda", generator=gen) < 0.7
        bias = (keep.float() - 1.0) * (-A.NEG_BIG)
        if masked == "tile":
            bias[0, :64] = A.NEG_BIG
        elif masked == "row":
            bias[-1] = A.NEG_BIG
    scale = d ** -0.5
    fwd = lambda: A.flash_attention_fwd(q, k, v, bias, scale, variant)
    plain = lambda: A.flash_attention_fwd_reference(q, k, v, bias, scale, variant)
    out, lse = fwd()
    ref, lse_ref = plain()
    err, mag, ok = _compare(out, ref, 2e-2)
    lse_err = (lse - lse_ref).abs().max().item()
    ok = ok and lse_err <= 1e-2
    detail = f"lse_err={lse_err:.2e} (tol 1e-2)"
    if variant != A.FlashVariant():
        base = A.flash_attention_fwd(q, k, v, bias, scale)[0]
        detail += f" vs default kernel {(out.float() - base.float()).abs().max().item():.2e}"
    del out, lse, ref, lse_ref
    res = {}
    if variant.forward == "nomax":
        # the kernel's C call alone (its pre-pass over K and the attention
        # kernel, without the wrapper's host work), and the pre-pass's kmax
        # against its plain version
        kmax, out_c = torch.empty(b * h, device="cuda"), torch.empty_like(q)
        lse_c = torch.empty(b * h, s, 1, device="cuda")
        call = lambda: A.nomax_kernel_call(q, k, v, bias, kmax, out_c, lse_c, scale, variant.exp2)
        call()
        kmax_ref = A.nomax_key_max(k)
        kmax_err = ((kmax - kmax_ref).abs().max() / kmax_ref.max()).item()
        ok = ok and kmax_err <= 1e-5
        detail += f" kmax pre-pass rel err {kmax_err:.1e} (tol 1e-5)"
        if timed:
            res["kernel_only_ms"] = time_ms(call, 10)
            detail += f" kernel_only_ms={res['kernel_only_ms']:.4f}"
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None if bias is None else bias[:, None, None, :].to(torch.bfloat16)
    res.update(kernel_ms=time_ms(fwd, 10) if timed else float("nan"),
               plain_ms=time_ms(plain, 3) if timed else float("nan"),
               library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, attn_mask=mask, scale=scale), 10) if timed else float("nan"))
    # q, out (bf16) and lse once, k, v (bf16) and the bias once
    flops = 4 * b * h * s * sk * d
    nbytes = 2 * b * (s + sk) * h * d * 2 + b * h * s * 4 + (b * sk * 4 if with_bias else 0)
    res.update(_bound(flops, nbytes, exps=b * h * s * sk))
    seq = f"S={s}" if sk == s else f"Sq={s} Sk={sk}"
    return (f"flash_attention_fwd[{_variant_tag(variant)}] D={d} {seq} B={b} H={h} "
            f"bias={masked or with_bias}", err, mag, 2e-2, ok, res, detail)


def _case_nomax_underflow():
    """Every score of a row far below its cap: the no-max kernel must return
    finite zeros (l clamped at 1e-30), not 0/0, and so must its plain version."""
    import torch
    from adaprompt_tpu_torch.ops import attention as A
    b, s, h, d = 1, 512, 1, 40
    q = torch.full((b, s, h, d), 60.0, device="cuda", dtype=torch.bfloat16)
    k, v = -q, torch.ones_like(q)
    for exp2 in (False, True):
        out, lse = A.flash_attention_fwd_nomax(q, k, v, None, d ** -0.5, exp2)
        ref, lse_ref = A.attention_reference_nomax(q, k, v, None, d ** -0.5, exp2)
        worst = max(out.float().abs().max().item(), ref.float().abs().max().item())
        finite = all(bool(torch.isfinite(t.float()).all()) for t in (out, lse, ref, lse_ref))
        log(f"kernel flash_attention_fwd[nomax{'+exp2' if exp2 else ''}] underflow rows: "
            f"max|out|={worst:.1e} finite={finite} "
            f"lse kernel/plain {lse.max().item():.1f}/{lse_ref.max().item():.1f}")
        if not (finite and worst == 0.0):
            raise AssertionError("the no-max kernel's underflow guard failed")


def _case_flash_bwd(gen, s, d, with_bias, exp2=False, b=UNET_BATCH, h=8, timed=True, sk=None,
                    masked=None):
    """The backward kernel (its exp2 form under `exp2`), from the matching
    forward's out and lse, against its plain version, with s queries and sk
    keys (default s); the key bias drops ~30% of the keys, and masked= masks a
    key tile or a row whole as in `_case_flash`. Besides: its C call's
    pre-pass delta against `flash_bwd_delta` (max error over max|delta|, tol
    1e-5), and how far dq of two C calls on the same inputs differ (dQ is
    summed with atomics: logged, unbounded). kernel_ms times the C call
    (pre-pass, kernel and dQ epilogue); the wrapper's call is logged beside."""
    import torch
    import torch.nn.functional as F
    from adaprompt_tpu_torch.ops import attention as A
    sk = sk or s
    mk = lambda n: torch.randn(b, n, h, d, device="cuda", generator=gen).to(torch.bfloat16)
    q, k, v, dout = mk(s), mk(sk), mk(sk), mk(s)
    bias = None
    if with_bias:
        keep = torch.rand(b, sk, device="cuda", generator=gen) < 0.7
        bias = (keep.float() - 1.0) * (-A.NEG_BIG)
        if masked == "tile":
            bias[0, :64] = A.NEG_BIG
        elif masked == "row":
            bias[-1] = A.NEG_BIG
    scale = d ** -0.5
    variant = A.FlashVariant(exp2=exp2)
    out, lse = A.flash_attention_fwd(q, k, v, bias, scale, variant)
    args = (q, k, v, bias, out, lse, dout, scale)
    got = A.flash_attention_bwd(*args, variant)
    ref = A.flash_attention_bwd_reference(*args, exp2)
    cmp = [_compare(x, y, FLASH_BWD_TOL) for x, y in zip(got, ref)]
    err = max(c[0] for c in cmp)
    mag = max(c[1] for c in cmp)
    ok = all(c[2] for c in cmp)
    detail = " ".join(f"{n}={c[0] / c[1]:.2e}" for n, c in zip(("dq", "dk", "dv"), cmp))
    del ref
    ld = torch.empty(b * h, s, 2, device="cuda")
    dq_acc = torch.empty(b, s, h, d, device="cuda")
    grads = [torch.empty_like(x) for x in (q, k, v)]
    call = lambda: A.flash_bwd_kernel_call(q, k, v, bias, out, lse, dout, ld, dq_acc, *grads,
                                           scale, exp2)
    call()
    delta = A.flash_bwd_delta(out, dout)
    delta_err = ((ld[..., 1] - delta).abs().max() / delta.abs().max()).item()
    ok = ok and delta_err <= 1e-5
    first = [x.clone() for x in grads]
    call()
    rerun = [(x.float() - y.float()).abs().max().item() for x, y in zip(grads, first)]
    detail += (f" delta pre-pass rel err {delta_err:.1e} (tol 1e-5); two calls differ by "
               f"dq {rerun[0]:.1e} dk {rerun[1]:.1e} dv {rerun[2]:.1e}")
    del got, first
    nan = float("nan")
    res = {"kernel_ms": time_ms(call, 10) if timed else nan,
           "wrapper_ms": (time_ms(lambda: A.flash_attention_bwd(*args, variant), 10)
                          if timed else nan),
           "plain_ms": (time_ms(lambda: A.flash_attention_bwd_reference(*args, exp2), 2)
                        if timed else nan)}
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    mask = None if bias is None else bias[:, None, None, :].to(torch.bfloat16)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale)
    gt = dout.transpose(1, 2)
    sdpa_fwd_ms = time_ms(sdpa, 10) if timed else nan
    sdpa_both_ms = (time_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), gt), 10)
                    if timed else nan)
    res["library_ms"] = sdpa_both_ms - sdpa_fwd_ms
    if timed:
        detail += f" wrapper_ms={res['wrapper_ms']:.4f}"
    # 5 Sq*Sk*D products of 2 flops; each input (q, out, dout, k, v, lse,
    # bias) read once and dq, dk, dv written once; one exponential per score
    flops = 10 * b * h * s * sk * d
    nbytes = (4 * s + 4 * sk) * b * h * d * 2 + b * h * s * 4 + (b * sk * 4 if with_bias else 0)
    res.update(_bound(flops, nbytes, exps=b * h * s * sk))
    seq = f"S={s}" if sk == s else f"Sq={s} Sk={sk}"
    return (f"flash_attention_bwd[{'exp2' if exp2 else 'default'}] D={d} {seq} B={b} H={h} "
            f"bias={masked or with_bias}", err, mag, FLASH_BWD_TOL, ok, res, detail)


def _case_flash_int8(gen, s, d, with_bias, b=UNET_BATCH, h=8, sk=None, timed=True):
    """The int8-QK flash kernel against its plain version. Both make their
    int8 operands with the same PyTorch code on the same tensors on the card
    (`int8_qk_operands`: deterministic), so they are fed equal operands. Its
    distance from exact bf16 attention is logged, unbounded."""
    import torch
    import torch.nn.functional as F
    from adaprompt_tpu_torch.ops import attention as A
    sk = sk or s
    mk = lambda n: torch.randn(b, n, h, d, device="cuda", generator=gen)
    q, k, v = mk(s).to(torch.bfloat16), (mk(sk) + 0.7).to(torch.bfloat16), mk(sk).to(torch.bfloat16)
    bias = None
    if with_bias:
        keep = torch.rand(b, sk, device="cuda", generator=gen) < 0.7
        bias = (keep.float() - 1.0) * (-A.NEG_BIG)
    scale = d ** -0.5
    out = A.flash_attention_int8(q, k, v, bias, scale)
    ref = A.flash_attention_int8_reference(q, k, v, bias, scale)
    err, mag, ok = _compare(out, ref, 2e-2)
    exact = A.attention_reference(q, k, v, bias, scale)[0]
    detail = f"vs exact bf16 attention {(out.float() - exact.float()).abs().max().item():.2e}"
    del ref, exact
    nan = float("nan")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None if bias is None else bias[:, None, None, :].to(torch.bfloat16)
    res = {"kernel_ms": time_ms(lambda: A.flash_attention_int8(q, k, v, bias, scale), 10)
           if timed else nan,
           "operands_ms": time_ms(lambda: A.int8_qk_operands(q, k, v), 10) if timed else nan,
           "plain_ms": time_ms(lambda: A.flash_attention_int8_reference(q, k, v, bias, scale), 3)
           if timed else nan,
           "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
               qt, kt, vt, attn_mask=mask, scale=scale), 10) if timed else nan}
    # q.k^T as int8 operations, p.v as bf16 flops; the function's inputs
    # (q, k, v bf16, the bias) read once and the output written once
    nbytes = 2 * b * (s + sk) * h * d * 2 + (b * sk * 4 if with_bias else 0)
    res.update(_bound(2 * b * h * s * sk * d, nbytes, exps=b * h * s * sk,
                      int8_ops=2 * b * h * s * sk * d))
    detail += f" operands_ms={res['operands_ms']:.4f} (in kernel_ms)"
    return (f"flash_attention_int8 D={d} Sq={s} Sk={sk} B={b} H={h} bias={with_bias}", err, mag,
            2e-2, ok, res, detail)


def _case_self(gen, n, c, with_bias, b=UNET_BATCH, timed=True):
    """The fused self-attention kernel against its plain version. No single
    PyTorch call computes it (library_ms None); `unfused_ms` is the chain the
    port's UNet runs instead (three linears, the flash kernel, the
    out-projection), logged beside it."""
    import torch
    from adaprompt_tpu_torch.ops import attention as A
    h = 8
    bf = torch.bfloat16
    x = torch.randn(b, n, c, device="cuda", generator=gen).to(bf)
    w = lambda: ((torch.rand(c, c, device="cuda", generator=gen) * 2 - 1) / math.sqrt(c)).to(bf)
    wq, wk, wv, wo = w(), w(), w(), w()
    bo = (torch.rand(c, device="cuda", generator=gen) * 2 - 1) / math.sqrt(c)
    bias = None
    if with_bias:
        keep = torch.rand(b, n, device="cuda", generator=gen) < 0.7
        bias = (keep.float() - 1.0) * (-A.NEG_BIG)
    scale = (c // h) ** -0.5
    args = (x, wq, wk, wv, wo, bo, scale, h, bias)
    out = A.fused_self_attention(*args)
    ref = A.fused_self_attention_reference(*args)
    err, mag, ok = _compare(out, ref, 2e-2)
    del ref

    def unfused():
        q, k, v = ((x @ m.t()).reshape(b, n, h, c // h) for m in (wq, wk, wv))
        o = A.flash_attention_fwd(q, k, v, bias, scale)[0]
        return o.reshape(b, n, c) @ wo.t() + bo.to(bf)

    nan = float("nan")
    res = {"kernel_ms": time_ms(lambda: A.fused_self_attention(*args), 5) if timed else nan,
           "kv_ms": time_ms(lambda: A.packed_kv(x, wk, wv), 10) if timed else nan,
           "plain_ms": time_ms(lambda: A.fused_self_attention_reference(*args), 2)
           if timed else nan,
           "library_ms": None,
           "unfused_ms": time_ms(unfused, 5) if timed else nan}
    # the flash kernel's work plus the four C x C projections; x in and out
    # once, the four weights, bo and the bias
    flops = 4 * b * n * n * c + 8 * b * n * c * c
    nbytes = 2 * b * n * c * 2 + 4 * c * c * 2 + c * 4 + (b * n * 4 if with_bias else 0)
    res.update(_bound(flops, nbytes, exps=b * h * n * n))
    detail = f"kv_ms={res['kv_ms']:.4f} (in kernel_ms) unfused_ms={res['unfused_ms']:.4f}"
    return (f"fused_self_attention C={c} N={n} B={b} bias={with_bias}", err, mag, 2e-2, ok,
            res, detail)


def _case_cross(gen, n, c, b=UNET_BATCH):
    import torch
    from adaprompt_tpu_torch.ops import attention as A
    h, s = 8, 77
    bf = torch.bfloat16
    x = torch.randn(b, n, c, device="cuda", generator=gen).to(bf)
    w = lambda: ((torch.rand(c, c, device="cuda", generator=gen) * 2 - 1) / math.sqrt(c)).to(bf)
    wq, wo = w(), w()
    k = torch.randn(b, s, h, c // h, device="cuda", generator=gen).to(bf)
    v = torch.randn(b, s, h, c // h, device="cuda", generator=gen).to(bf)
    bo = (torch.rand(c, device="cuda", generator=gen) * 2 - 1) / math.sqrt(c)
    scale = (c // h) ** -0.5
    args = (x, wq, k, v, wo, bo, scale, h)
    out = A.fused_cross_attention(*args)
    ref = A.fused_cross_attention_reference(*args)
    err, mag, ok = _compare(out, ref, 2e-2)
    res = {"kernel_ms": time_ms(lambda: A.fused_cross_attention(*args), 10),
           "plain_ms": time_ms(lambda: A.fused_cross_attention_reference(*args), 3),
           "library_ms": None}
    flops = b * n * (4 * c * c + 4 * s * c)
    nbytes = 2 * b * n * c * 2 + 2 * c * c * 2 + 2 * b * s * c * 2 + c * 4
    res.update(_bound(flops, nbytes, exps=b * h * n * s))
    return f"fused_cross_attention C={c} N={n} B={b}", err, mag, 2e-2, ok, res, ""


def _case_geglu(gen, n, c):
    import torch
    from adaprompt_tpu_torch.ops import geglu as G
    m, f = UNET_BATCH * n, 4 * c
    bf = torch.bfloat16
    u = lambda *shape, fan: ((torch.rand(*shape, device="cuda", generator=gen) * 2 - 1)
                             / math.sqrt(fan))
    x = torch.randn(m, c, device="cuda", generator=gen).to(bf)
    w1, b1 = u(2 * f, c, fan=c).to(bf), u(2 * f, fan=c)
    w2, b2 = u(c, f, fan=f).to(bf), u(c, fan=f)
    args = (x, w1, b1, w2, b2)
    out = G.geglu_fwd(*args)
    ref = G.geglu_reference(*args)
    err, mag, ok = _compare(out, ref, 1e-2)
    res = {"kernel_ms": time_ms(lambda: G.geglu_fwd(*args), 10),
           "plain_ms": time_ms(lambda: G.geglu_reference(*args), 3),
           "library_ms": None}
    flops = 6 * m * c * f
    nbytes = 2 * m * c * 2 + 3 * f * c * 2 + 2 * f * 4 + c * 4
    res.update(_bound(flops, nbytes, exps=m * f))
    return f"geglu C={c} M={m}", err, mag, 1e-2, ok, res, ""


def _int8_weights(gen, n, k):
    import torch
    from adaprompt_tpu_torch.ops.quant import quantize_weight
    w = (torch.rand(n, k, device="cuda", generator=gen) * 2 - 1) / math.sqrt(k)
    return quantize_weight(w.to(torch.bfloat16))


def _case_cross_int8(gen, n, c, b):
    import torch
    from adaprompt_tpu_torch.ops import attention as A
    h, s = 8, 77
    bf = torch.bfloat16
    x = torch.randn(b, n, c, device="cuda", generator=gen).to(bf)
    k = torch.randn(b, s, h, c // h, device="cuda", generator=gen).to(bf)
    v = torch.randn(b, s, h, c // h, device="cuda", generator=gen).to(bf)
    bo = (torch.rand(c, device="cuda", generator=gen) * 2 - 1) / math.sqrt(c)
    args = (x, *_int8_weights(gen, c, c), k, v, *_int8_weights(gen, c, c), bo,
            (c // h) ** -0.5, h)
    out = A.fused_cross_attention_int8(*args)
    ref = A.fused_cross_attention_int8_reference(*args)
    err, mag, ok = _compare(out, ref, 2e-2)
    res = {"kernel_ms": time_ms(lambda: A.fused_cross_attention_int8(*args), 10),
           "plain_ms": time_ms(lambda: A.fused_cross_attention_int8_reference(*args), 3),
           "library_ms": None}
    # int8: the two C x C projections; bf16: the attention over S keys.
    # Bytes: x in and out (bf16), the int8 weights, their f32 scales and bo, k and v
    nbytes = 2 * b * n * c * 2 + 2 * c * c + 3 * c * 4 + 2 * b * s * c * 2
    res.update(_bound(b * n * 4 * s * c, nbytes, exps=b * h * n * s,
                      int8_ops=b * n * 4 * c * c))
    return f"fused_cross_attention_int8 C={c} N={n} B={b}", err, mag, 2e-2, ok, res, ""


def _case_geglu_int8(gen, m, c):
    import torch
    from adaprompt_tpu_torch.ops import geglu as G
    f = 4 * c
    u = lambda *shape, fan: ((torch.rand(*shape, device="cuda", generator=gen) * 2 - 1)
                             / math.sqrt(fan))
    x = torch.randn(m, c, device="cuda", generator=gen).to(torch.bfloat16)
    args = (x, *_int8_weights(gen, 2 * f, c), u(2 * f, fan=c), *_int8_weights(gen, c, f),
            u(c, fan=f))
    out = G.geglu_int8(*args)
    ref = G.geglu_int8_reference(*args)
    err, mag, ok = _compare(out, ref, 2e-2)
    res = {"kernel_ms": time_ms(lambda: G.geglu_int8(*args), 10),
           "plain_ms": time_ms(lambda: G.geglu_int8_reference(*args), 3),
           "library_ms": None}
    # 24*M*C^2 int8 operations; x in and out (bf16), the int8 weights (3*C*F
    # bytes), their f32 scales and the biases
    nbytes = 2 * m * c * 2 + 3 * c * f + 2 * (2 * f + c) * 4
    res.update(_bound(0, nbytes, exps=m * f, int8_ops=6 * m * c * f))
    return f"geglu_int8 C={c} M={m}", err, mag, 2e-2, ok, res, ""


def _conv_inputs(gen, b, h, w, c, o, gn_shift=0.0):
    import torch
    rn = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)
    x = (rn(b, h, w, c) * 1.5 + 0.5).to(torch.bfloat16)
    weight = ((torch.rand(o, c, 3, 3, device="cuda", generator=gen) * 2 - 1)
              / math.sqrt(9 * c)).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    bias = (torch.rand(o, device="cuda", generator=gen) * 2 - 1) / math.sqrt(9 * c)
    return x, weight, bias, 1 + 0.1 * rn(c), 0.1 * rn(c) + gn_shift


def _conv_bound(b, h, w, c, o, extra_bytes=0):
    # 9 taps of a [B*H*W, C] x [C, O] product; x read and out written once
    # (bf16), the weight (bf16) and the f32 bias read once
    return _bound(2 * b * h * w * 9 * c * o,
                  2 * b * h * w * (c + o) + 2 * 9 * c * o + 4 * o + extra_bytes)


def _case_conv(gen, fn_name, b, h, w, c, o):
    """conv3x3_halo or conv3x3_im2col against its plain version; library:
    F.conv2d (cuDNN) on the same bf16 NHWC tensors."""
    import torch
    from adaprompt_tpu_torch.ops import conv_halo as CH
    from adaprompt_tpu_torch.ops.layers import conv2d
    x, weight, bias, _, _ = _conv_inputs(gen, b, h, w, c, o)
    fn, ref = getattr(CH, fn_name), getattr(CH, fn_name + "_reference")
    packed = CH.pack_conv_weight(weight)
    err, mag, ok = _compare(fn(x, weight, bias, packed=packed), ref(x, weight, bias), CONV_TOL)
    bias16 = bias.to(torch.bfloat16)
    res = {"kernel_ms": time_ms(lambda: fn(x, weight, bias, packed=packed), 10),
           "plain_ms": time_ms(lambda: ref(x, weight, bias), 3),
           "library_ms": time_ms(lambda: conv2d(x, weight, bias16), 10)}
    res.update(_conv_bound(b, h, w, c, o))
    return f"{fn_name} H={h} W={w} C={c} O={o} B={b}", err, mag, CONV_TOL, ok, res, ""


def _case_gn_conv(gen, b, h, c, o, gn_shift):
    """The fused GroupNorm-SiLU-conv against its plain version. No single
    PyTorch call computes it (library_ms None); `unfused_ms` is the port's
    own unfused pair, layers.group_norm(..., "silu") + conv2d, the time the
    kernel has to beat, and `affine_ms` the statistics pass that the
    wrapper runs before the kernel (counted in kernel_ms). With gn_shift > 0
    the case also shows that an unmasked border would miss the bound."""
    import torch
    import torch.nn.functional as F
    from adaprompt_tpu_torch.ops import conv_halo as CH
    from adaprompt_tpu_torch.ops.layers import conv2d, group_norm
    x, weight, bias, gs, gb = _conv_inputs(gen, b, h, h, c, o, gn_shift)
    packed = CH.pack_conv_weight(weight)
    fused = lambda: CH.gn_silu_conv3x3_halo(x, gs, gb, weight, bias, packed=packed)
    ref = CH.gn_silu_conv3x3_halo_reference(x, gs, gb, weight, bias)
    err, mag, ok = _compare(fused(), ref, CONV_TOL)
    detail = ""
    if gn_shift:
        # what a kernel that padded x before the affine would return: silu(b) on the border
        ab = CH.gn_affine(x, gs, gb)
        seg = F.pad(x.float(), (0, 0, 1, 1, 1, 1)) * ab[:, 0, None, None, :] + ab[:, 1, None, None, :]
        act = (seg * torch.sigmoid(seg)).to(x.dtype).float().permute(0, 3, 1, 2)
        wrong = F.conv2d(act, weight.float(), bias).permute(0, 2, 3, 1)
        miss = (wrong - ref.float()).abs().max().item()
        detail = f"unmasked border would err {miss / mag:.3e}*max"
        ok = ok and miss > 2 * CONV_TOL * mag
    gs16, gb16, bias16 = (t.to(torch.bfloat16) for t in (gs, gb, bias))
    unfused = lambda: conv2d(group_norm(x, gs16, gb16, eps=1e-5, activation="silu"), weight, bias16)
    res = {"kernel_ms": time_ms(fused, 10),
           "plain_ms": time_ms(lambda: CH.gn_silu_conv3x3_halo_reference(x, gs, gb, weight, bias), 3),
           "library_ms": None,
           "unfused_ms": time_ms(unfused, 10),
           "affine_ms": time_ms(lambda: CH.gn_affine(x, gs, gb), 10)}
    res.update(_conv_bound(b, h, h, c, o, extra_bytes=8 * c))
    detail += f" unfused_ms={res['unfused_ms']:.4f} affine_ms={res['affine_ms']:.4f}"
    return (f"gn_silu_conv3x3_halo H={h} C={c} O={o} B={b} gn_shift={gn_shift:g}", err, mag,
            CONV_TOL, ok, res, detail)


def flash_resources():
    """Log the four flash kernels' resources (the forwards B1, B12, B13 and
    the backward B4's main kernel) at the UNet's head dims, in both forms,
    from the runtime: registers a thread, shared memory a block, query rows
    a block (the backward: keys a block and query rows a streamed tile),
    resident blocks an SM (the backward also its local memory a thread)."""
    import ctypes
    from adaprompt_tpu_torch.ops import cuda_build
    for lib, wrapper in (("flash_attention", "flash_attention_fwd"),
                         ("flash_attention_ilv", "flash_attention_fwd_ilv"),
                         ("flash_attention_nomax", "flash_attention_fwd_nomax"),
                         ("flash_attention_bwd", "flash_attention_bwd")):
        fn = cuda_build.function(lib, wrapper + "_describe",
                                 [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        for d in (40, 80):
            for exp2 in (False, True):
                info = (ctypes.c_int * 6)()
                cuda_build.check(fn(d, int(exp2), ctypes.addressof(info)), wrapper + "_describe")
                head = (f"kernel {wrapper}{':exp2' if exp2 else ''} D={d}: {info[0]} registers "
                        f"a thread, {info[1]} B shared memory a block, ")
                if lib == "flash_attention_bwd":
                    log(head + f"{info[2]} keys a block, {info[3]} query rows a tile, "
                        f"{info[4]} blocks an SM, {info[5]} B local memory a thread")
                else:
                    log(head + f"{info[2]} query rows a block, {info[3]} blocks an SM")


def phase_kernels():
    """Returns {wrapper name: [per-shape results]} for the kernels line."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    flash_resources()
    # (wrapper, the paths whose shapes these are, case): txt2img has no
    # img_mask, training masks the self-attention keys (bias); the flash
    # backward without bias is on no path and is checked all the same. The
    # serving stack merges the 64x64 level's 4096 tokens to 2048 (ToMe 0.5)
    # for self-attention and the feed-forward, never for cross-attention,
    # and runs batch 4 in the CFG steps and batch 2 in the cond-only tail.
    gen_, train = ("generate",), ("train",)
    serve, s8 = ("serve_int8", "serve_bf16"), ("serve_int8",)
    # the product path is the txt2img UNet (batch 4) plus the fused convs,
    # whose three shapes are the keys of conv_halo._FUSED_TABLE
    pers = ("personalize",)
    gen_ = gen_ + pers
    both = gen_ + train
    from adaprompt_tpu_torch.ops.attention import FlashVariant as V
    cases = [("flash_attention_fwd", gen_, lambda: _case_flash(gen, 4096, 40, False)),
             ("flash_attention_fwd", train, lambda: _case_flash(gen, 4096, 40, True)),
             ("flash_attention_fwd", gen_ + serve, lambda: _case_flash(gen, 1024, 80, False)),
             ("flash_attention_fwd", train, lambda: _case_flash(gen, 1024, 80, True)),
             ("flash_attention_fwd", serve, lambda: _case_flash(gen, 2048, 40, False)),
             ("flash_attention_bwd", (), lambda: _case_flash_bwd(gen, 4096, 40, False)),
             ("flash_attention_bwd", train, lambda: _case_flash_bwd(gen, 4096, 40, True)),
             ("flash_attention_bwd", (), lambda: _case_flash_bwd(gen, 1024, 80, False)),
             ("flash_attention_bwd", train, lambda: _case_flash_bwd(gen, 1024, 80, True)),
             ("fused_cross_attention", gen_ + ("serve_bf16",),
              lambda: _case_cross(gen, 4096, 320)),
             ("fused_cross_attention", gen_ + ("serve_bf16",),
              lambda: _case_cross(gen, 1024, 640)),
             ("fused_cross_attention", ("serve_bf16",), lambda: _case_cross(gen, 4096, 320, 2)),
             ("fused_cross_attention", ("serve_bf16",), lambda: _case_cross(gen, 1024, 640, 2)),
             ("geglu_fwd", both, lambda: _case_geglu(gen, 4096, 320)),
             ("geglu_fwd", both + ("serve_bf16",), lambda: _case_geglu(gen, 1024, 640)),
             ("geglu_fwd", ("serve_bf16",), lambda: _case_geglu(gen, 2048, 320)),
             ("fused_cross_attention_int8", s8, lambda: _case_cross_int8(gen, 4096, 320, 4)),
             ("fused_cross_attention_int8", s8, lambda: _case_cross_int8(gen, 1024, 640, 4)),
             ("fused_cross_attention_int8", s8, lambda: _case_cross_int8(gen, 4096, 320, 2)),
             ("fused_cross_attention_int8", s8, lambda: _case_cross_int8(gen, 1024, 640, 2)),
             ("geglu_int8", s8, lambda: _case_geglu_int8(gen, 4 * 2048, 320)),
             ("geglu_int8", s8, lambda: _case_geglu_int8(gen, 2 * 2048, 320)),
             ("geglu_int8", s8, lambda: _case_geglu_int8(gen, 4 * 1024, 640)),
             ("geglu_int8", s8, lambda: _case_geglu_int8(gen, 2 * 1024, 640)),
             ("gn_silu_conv3x3_halo", pers, lambda: _case_gn_conv(gen, 4, 64, 320, 320, 0.0)),
             ("gn_silu_conv3x3_halo", pers, lambda: _case_gn_conv(gen, 4, 64, 320, 320, 3.0)),
             ("gn_silu_conv3x3_halo", pers, lambda: _case_gn_conv(gen, 4, 32, 320, 640, 0.0)),
             ("gn_silu_conv3x3_halo", pers, lambda: _case_gn_conv(gen, 4, 32, 960, 640, 0.0))]
    # the other ResBlock conv shapes of the SD-1.5 UNet, which the eligibility
    # table leaves to GroupNorm + cuDNN: timed to show where fusing would pay
    for h, c, o in ((32, 640, 640), (16, 640, 1280), (16, 1280, 1280), (8, 1280, 1280),
                    (8, 2560, 1280), (16, 2560, 1280), (16, 1920, 1280), (32, 1920, 640),
                    (32, 1280, 640), (64, 960, 320), (64, 640, 320)):
        cases.append(("gn_silu_conv3x3_halo", (),
                      lambda s=(h, c, o): _case_gn_conv(gen, 4, *s, 0.0)))
    # the two plain convs run on no path (wired nowhere, as in the JAX package)
    for fn_name in ("conv3x3_halo", "conv3x3_im2col"):
        for shape in ((4, 64, 64, 320, 320), (4, 32, 32, 640, 640), (4, 16, 16, 1280, 1280),
                      (3, 23, 37, 200, 72)):
            cases.append((fn_name, (), lambda f=fn_name, s=shape: _case_conv(gen, f, *s)))
    # the flash variants at the UNet's three self-attention shapes, with and
    # without key bias: the two-chain and no-max forwards and the exp2 forms
    # (rows "<wrapper>:exp2"); generate runs the unbiased D=40 S=4096 and D=80
    # S=1024, training the biased ones; S=2048 is the serving stack's shape
    for fwd, name in ((V(ilv=True), "flash_attention_fwd_ilv"),
                      (V(nomax=True), "flash_attention_fwd_nomax")):
        for s_, d_ in ((4096, 40), (2048, 40), (1024, 80)):
            for biased in (False, True):
                on_path = ("generate_" + fwd.forward,) if s_ != 2048 and not biased else ()
                cases.append((name, on_path,
                              lambda a=(s_, d_, biased), f=fwd: _case_flash(gen, *a, f)))
        cases.append((name + ":exp2", (), lambda f=fwd: _case_flash(
            gen, 4096, 40, False, dataclasses.replace(f, exp2=True))))
        cases.append((name + ":exp2", (), lambda f=fwd: _case_flash(
            gen, 1024, 80, True, dataclasses.replace(f, exp2=True))))
    for s_, d_ in ((4096, 40), (2048, 40), (1024, 80)):
        for biased in (False, True):
            on_path = () if s_ == 2048 else ("train_exp2",) if biased else ("generate_exp2",)
            cases.append(("flash_attention_fwd:exp2", on_path,
                          lambda a=(s_, d_, biased): _case_flash(gen, *a, V(exp2=True))))
    for s_, d_ in ((4096, 40), (1024, 80)):
        cases.append(("flash_attention_bwd:exp2", ("train_exp2",),
                      lambda a=(s_, d_): _case_flash_bwd(gen, *a, True, exp2=True)))
    # ragged cases, each forward in both forms: Sq != Sk with both ragged,
    # head dims 8 to 128, one key tile only (Sk = 50, 64), a key tile masked
    # whole, a row masked whole; key-tile counts 1, 2, 3, 4, 5, 16 and, for the
    # two-chain kernel, also 9 (an odd count with a last tile of 40 keys)
    ragged = [(300, 200, 64, True, None, 1, 3), (129, 1000, 128, False, None, 2, 1),
              (100, 77, 80, True, None, 2, 2), (64, 64, 8, False, None, 2, 4),
              (200, 50, 16, True, None, 2, 2), (333, 300, 40, True, "tile", 2, 2),
              (257, 190, 40, True, "row", 2, 2)]
    for fwd, name in ((V(), "flash_attention_fwd"), (V(exp2=True), "flash_attention_fwd:exp2"),
                      (V(ilv=True), "flash_attention_fwd_ilv"),
                      (V(ilv=True, exp2=True), "flash_attention_fwd_ilv:exp2"),
                      (V(nomax=True), "flash_attention_fwd_nomax"),
                      (V(nomax=True, exp2=True), "flash_attention_fwd_nomax:exp2")):
        extra = [(552, 552, 40, True, None, 2, 3)] if fwd.ilv else []
        for s_, sk_, d_, bias_, masked, b_, h_ in ragged + extra:
            cases.append((name, (), lambda a=(s_, d_, bias_, fwd),
                          kw=dict(b=b_, h=h_, sk=sk_, masked=masked): _case_flash(
                              gen, *a, timed=False, **kw)))
    cases.append(("flash_attention_bwd:exp2", (), lambda: _case_flash_bwd(
        gen, 300, 64, True, exp2=True, b=1, h=3, timed=False)))
    # the backward in both forms, untimed, on the forwards' ragged cases
    for exp2, name in ((False, "flash_attention_bwd"), (True, "flash_attention_bwd:exp2")):
        for s_, sk_, d_, bias_, masked, b_, h_ in ragged:
            cases.append((name, (), lambda a=(s_, d_, bias_), kw=dict(
                exp2=exp2, b=b_, h=h_, sk=sk_, masked=masked): _case_flash_bwd(
                    gen, *a, timed=False, **kw)))
    # the two attention kernels that no path runs (wired nowhere, as in the
    # JAX package), at the UNet's self-attention shapes and ragged ones
    for s_, d_ in ((4096, 40), (2048, 40), (1024, 80)):
        for biased in (False, True):
            cases.append(("flash_attention_int8", (),
                          lambda a=(s_, d_, biased): _case_flash_int8(gen, *a)))
    cases.append(("flash_attention_int8", (), lambda: _case_flash_int8(
        gen, 300, 64, True, b=1, h=3, sk=203, timed=False)))
    cases.append(("flash_attention_int8", (), lambda: _case_flash_int8(
        gen, 100, 128, False, b=2, h=2, sk=1000, timed=False)))
    for n_, c_ in ((4096, 320), (1024, 640)):
        for biased in (False, True):
            cases.append(("fused_self_attention", (),
                          lambda a=(n_, c_, biased): _case_self(gen, *a)))
    cases.append(("fused_self_attention", (), lambda: _case_self(gen, 1000, 320, True, b=1,
                                                                 timed=False)))
    cases.append(("fused_self_attention", (), lambda: _case_self(gen, 77, 1280, False, b=2,
                                                                 timed=False)))
    results, failed = {}, []
    for name, paths, case in cases:
        label, err, mag, tol, ok, res, detail = case()
        res["timed"] = not math.isnan(res["kernel_ms"])
        res["max_abs_err"] = err
        res["paths"] = paths
        log(f"kernel {label}: max_abs_err={err:.3e} max|plain|={mag:.3e} "
            f"rel={err / mag:.3e} tol={tol:g}*max|plain| {detail} kernel_ms={res['kernel_ms']:.4f} "
            f"plain_ms={res['plain_ms']:.4f} library_ms={res['library_ms']} "
            f"bound_ms={res['bound_ms']:.4f} ({res['bound_by']}) "
            f"exp_bound_ms={res['exp_bound_ms']:.4f} {'OK' if ok else 'FAIL'}")
        if not ok:
            failed.append(label)
        results.setdefault(name, []).append(res)
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: {failed}")
    _case_nomax_underflow()
    return results


def fused_convs_per_pass() -> int:
    """The ResBlock convs of one full-width UNet pass over 64x64 latents that
    take the fused kernel under fused_conv, from the UNet's plan: 9 of 44
    (7 at (64, 320, 320), 1 at (32, 320, 640), 1 at (32, 960, 640))."""
    from adaprompt_tpu_torch.models.unet import SD15_UNET_CONFIG, resblock_conv_shapes
    from adaprompt_tpu_torch.ops.conv_halo import _FUSED_TABLE
    shapes = resblock_conv_shapes(SD15_UNET_CONFIG, 64)
    n = sum(shape in _FUSED_TABLE for shape in shapes)
    if (len(shapes), n) != (44, 9):
        raise AssertionError(f"{n} of {len(shapes)} ResBlock convs are eligible, expected 9 of 44")
    return n


def phase_unet_check():
    """One full-width UNet forward (64x64 latents, 2 rows) on the card in
    bf16, one with quant="int8" (B5 and B6), one with fused_conv (B7) and
    one under each flash variant (ilv: B12, nomax: B13, exp2: B1's exp2
    form), each against the same weights on the CPU in fp32 (the int8 one
    through the kernels' plain versions; in fp32 no conv is eligible for
    fusion and the flash variants differ from the default by roundings only,
    so those forwards are held to the plain fp32 one)."""
    import torch
    from adaprompt_tpu_torch.models.unet import UNet
    from adaprompt_tpu_torch.ops.attention import FlashVariant
    from adaprompt_tpu_torch.ops.layers import randomize_zero_init, reset_parameters
    gen = torch.Generator(device="cuda").manual_seed(1)
    unet = reset_parameters(UNet(device="cuda", dtype=torch.bfloat16), gen)
    randomize_zero_init(unet, gen)
    int8 = dataclasses.replace(unet.cfg, quant="int8")
    fused = dataclasses.replace(unet.cfg, fused_conv=True)
    variants = {name: dataclasses.replace(unet.cfg, flash_variant=FlashVariant(**{name: True}))
                for name in ("ilv", "nomax", "exp2")}
    x = torch.randn(2, 64, 64, 4, device="cuda", generator=gen).to(torch.bfloat16)
    ctx = torch.randn(1, 2, 77, 768, device="cuda", generator=gen).to(torch.bfloat16)
    ts = torch.tensor([981, 501], device="cuda")
    before = read_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        kv = unet.precompute_cross_kv(ctx)
        eps = unet(x, ts, ctx, cross_kv=kv).float().cpu()
        eps8 = unet(x, ts, ctx, cross_kv=kv, cfg=int8).float().cpu()
        eps_fused = unet(x, ts, ctx, cross_kv=kv, cfg=fused).float().cpu()
        eps_var = {name: unet(x, ts, ctx, cross_kv=kv, cfg=c).float().cpu()
                   for name, c in variants.items()}
    card_s = time.perf_counter() - t0
    counts = counts_since(before)
    cpu = UNet(device="cpu", dtype=torch.float32)
    cpu.load_state_dict({k: v.float().cpu() for k, v in unet.state_dict().items()})
    del unet
    t0 = time.perf_counter()
    with torch.inference_mode():
        ctx32 = ctx.float().cpu()
        kv32 = cpu.precompute_cross_kv(ctx32)
        ref = cpu(x.float().cpu(), ts.cpu(), ctx32, cross_kv=kv32)
        ref8 = cpu(x.float().cpu(), ts.cpu(), ctx32, cross_kv=kv32, cfg=int8)
    cpu_s = time.perf_counter() - t0
    rel_l2 = lambda a, b: ((a - b).norm() / b.norm()).item()
    rel, rel8, rel_fused = rel_l2(eps, ref), rel_l2(eps8, ref8), rel_l2(eps_fused, ref)
    log(f"phase 3 unet: bf16 card vs fp32 CPU relative L2 error {rel:.4e}; int8 card vs int8 "
        f"fp32 CPU {rel8:.4e}; fused_conv card vs fp32 CPU {rel_fused:.4e} (bound {UNET_TOL:g} "
        f"each); int8 vs bf16 on the card {rel_l2(eps8, eps):.4e}, fused_conv vs bf16 on the "
        f"card {rel_l2(eps_fused, eps):.4e}, int8 vs fp32 on the CPU {rel_l2(ref8, ref):.4e}; "
        f"|eps| max {ref.abs().max().item():.3e}; card {card_s:.2f} s (first calls), "
        f"CPU {cpu_s:.1f} s; launches {nz(counts)}")
    rel_var = {name: rel_l2(e, ref) for name, e in eps_var.items()}
    log("phase 3 unet, flash variants on the card vs fp32 CPU (bound "
        f"{UNET_TOL:g}): " + ", ".join(f"{n} {r:.4e}" for n, r in rel_var.items())
        + "; vs the default bf16 forward on the card: "
        + ", ".join(f"{n} {rel_l2(e, eps):.4e}" for n, e in eps_var.items()))
    for name, r in (("bf16", rel), ("int8", rel8), ("fused_conv", rel_fused), *rel_var.items()):
        if not (math.isfinite(r) and r <= UNET_TOL and ref.abs().max().item() > 0):
            raise AssertionError(f"{name} UNet on the card disagrees with the CPU: {r}")
    # 10 transformer blocks at 64x64 and 32x32 each launch a flash forward, B2
    # or B5, B3 or B6, in each of the six forwards; the fused_conv one launches
    # B7 besides; each flash variant's forward takes its own kernel
    want = {n: 0 for n in counts}
    want.update(flash_attention_fwd=40, fused_cross_attention=50, geglu_fwd=50,
                fused_cross_attention_int8=10, geglu_int8=10,
                gn_silu_conv3x3_halo=fused_convs_per_pass(),
                flash_attention_fwd_ilv=10, flash_attention_fwd_nomax=10)
    want["flash_attention_fwd:exp2"] = 10
    if counts != want:
        raise AssertionError(f"UNet launches {counts}, expected {want}")


def phase_unet_grad():
    """One full-width UNet forward and backward (64x64 latents, 1 row, an
    img_mask dropping ~30% of the pixels, loss = sum(eps * g) for a fixed g)
    on the card in bf16, with the default flash kernels and under
    FlashVariant(exp2=True) (the exp2 forms of forward and backward), against
    the same weights on the CPU in fp32: the gradient with respect to the
    context."""
    import torch
    from adaprompt_tpu_torch.models.unet import UNet
    from adaprompt_tpu_torch.ops.attention import FlashVariant
    from adaprompt_tpu_torch.ops.layers import randomize_zero_init, reset_parameters
    gen = torch.Generator(device="cuda").manual_seed(3)
    unet = reset_parameters(UNet(device="cuda", dtype=torch.bfloat16), gen)
    randomize_zero_init(unet, gen)
    bf = torch.bfloat16
    x = torch.randn(1, 64, 64, 4, device="cuda", generator=gen).to(bf)
    ctx = torch.randn(1, 77, 768, device="cuda", generator=gen).to(bf)
    mask = (torch.rand(1, 64, 64, 1, device="cuda", generator=gen) >= 0.3).float()
    g = torch.randn(1, 64, 64, 4, device="cuda", generator=gen)
    ts = torch.tensor([601], device="cuda")

    def context_grad(model, dev, dt, cfg=None):
        c = ctx.to(dev, torch.float32).requires_grad_(True)
        eps = model(x.to(dev, dt), ts.to(dev), c.to(dt)[None], img_mask=mask.to(dev), cfg=cfg)
        (eps.float() * g.to(dev)).sum().backward()
        return c.grad.float().cpu()

    before = read_counts()
    t0 = time.perf_counter()
    card = context_grad(unet, "cuda", bf)
    card_s = time.perf_counter() - t0
    card_exp2 = context_grad(unet, "cuda", bf, dataclasses.replace(
        unet.cfg, flash_variant=FlashVariant(exp2=True)))
    counts = counts_since(before)
    cpu = UNet(device="cpu", dtype=torch.float32)
    cpu.load_state_dict({k: v.float().cpu() for k, v in unet.state_dict().items()})
    del unet
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = context_grad(cpu, "cpu", torch.float32)
    cpu_s = time.perf_counter() - t0
    rel = ((card - ref).norm() / ref.norm()).item()
    rel_exp2 = ((card_exp2 - ref).norm() / ref.norm()).item()
    log(f"phase 4 unet grad: d(loss)/d(context) bf16 card vs fp32 CPU relative L2 error "
        f"{rel:.4e}, under exp2 {rel_exp2:.4e} (bound {UNET_GRAD_TOL:g}); exp2 vs default on "
        f"the card {((card_exp2 - card).norm() / card.norm()).item():.4e}; "
        f"|grad| max {ref.abs().max().item():.3e}; "
        f"card {card_s:.2f} s (first call), CPU {cpu_s:.1f} s; launches {nz(counts)}")
    for r in (rel, rel_exp2):
        if not (math.isfinite(r) and r <= UNET_GRAD_TOL and ref.abs().max().item() > 0):
            raise AssertionError(f"UNet gradient on the card disagrees with the CPU: {r}")
    # per gradient: forward, its recompute under block checkpointing, and one
    # backward; the second gradient takes the exp2 forms throughout
    want = {n: 0 for n in counts}
    want.update(flash_attention_fwd=40, flash_attention_bwd=2 * FLASH_BWD_PER_PASS, geglu_fwd=40)
    want["flash_attention_fwd:exp2"] = 20
    want["flash_attention_bwd:exp2"] = FLASH_BWD_PER_PASS
    if counts != want:
        raise AssertionError(f"UNet gradient launches {counts}, expected {want}")


def phase_generate():
    """The txt2img path through the public entry point, then (phase 9) the
    same pipeline under each flash variant; returns {path: launch counts} of
    the counted DDIM-50 runs."""
    import numpy as np
    import torch
    from adaprompt_tpu_torch.ops.layers import randomize_zero_init
    from adaprompt_tpu_torch.pipeline import StableDiffusionPipeline
    steps = 50
    t0 = time.perf_counter()
    pipe = StableDiffusionPipeline.random_init(0, device="cuda", dtype=torch.bfloat16)
    randomize_zero_init(pipe.unet, torch.Generator(device="cuda").manual_seed(2))
    torch.cuda.synchronize()
    log(f"phase 5 random_init: {time.perf_counter() - t0:.1f} s")
    pipe.generate(PROMPTS, num_steps=2, height=512, width=512, seed=1)   # warm-up
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    imgs = pipe.generate(PROMPTS, num_steps=steps, height=512, width=512, seed=0)
    seconds = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"phase 5 generate: {len(PROMPTS)} prompts 512x512 DDIM-{steps} bf16 in {seconds:.3f} s "
        f"-> {len(PROMPTS) / seconds:.4f} img/s; peak memory {peak:.2f} GiB; "
        f"image std {imgs.std():.2f}; launches {nz(launches)}")
    if imgs.shape != (len(PROMPTS), 512, 512, 3) or imgs.dtype != np.uint8 or not imgs.std() > 0:
        raise AssertionError(f"bad images: {imgs.shape} {imgs.dtype} std {imgs.std()}")
    want = {n: 0 for n in launches}            # no gradient, no int8, no fused_conv
    want.update(flash_attention_fwd=10 * steps, fused_cross_attention=10 * steps,
                geglu_fwd=10 * steps)
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    by_path = {"generate": launches}
    by_path.update(phase_generate_variants(pipe, imgs))
    del pipe
    torch.cuda.empty_cache()
    return by_path


VARIANT_TURNS = ("default", "ilv", "nomax", "exp2")


def phase_generate_variants(pipe, default_imgs):
    """Phase 9, txt2img: DDIM-50 generates of the 2 prompts through the same
    pipeline with UNetConfig.flash_variant set in turns (default, ilv, nomax,
    exp2, then the same again); img/s and peak memory of each, exact launch
    counts (500 of the selected forward kernel, 0 of the other two; under
    exp2 all 500 in the exp2 form), and the images' distance from the
    default's (same seed; logged, unbounded). Returns {path: counts} of each
    variant's first turn."""
    import numpy as np
    import torch
    from adaprompt_tpu_torch.ops.attention import FlashVariant
    steps = 50
    base_cfg = pipe.unet_cfg
    cfgs = {name: dataclasses.replace(base_cfg, flash_variant=FlashVariant(
        **({} if name == "default" else {name: True}))) for name in VARIANT_TURNS}
    for name in VARIANT_TURNS[1:]:                                        # warm-up
        pipe.unet_cfg = cfgs[name]
        pipe.generate(PROMPTS, num_steps=2, height=512, width=512, seed=1)
    by_path, rates = {}, {name: [] for name in VARIANT_TURNS}
    for name in VARIANT_TURNS * 2:
        pipe.unet_cfg = cfgs[name]
        zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        imgs = pipe.generate(PROMPTS, num_steps=steps, height=512, width=512, seed=0)
        seconds = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rates[name].append(len(PROMPTS) / seconds)
        diff = np.abs(imgs.astype(np.int32) - default_imgs.astype(np.int32))
        log(f"phase 9 generate[{name}]: {len(PROMPTS)} prompts 512x512 DDIM-{steps} bf16 in "
            f"{seconds:.3f} s -> {rates[name][-1]:.4f} img/s; peak memory {peak:.2f} GiB; image "
            f"std {imgs.std():.2f}; vs the default's images mean |diff| {diff.mean():.3f} levels, "
            f"max {diff.max()}; launches {nz(counts)}")
        if (imgs.shape != (len(PROMPTS), 512, 512, 3) or imgs.dtype != np.uint8
                or not imgs.std() > 0):
            raise AssertionError(f"bad images: {imgs.shape} {imgs.dtype} std {imgs.std()}")
        fwd = {"default": "flash_attention_fwd", "exp2": "flash_attention_fwd",
               "ilv": "flash_attention_fwd_ilv", "nomax": "flash_attention_fwd_nomax"}[name]
        want = {n: 0 for n in counts}
        want.update({fwd: 10 * steps, "fused_cross_attention": 10 * steps,
                     "geglu_fwd": 10 * steps})
        if name == "exp2":
            want[fwd + ":exp2"] = 10 * steps
        if counts != want:
            raise AssertionError(f"generate[{name}] launches {counts}, expected {want}")
        by_path.setdefault("generate_" + name, counts)
    pipe.unet_cfg = base_cfg
    log("phase 9 img/s in turns: " + ", ".join(f"{n} {r}" for n, r in rates.items()))
    return by_path


def phase_train():
    """Stage-1 training through AdaPromptTrainer.train_step at full width
    (random weights from a seed, every zero-init layer randomized, a
    separate teacher UNet); returns the launch counts of the counted steps."""
    import tempfile
    import torch
    from adaprompt_tpu_torch.train.trainer import (AdaPromptTrainer, TrainerConfig,
                                                   synthetic_raw_batches)
    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    cfg = TrainerConfig(seed=0, out_dir=tmp.name)
    tr = AdaPromptTrainer.random_init(4, synthetic_raw_batches(0), cfg, device="cuda")
    sbg = tr.state.params["subj_basis"]
    torch.cuda.synchronize()
    log(f"phase 6 trainer: built in {time.perf_counter() - t0:.1f} s; "
        f"{sum(p.numel() for p in sbg.parameters()) / 1e6:.1f} M trainable parameters")
    watched = {n: p.detach().clone() for n, p in sbg.named_parameters()
               if n in ("hidden_state_layer_weights", "prompt2token_proj.layers.11.mlp.fc2.weight",
                        "prompt2token_proj.token_embedding")}
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    rows, times = [], []
    for i in range(TRAIN_STEPS):
        t1 = time.perf_counter()
        m = tr.train_step(i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        rows.append({k: (float(v) if isinstance(v, torch.Tensor) else v) for k, v in m.items()})
        if i == cfg.grad_accum - 1:       # the first accumulated update
            moved = {n: not torch.equal(p, dict(sbg.named_parameters())[n])
                     for n, p in watched.items()}
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for r, s in zip(rows, times):
        log(f"phase 6 step {r['step']}: ND={r['num_denoising_steps']} bs={r['distill_bs']} "
            f"loss={r['loss_arc2face_distill']:.6f} grad_norm={r['grad_norm']:.6e} {s:.3f} s")
    students = [min(r["num_denoising_steps"], max(7 // r["distill_bs"], 1)) for r in rows]
    teachers = [r["num_denoising_steps"] for r in rows]
    log(f"phase 6 train: {TRAIN_STEPS} steps bs 4 512x512 bf16 in {sum(times):.3f} s "
        f"(step times {[round(s, 3) for s in times]}); peak memory {peak:.2f} GiB; "
        f"SBG moved after the first update: {moved}; launches {nz(launches)}")
    nds = set(teachers)
    if not (1 in nds and max(nds) > 1):
        raise AssertionError(f"the steps drew ND {teachers}; need ND=1 and ND>1")
    for r in rows:
        if not (math.isfinite(r["loss_arc2face_distill"]) and math.isfinite(r["grad_norm"])
                and r["grad_norm"] > 0):
            raise AssertionError(f"bad training metrics {r}")
    if not all(moved.values()):
        raise AssertionError(f"SubjBasisGenerator parameters did not move: {moved}")
    # student passes: forward + its recompute; teacher passes: forward only
    fwd = 10 * (sum(teachers) + 2 * sum(students))
    want = {n: 0 for n in launches}
    want.update(flash_attention_fwd=fwd, flash_attention_bwd=FLASH_BWD_PER_PASS * sum(students),
                geglu_fwd=fwd)
    if launches != want:
        raise AssertionError(f"training launches {launches}, expected {want}")
    by_path = {"train": launches}
    by_path.update(phase_train_variants(tr, TRAIN_STEPS))
    tr._flush_metrics()
    tmp.cleanup()
    return by_path


def phase_train_variants(tr, first_step):
    """Phase 9, training: the same trainer with ND fixed at 1, two steps (one
    accumulating, one applying the update) with the default flash kernels and
    two under FlashVariant(exp2=True), in turns (default, exp2, exp2,
    default): s/step of each, finite losses, and launch counts: under exp2
    the forward and the backward launch as often as by default, every launch
    in the exp2 form. Returns {path: counts} of each first turn."""
    import torch
    from adaprompt_tpu_torch.ops.attention import FlashVariant
    tr.cfg = dataclasses.replace(tr.cfg, max_num_denoising_steps=1)       # ND = 1 in every step
    unets = (tr.frozen.unet, tr.frozen.teacher_unet)
    base_cfg = unets[0].cfg
    cfgs = {"default": base_cfg,
            "exp2": dataclasses.replace(base_cfg, flash_variant=FlashVariant(exp2=True))}
    by_path, times, step = {}, {"default": [], "exp2": []}, first_step
    for name in ("default", "exp2", "exp2", "default"):
        for u in unets:
            u.cfg = cfgs[name]
        zero_counts()
        pair = []
        for _ in range(2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            m = tr.train_step(step)
            torch.cuda.synchronize()
            pair.append(time.perf_counter() - t1)
            step += 1
            loss, norm = float(m["loss_arc2face_distill"]), float(m["grad_norm"])
            if not (m["num_denoising_steps"] == 1 and math.isfinite(loss)
                    and math.isfinite(norm) and norm > 0):
                raise AssertionError(f"bad training metrics under {name}: {m}")
        counts = read_counts()
        times[name].append(pair)
        log(f"phase 9 train[{name}]: 2 steps ND=1 bs 4 in {[round(s, 3) for s in pair]} s; "
            f"loss {loss:.6f} grad_norm {norm:.6e}; launches {nz(counts)}")
        # per step: a teacher pass, a student pass and its recompute; one backward
        want = {n: 0 for n in counts}
        want.update(flash_attention_fwd=2 * 30, flash_attention_bwd=2 * FLASH_BWD_PER_PASS,
                    geglu_fwd=2 * 30)
        if name == "exp2":
            want["flash_attention_fwd:exp2"] = want["flash_attention_fwd"]
            want["flash_attention_bwd:exp2"] = want["flash_attention_bwd"]
        if counts != want:
            raise AssertionError(f"train[{name}] launches {counts}, expected {want}")
        by_path.setdefault("train_" + name, counts)
    for u in unets:
        u.cfg = base_cfg
    log(f"phase 9 s/step in turns: default {times['default']}, exp2 {times['exp2']}")
    return by_path


def serve_launches(fast, steps):
    """Each kernel's launches in one served generate: a full UNet pass
    launches it in the 10 transformer blocks at 64x64 and 32x32, a shallow
    pass (DeepCache depth 3) in the 5 at 64x64; the CFG steps and the tail
    each open with a full pass, then one every cache_interval steps."""
    n_cfg = round(steps * (1 - fast.cfg_tail_frac))
    full = sum(-(-n // fast.cache_interval) for n in (n_cfg, steps - n_cfg))
    return 10 * full + 5 * (steps - full)


def phase_serve():
    """The composed serving stack through the public entry point: dpmpp-20
    with FastConfig() at 512x512, with quant="int8" and in bf16 on the same
    random weights, timed in turns (int8, bf16, bf16, int8); returns each
    preset's launch counts (every counted run is checked)."""
    import numpy as np
    import torch
    from adaprompt_tpu_torch.ops.layers import randomize_zero_init
    from adaprompt_tpu_torch.pipeline import FastConfig, StableDiffusionPipeline
    fast = FastConfig()
    pipe8 = StableDiffusionPipeline.random_init(0, device="cuda", dtype=torch.bfloat16,
                                                quant="int8")
    randomize_zero_init(pipe8.unet, torch.Generator(device="cuda").manual_seed(2))
    pipe16 = StableDiffusionPipeline(pipe8.unet, pipe8.vae, pipe8.text, pipe8.tokenizer)
    per_kernel = serve_launches(fast, SERVE_STEPS)
    kw = dict(num_steps=SERVE_STEPS, height=512, width=512, sampler="dpmpp", fast=fast)
    presets = {"serve_int8": (pipe8, ("flash_attention_fwd", "fused_cross_attention_int8",
                                      "geglu_int8")),
               "serve_bf16": (pipe16, ("flash_attention_fwd", "fused_cross_attention",
                                       "geglu_fwd"))}
    for pipe, _ in presets.values():
        pipe.generate(PROMPTS, **dict(kw, num_steps=4), seed=1)            # warm-up
    launches, rates = {}, {p: [] for p in presets}
    for path in ("serve_int8", "serve_bf16", "serve_bf16", "serve_int8"):   # in turns
        pipe, kernels = presets[path]
        zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        imgs = pipe.generate(PROMPTS, **kw, seed=0)
        seconds = time.perf_counter() - t0
        launches[path] = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rates[path].append(len(PROMPTS) / seconds)
        log(f"phase 7 {path}: {len(PROMPTS)} prompts 512x512 dpmpp-{SERVE_STEPS} FastConfig() "
            f"bf16 in {seconds:.3f} s -> {rates[path][-1]:.4f} img/s; peak memory "
            f"{peak:.2f} GiB; image std {imgs.std():.2f}; launches {nz(launches[path])}")
        if (imgs.shape != (len(PROMPTS), 512, 512, 3) or imgs.dtype != np.uint8
                or not imgs.std() > 0):
            raise AssertionError(f"bad images: {imgs.shape} {imgs.dtype} std {imgs.std()}")
        want = {n: (per_kernel if n in kernels else 0) for n in launches[path]}
        if launches[path] != want:
            raise AssertionError(f"{path} launches {launches[path]}, expected {want}")
    z8, z16 = (torch.from_numpy(presets[p][0].generate(PROMPTS, **kw, seed=0, return_latents=True))
               for p in presets)
    log(f"phase 7 img/s in turns: int8 {rates['serve_int8']}, bf16 {rates['serve_bf16']}; "
        f"int8 vs bf16 latents, same seed: relative L2 {((z8 - z16).norm() / z16.norm()).item():.4e}")
    return launches


def phase_personalize():
    """The product path through its entry points: AdaFacePipeline at full
    width with random weights (the SD pipeline with fused_conv, a separate
    Arc2Face CLIP-L, the SubjBasisGenerator, IResNet-100 behind the
    centre-crop embedder), three seeded 512x512 photos ->
    generate_adaface_embeddings -> __call__ (DDIM-50, 2 images, UNet batch
    4). fused_conv on and off share every weight and are timed in turns (on,
    off, off, on); returns the launch counts of the first run of each."""
    import numpy as np
    import torch
    from adaprompt_tpu_torch.adaface.wrapper import AdaFacePipeline
    from adaprompt_tpu_torch.models.unet import UNetConfig
    from adaprompt_tpu_torch.ops.layers import randomize_zero_init
    from adaprompt_tpu_torch.pipeline import StableDiffusionPipeline
    steps = 50
    t0 = time.perf_counter()
    ada = AdaFacePipeline.random_init(0, unet_cfg=UNetConfig(fused_conv=True))
    pipe = ada.pipe
    randomize_zero_init(pipe.unet, torch.Generator(device="cuda").manual_seed(2))
    plain_pipe = StableDiffusionPipeline(pipe.unet, pipe.vae, pipe.text, pipe.tokenizer)
    plain_pipe.unet_cfg = dataclasses.replace(pipe.unet_cfg, fused_conv=False)
    ada_off = AdaFacePipeline(plain_pipe, ada.subj_basis, ada.subj_basis_cfg, ada.arc2face_text,
                              ada.arc2face_text_cfg, face_embedder=ada.face_embedder)
    torch.cuda.synchronize()
    n_arc = sum(p.numel() for p in ada.face_embedder.arcface.parameters()) / 1e6
    log(f"phase 8 random_init: {time.perf_counter() - t0:.1f} s (ArcFace IResNet-100 {n_arc:.1f} M "
        f"parameters); fused_conv {pipe.unet_cfg.fused_conv} / {plain_pipe.unet_cfg.fused_conv}")
    rng = np.random.default_rng(0)
    subjects = [[rng.integers(0, 256, (512, 512, 3)).astype(np.uint8) for _ in range(3)]
                for _ in range(PERSONAL_SUBJECTS + 1)]
    for a in (ada, ada_off):                                   # build + warm up
        a.generate_adaface_embeddings(images_np=subjects[-1], seed=1)
        a(PERSONAL_PROMPT, out_image_count=PERSONAL_IMAGES, num_steps=2, seed=1)

    # personalization latency: photos in -> cond/uncond ready to generate
    lat = []
    for s, photos in enumerate(subjects[:PERSONAL_SUBJECTS]):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ada.generate_adaface_embeddings(images_np=photos, seed=s)
        cond, uncond = ada.encode_prompt(PERSONAL_PROMPT)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t1) * 1e3)
    log(f"phase 8 personalization latency (3 photos 512x512 -> ArcFace -> Arc2Face -> "
        f"SubjBasisGenerator -> token table -> cond/uncond), {PERSONAL_SUBJECTS} subjects: "
        f"p50 {float(np.percentile(lat, 50)):.3f} ms, min {min(lat):.3f}, max {max(lat):.3f}")

    per_pass = fused_convs_per_pass()
    launches, rates, images = {}, {"personalize": [], "personalize_unfused": []}, {}
    for path in ("personalize", "personalize_unfused", "personalize_unfused", "personalize"):
        a = ada if path == "personalize" else ada_off
        zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        embs = a.generate_adaface_embeddings(images_np=subjects[0], seed=0)
        imgs = a(PERSONAL_PROMPT, out_image_count=PERSONAL_IMAGES, num_steps=steps, seed=0)
        seconds = time.perf_counter() - t1
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rates[path].append(PERSONAL_IMAGES / seconds)
        log(f"phase 8 {path}: 3 photos -> {PERSONAL_IMAGES} images 512x512 DDIM-{steps} bf16 in "
            f"{seconds:.3f} s -> {rates[path][-1]:.4f} img/s; peak memory {peak:.2f} GiB; "
            f"image std {imgs.std():.2f}; launches {nz(counts)}")
        rows = pipe.text.token_embedding[ada.placeholder_token_ids]
        if not (tuple(embs.shape) == (16, 768) and bool(torch.isfinite(embs).all())
                and torch.equal(rows, embs.to(rows.dtype)) and float(embs.std()) > 0):
            raise AssertionError(f"bad subject vectors {tuple(embs.shape)}, or not in the table")
        if (imgs.shape != (PERSONAL_IMAGES, 512, 512, 3) or imgs.dtype != np.uint8
                or not imgs.std() > 0):
            raise AssertionError(f"bad images: {imgs.shape} {imgs.dtype} std {imgs.std()}")
        want = {n: 0 for n in counts}
        want.update(flash_attention_fwd=10 * steps, fused_cross_attention=10 * steps,
                    geglu_fwd=10 * steps,
                    gn_silu_conv3x3_halo=per_pass * steps if path == "personalize" else 0)
        if counts != want:
            raise AssertionError(f"{path} launches {counts}, expected {want}")
        launches.setdefault(path, counts)
        images.setdefault(path, imgs)
    prompt = ada.update_prompt(PERSONAL_PROMPT)
    if prompt != "portrait of a " + " ".join(f"z_{i}" for i in range(16)) + " person":
        raise AssertionError(f"prompt rewritten to {prompt!r}")
    ids = [int(i) for i in pipe.tokenize([prompt])[0]]
    first = ids.index(ada.placeholder_token_ids[0])
    if ids[first:first + 16] != ada.placeholder_token_ids:
        raise AssertionError(f"the rewritten prompt tokenizes to {ids[:32]}")
    diff = np.abs(images["personalize"].astype(np.int32)
                  - images["personalize_unfused"].astype(np.int32))
    log(f"phase 8 img/s in turns: fused_conv on {rates['personalize']}, off "
        f"{rates['personalize_unfused']}; fused vs unfused images, same seed: mean |diff| "
        f"{diff.mean():.3f} levels, max {diff.max()}")
    return launches


_GEN_TURNS = ("generate_default", "generate_ilv", "generate_nomax", "generate_exp2")
_TRAIN_TURNS = ("train_default", "train_exp2")
KERNELS = {   # wrapper -> (source, TPU kernel it replaces, the paths that launch it)
    "flash_attention_fwd": ("adaprompt_tpu_torch/csrc/flash_attention.cu",
                            "adaprompt_tpu/ops/attention.py:176",
                            ("generate", "train", "serve_int8", "serve_bf16", "personalize",
                             "personalize_unfused", "generate_default", "generate_exp2")
                            + _TRAIN_TURNS),
    "flash_attention_bwd": ("adaprompt_tpu_torch/csrc/flash_attention_bwd.cu",
                            "adaprompt_tpu/ops/attention.py:314", ("train",) + _TRAIN_TURNS),
    "fused_cross_attention": ("adaprompt_tpu_torch/csrc/fused_cross_attention.cu",
                              "adaprompt_tpu/ops/attention.py:610",
                              ("generate", "serve_bf16", "personalize", "personalize_unfused")
                              + _GEN_TURNS),
    "geglu_fwd": ("adaprompt_tpu_torch/csrc/geglu.cu", "adaprompt_tpu/ops/geglu.py:55",
                  ("generate", "train", "serve_bf16", "personalize", "personalize_unfused")
                  + _GEN_TURNS + _TRAIN_TURNS),
    "fused_cross_attention_int8": ("adaprompt_tpu_torch/csrc/fused_cross_attention_int8.cu",
                                   "adaprompt_tpu/ops/attention.py:664", ("serve_int8",)),
    "geglu_int8": ("adaprompt_tpu_torch/csrc/geglu_int8.cu", "adaprompt_tpu/ops/geglu.py:139",
                   ("serve_int8",)),
    "gn_silu_conv3x3_halo": ("adaprompt_tpu_torch/csrc/conv_halo.cu",
                             "adaprompt_tpu/ops/conv_halo.py:208", ("personalize",)),
    # wired into no model, as in the JAX package: launched by phase 2 only
    "conv3x3_halo": ("adaprompt_tpu_torch/csrc/conv_halo.cu",
                     "adaprompt_tpu/ops/conv_halo.py:57", ()),
    "conv3x3_im2col": ("adaprompt_tpu_torch/csrc/conv_halo.cu",
                       "adaprompt_tpu/ops/conv_halo.py:107", ()),
    "flash_attention_int8": ("adaprompt_tpu_torch/csrc/flash_attention_int8.cu",
                             "adaprompt_tpu/ops/attention.py:818", ()),
    "fused_self_attention": ("adaprompt_tpu_torch/csrc/fused_self_attention.cu",
                             "adaprompt_tpu/ops/attention.py:732", ()),
    # on the txt2img path under UNetConfig.flash_variant
    "flash_attention_fwd_ilv": ("adaprompt_tpu_torch/csrc/flash_attention_ilv.cu",
                                "adaprompt_tpu/ops/attention.py:226", ("generate_ilv",)),
    "flash_attention_fwd_nomax": ("adaprompt_tpu_torch/csrc/flash_attention_nomax.cu",
                                  "adaprompt_tpu/ops/attention.py:277", ("generate_nomax",)),
}
# the exp2 forms (FlashVariant.exp2) of the four flash kernels, and the paths
# that must have launched them: rows "exp2_*" of their kernels' entries
EXP2_PATHS = {"flash_attention_fwd": ("generate_exp2", "train_exp2"),
              "flash_attention_bwd": ("train_exp2",),
              "flash_attention_fwd_ilv": (), "flash_attention_fwd_nomax": ()}


def kernels_line(results, launches_by_path):
    """Per kernel, the mean over the timed shapes its paths run (for the
    kernels that no path runs: over their timed phase-2 shapes) of the times
    and bounds measured in phase 2, and its launches on each path's counted
    run; for the four flash kernels also their exp2 form's time over its
    timed shapes and its launches."""
    out = []
    for name, (source, replaces, paths) in KERNELS.items():
        by_path = {p: launches_by_path[p][name] for p in launches_by_path}
        missing = [p for p in paths if by_path[p] == 0]
        if missing:
            raise AssertionError(f"{name} was never launched on the {missing} path")
        timed = [r for r in results[name] if r["timed"]]
        rs = [r for r in timed if r["paths"]] or timed
        mean = lambda key, rows=None: sum(r[key] for r in rows or rs) / len(rows or rs)
        t_ops = sum(r["ops_ms"] for r in rs)
        t_bytes = sum(r["bytes_ms"] for r in rs)
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in results[name]),
            "ms": mean("kernel_ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_ms"),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None if rs[0]["library_ms"] is None else mean("library_ms"),
            "exp_bound_ms": mean("exp_bound_ms"),
        })
        for extra in ("unfused_ms", "affine_ms", "operands_ms", "kv_ms", "kernel_only_ms",
                      "wrapper_ms"):
            if extra in rs[0]:
                out[-1][extra] = mean(extra)
        if name in EXP2_PATHS:
            exp2_by_path = {p: launches_by_path[p][name + ":exp2"] for p in launches_by_path}
            missing = [p for p in EXP2_PATHS[name] if exp2_by_path[p] == 0]
            if missing:
                raise AssertionError(f"{name}'s exp2 form was never launched on {missing}")
            rows = [r for r in results[name + ":exp2"] if r["timed"]]
            rows = [r for r in rows if r["paths"]] or rows
            out[-1].update(exp2_ms=mean("kernel_ms", rows), exp2_plain_ms=mean("plain_ms", rows),
                           exp2_launches=sum(exp2_by_path.values()),
                           exp2_max_abs_err=max(r["max_abs_err"]
                                                for r in results[name + ":exp2"]))
    return {"kernels": out}


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    try:
        import adaprompt_tpu_torch  # noqa: F401
    except ImportError as err:
        print(f"chip_smoke: the port's package is not importable here: {err}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    phase_build()
    results = phase_kernels()
    phase_unet_check()
    phase_unet_grad()
    launches = phase_generate()
    launches.update(phase_train())
    launches.update(phase_serve())
    launches.update(phase_personalize())
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps(kernels_line(results, launches)))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
