#!/usr/bin/env python3
"""Drive the PyTorch port's four paths on one NVIDIA H100: SD-1.5 txt2img,
Stage-1 Arc2Face-distillation training, the composed serving stack
(DPM-Solver++ 20 steps with ToMe, DeepCache and the CFG tail, quant="int8"),
and the product path (AdaFacePipeline: photos -> ArcFace -> 16 subject
tokens -> personalized DDIM-50, with UNetConfig.fused_conv).

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero without the final line):
  1. build the nine CUDA kernels (seven sources, one nvcc each, in
     parallel) from adaprompt_tpu_torch/csrc/;
  2. hold each kernel against its plain PyTorch version on the card, in
     bf16, at the paths' shapes (the two plain 3x3 conv kernels, which no
     path runs, at the JAX tests' shapes and a ragged one), and time
     kernel, plain version and, where one PyTorch call computes the same
     function, that call as the yardstick (F.scaled_dot_product_attention
     for flash attention forward and backward, F.conv2d for the two plain
     convs); beside the fused GroupNorm-SiLU-conv, which no single call
     computes, the port's own unfused pair (group_norm + conv2d);
  3. run one full-width UNet forward on the card in bf16, one with
     quant="int8" and one with fused_conv, and the same weights on the CPU
     in fp32 (the int8 one through the int8 kernels' plain versions), and
     bound the relative errors; log the int8 forward's distance from the
     bf16 one;
  4. run one full-width UNet forward and backward with a masked image (the
     training path: flash backward, GEGLU backward, block recompute) on the
     card in bf16 and on the CPU in fp32, and bound the relative error of
     the gradient with respect to the context;
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
  9. print the kernels' JSON line, the card's name and power limit, and
     the final {"ok": true, "device": ...} line.

Needs a CUDA card; imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

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


def _case_flash(gen, s, d, with_bias):
    import torch
    import torch.nn.functional as F
    from adaprompt_tpu_torch.ops import attention as A
    b, h = UNET_BATCH, 8
    mk = lambda: torch.randn(b, s, h, d, device="cuda", generator=gen).to(torch.bfloat16)
    q, k, v = mk(), mk(), mk()
    bias = None
    if with_bias:
        keep = torch.rand(b, s, device="cuda", generator=gen) < 0.7
        bias = (keep.float() - 1.0) * (-A.NEG_BIG)
    scale = d ** -0.5
    out, lse = A.flash_attention_fwd(q, k, v, bias, scale)
    ref, lse_ref = A.attention_reference(q, k, v, bias, scale)
    err, mag, ok = _compare(out, ref, 2e-2)
    lse_err = (lse - lse_ref).abs().max().item()
    ok = ok and lse_err <= 1e-2
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None if bias is None else bias[:, None, None, :].to(torch.bfloat16)
    res = {
        "kernel_ms": time_ms(lambda: A.flash_attention_fwd(q, k, v, bias, scale), 10),
        "plain_ms": time_ms(lambda: A.attention_reference(q, k, v, bias, scale), 3),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=scale), 10),
    }
    flops = 4 * b * h * s * s * d
    nbytes = 4 * b * s * h * d * 2 + b * h * s * 4 + (b * s * 4 if with_bias else 0)
    res.update(_bound(flops, nbytes, exps=b * h * s * s))
    detail = f"lse_err={lse_err:.2e} (tol 1e-2)"
    return f"flash_attention_fwd D={d} S={s} bias={with_bias}", err, mag, 2e-2, ok, res, detail


def _case_flash_bwd(gen, s, d, with_bias):
    import torch
    import torch.nn.functional as F
    from adaprompt_tpu_torch.ops import attention as A
    b, h = UNET_BATCH, 8
    mk = lambda: torch.randn(b, s, h, d, device="cuda", generator=gen).to(torch.bfloat16)
    q, k, v, dout = mk(), mk(), mk(), mk()
    bias = None
    if with_bias:
        keep = torch.rand(b, s, device="cuda", generator=gen) < 0.7
        bias = (keep.float() - 1.0) * (-A.NEG_BIG)
    scale = d ** -0.5
    out, lse = A.flash_attention_fwd(q, k, v, bias, scale)
    args = (q, k, v, bias, out, lse, dout, scale)
    got = A.flash_attention_bwd(*args)
    ref = A.flash_attention_bwd_reference(*args)
    cmp = [_compare(x, y, FLASH_BWD_TOL) for x, y in zip(got, ref)]
    err = max(c[0] for c in cmp)
    mag = max(c[1] for c in cmp)
    ok = all(c[2] for c in cmp)
    del got, ref
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    mask = None if bias is None else bias[:, None, None, :].to(torch.bfloat16)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale)
    gt = dout.transpose(1, 2)
    sdpa_fwd_ms = time_ms(sdpa, 10)
    sdpa_both_ms = time_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), gt), 10)
    res = {"kernel_ms": time_ms(lambda: A.flash_attention_bwd(*args), 10),
           "plain_ms": time_ms(lambda: A.flash_attention_bwd_reference(*args), 2),
           "library_ms": sdpa_both_ms - sdpa_fwd_ms}
    # 5 S^2 D products of 2 flops; each input (q, k, v, out, dout, lse, bias)
    # read once and dq, dk, dv written once; one exponential per score
    flops = 10 * b * h * s * s * d
    nbytes = 8 * b * s * h * d * 2 + b * h * s * 4 + (b * s * 4 if with_bias else 0)
    res.update(_bound(flops, nbytes, exps=b * h * s * s))
    detail = " ".join(f"{n}={c[0] / c[1]:.2e}" for n, c in zip(("dq", "dk", "dv"), cmp))
    return (f"flash_attention_bwd D={d} S={s} bias={with_bias}", err, mag, FLASH_BWD_TOL, ok,
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


def phase_kernels():
    """Returns {wrapper name: [per-shape results]} for the kernels line."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
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
    results, failed = {}, []
    for name, paths, case in cases:
        label, err, mag, tol, ok, res, detail = case()
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
    bf16, one with quant="int8" (B5 and B6) and one with fused_conv (B7),
    each against the same weights on the CPU in fp32 (the int8 one through
    the kernels' plain versions; in fp32 no conv is eligible for fusion, so
    the fused_conv forward is held to the plain fp32 one)."""
    import dataclasses
    import torch
    from adaprompt_tpu_torch.models.unet import UNet
    from adaprompt_tpu_torch.ops import kernel_wrappers
    from adaprompt_tpu_torch.ops.layers import randomize_zero_init, reset_parameters
    gen = torch.Generator(device="cuda").manual_seed(1)
    unet = reset_parameters(UNet(device="cuda", dtype=torch.bfloat16), gen)
    randomize_zero_init(unet, gen)
    int8 = dataclasses.replace(unet.cfg, quant="int8")
    fused = dataclasses.replace(unet.cfg, fused_conv=True)
    x = torch.randn(2, 64, 64, 4, device="cuda", generator=gen).to(torch.bfloat16)
    ctx = torch.randn(1, 2, 77, 768, device="cuda", generator=gen).to(torch.bfloat16)
    ts = torch.tensor([981, 501], device="cuda")
    wrappers = kernel_wrappers()
    before = {n: w.launches for n, w in wrappers.items()}
    t0 = time.perf_counter()
    with torch.inference_mode():
        kv = unet.precompute_cross_kv(ctx)
        eps = unet(x, ts, ctx, cross_kv=kv).float().cpu()
        eps8 = unet(x, ts, ctx, cross_kv=kv, cfg=int8).float().cpu()
        eps_fused = unet(x, ts, ctx, cross_kv=kv, cfg=fused).float().cpu()
    card_s = time.perf_counter() - t0
    counts = {n: w.launches - before[n] for n, w in wrappers.items()}
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
        f"CPU {cpu_s:.1f} s; launches {counts}")
    for name, r in (("bf16", rel), ("int8", rel8), ("fused_conv", rel_fused)):
        if not (math.isfinite(r) and r <= UNET_TOL and ref.abs().max().item() > 0):
            raise AssertionError(f"{name} UNet on the card disagrees with the CPU: {r}")
    # 10 transformer blocks at 64x64 and 32x32 each launch B1, B2 or B5, B3 or
    # B6, in each of the three forwards; the fused_conv one launches B7 besides
    want = {n: 0 for n in counts}
    want.update(flash_attention_fwd=30, fused_cross_attention=20, geglu_fwd=20,
                fused_cross_attention_int8=10, geglu_int8=10,
                gn_silu_conv3x3_halo=fused_convs_per_pass())
    if counts != want:
        raise AssertionError(f"UNet launches {counts}, expected {want}")


def phase_unet_grad():
    """One full-width UNet forward and backward (64x64 latents, 1 row, an
    img_mask dropping ~30% of the pixels, loss = sum(eps * g) for a fixed g)
    on the card in bf16 against the same weights on the CPU in fp32: the
    gradient with respect to the context."""
    import torch
    from adaprompt_tpu_torch.models.unet import UNet
    from adaprompt_tpu_torch.ops import kernel_wrappers
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

    def context_grad(model, dev, dt):
        c = ctx.to(dev, torch.float32).requires_grad_(True)
        eps = model(x.to(dev, dt), ts.to(dev), c.to(dt)[None], img_mask=mask.to(dev))
        (eps.float() * g.to(dev)).sum().backward()
        return c.grad.float().cpu()

    wrappers = kernel_wrappers()
    before = {n: w.launches for n, w in wrappers.items()}
    t0 = time.perf_counter()
    card = context_grad(unet, "cuda", bf)
    card_s = time.perf_counter() - t0
    counts = {n: w.launches - before[n] for n, w in wrappers.items()}
    cpu = UNet(device="cpu", dtype=torch.float32)
    cpu.load_state_dict({k: v.float().cpu() for k, v in unet.state_dict().items()})
    del unet
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = context_grad(cpu, "cpu", torch.float32)
    cpu_s = time.perf_counter() - t0
    rel = ((card - ref).norm() / ref.norm()).item()
    log(f"phase 4 unet grad: d(loss)/d(context) bf16 card vs fp32 CPU relative L2 error "
        f"{rel:.4e} (bound {UNET_GRAD_TOL:g}); |grad| max {ref.abs().max().item():.3e}; "
        f"card {card_s:.2f} s (first call), CPU {cpu_s:.1f} s; launches {counts}")
    if not (math.isfinite(rel) and rel <= UNET_GRAD_TOL and ref.abs().max().item() > 0):
        raise AssertionError(f"UNet gradient on the card disagrees with the CPU: {rel}")
    # forward, its recompute under block checkpointing, and one backward
    want = {n: 0 for n in counts}
    want.update(flash_attention_fwd=20, flash_attention_bwd=FLASH_BWD_PER_PASS, geglu_fwd=20)
    if counts != want:
        raise AssertionError(f"UNet gradient launches {counts}, expected {want}")


def phase_generate():
    """The txt2img path through the public entry point; returns the launch
    counts of the counted DDIM-50 run."""
    import numpy as np
    import torch
    from adaprompt_tpu_torch.ops import kernel_wrappers
    from adaprompt_tpu_torch.ops.layers import randomize_zero_init
    from adaprompt_tpu_torch.pipeline import StableDiffusionPipeline
    steps = 50
    t0 = time.perf_counter()
    pipe = StableDiffusionPipeline.random_init(0, device="cuda", dtype=torch.bfloat16)
    randomize_zero_init(pipe.unet, torch.Generator(device="cuda").manual_seed(2))
    torch.cuda.synchronize()
    log(f"phase 5 random_init: {time.perf_counter() - t0:.1f} s")
    pipe.generate(PROMPTS, num_steps=2, height=512, width=512, seed=1)   # warm-up
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    imgs = pipe.generate(PROMPTS, num_steps=steps, height=512, width=512, seed=0)
    seconds = time.perf_counter() - t0
    launches = {n: w.launches for n, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"phase 5 generate: {len(PROMPTS)} prompts 512x512 DDIM-{steps} bf16 in {seconds:.3f} s "
        f"-> {len(PROMPTS) / seconds:.4f} img/s; peak memory {peak:.2f} GiB; "
        f"image std {imgs.std():.2f}; launches {launches}")
    if imgs.shape != (len(PROMPTS), 512, 512, 3) or imgs.dtype != np.uint8 or not imgs.std() > 0:
        raise AssertionError(f"bad images: {imgs.shape} {imgs.dtype} std {imgs.std()}")
    want = {n: 0 for n in launches}            # no gradient, no int8, no fused_conv
    want.update(flash_attention_fwd=10 * steps, fused_cross_attention=10 * steps,
                geglu_fwd=10 * steps)
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    del pipe
    torch.cuda.empty_cache()
    return launches


def phase_train():
    """Stage-1 training through AdaPromptTrainer.train_step at full width
    (random weights from a seed, every zero-init layer randomized, a
    separate teacher UNet); returns the launch counts of the counted steps."""
    import tempfile
    import torch
    from adaprompt_tpu_torch.ops import kernel_wrappers
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
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
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
    launches = {n: w.launches for n, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tr._flush_metrics()
    tmp.cleanup()
    for r, s in zip(rows, times):
        log(f"phase 6 step {r['step']}: ND={r['num_denoising_steps']} bs={r['distill_bs']} "
            f"loss={r['loss_arc2face_distill']:.6f} grad_norm={r['grad_norm']:.6e} {s:.3f} s")
    students = [min(r["num_denoising_steps"], max(7 // r["distill_bs"], 1)) for r in rows]
    teachers = [r["num_denoising_steps"] for r in rows]
    log(f"phase 6 train: {TRAIN_STEPS} steps bs 4 512x512 bf16 in {sum(times):.3f} s "
        f"(step times {[round(s, 3) for s in times]}); peak memory {peak:.2f} GiB; "
        f"SBG moved after the first update: {moved}; launches {launches}")
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
    return launches


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
    from adaprompt_tpu_torch.ops import kernel_wrappers
    from adaprompt_tpu_torch.ops.layers import randomize_zero_init
    from adaprompt_tpu_torch.pipeline import FastConfig, StableDiffusionPipeline
    fast = FastConfig()
    pipe8 = StableDiffusionPipeline.random_init(0, device="cuda", dtype=torch.bfloat16,
                                                quant="int8")
    randomize_zero_init(pipe8.unet, torch.Generator(device="cuda").manual_seed(2))
    pipe16 = StableDiffusionPipeline(pipe8.unet, pipe8.vae, pipe8.text, pipe8.tokenizer)
    per_kernel = serve_launches(fast, SERVE_STEPS)
    wrappers = kernel_wrappers()
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
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        imgs = pipe.generate(PROMPTS, **kw, seed=0)
        seconds = time.perf_counter() - t0
        launches[path] = {n: w.launches for n, w in wrappers.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rates[path].append(len(PROMPTS) / seconds)
        log(f"phase 7 {path}: {len(PROMPTS)} prompts 512x512 dpmpp-{SERVE_STEPS} FastConfig() "
            f"bf16 in {seconds:.3f} s -> {rates[path][-1]:.4f} img/s; peak memory "
            f"{peak:.2f} GiB; image std {imgs.std():.2f}; launches {launches[path]}")
        if (imgs.shape != (len(PROMPTS), 512, 512, 3) or imgs.dtype != np.uint8
                or not imgs.std() > 0):
            raise AssertionError(f"bad images: {imgs.shape} {imgs.dtype} std {imgs.std()}")
        want = {n: (per_kernel if n in kernels else 0) for n in wrappers}
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
    import dataclasses
    import numpy as np
    import torch
    from adaprompt_tpu_torch.adaface.wrapper import AdaFacePipeline
    from adaprompt_tpu_torch.models.unet import UNetConfig
    from adaprompt_tpu_torch.ops import kernel_wrappers
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

    wrappers = kernel_wrappers()
    per_pass = fused_convs_per_pass()
    launches, rates, images = {}, {"personalize": [], "personalize_unfused": []}, {}
    for path in ("personalize", "personalize_unfused", "personalize_unfused", "personalize"):
        a = ada if path == "personalize" else ada_off
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        embs = a.generate_adaface_embeddings(images_np=subjects[0], seed=0)
        imgs = a(PERSONAL_PROMPT, out_image_count=PERSONAL_IMAGES, num_steps=steps, seed=0)
        seconds = time.perf_counter() - t1
        counts = {n: w.launches for n, w in wrappers.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rates[path].append(PERSONAL_IMAGES / seconds)
        log(f"phase 8 {path}: 3 photos -> {PERSONAL_IMAGES} images 512x512 DDIM-{steps} bf16 in "
            f"{seconds:.3f} s -> {rates[path][-1]:.4f} img/s; peak memory {peak:.2f} GiB; "
            f"image std {imgs.std():.2f}; launches {counts}")
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


KERNELS = {   # wrapper -> (source, TPU kernel it replaces, the paths that launch it)
    "flash_attention_fwd": ("adaprompt_tpu_torch/csrc/flash_attention.cu",
                            "adaprompt_tpu/ops/attention.py:176",
                            ("generate", "train", "serve_int8", "serve_bf16", "personalize",
                             "personalize_unfused")),
    "flash_attention_bwd": ("adaprompt_tpu_torch/csrc/flash_attention_bwd.cu",
                            "adaprompt_tpu/ops/attention.py:314", ("train",)),
    "fused_cross_attention": ("adaprompt_tpu_torch/csrc/fused_cross_attention.cu",
                              "adaprompt_tpu/ops/attention.py:610",
                              ("generate", "serve_bf16", "personalize", "personalize_unfused")),
    "geglu_fwd": ("adaprompt_tpu_torch/csrc/geglu.cu", "adaprompt_tpu/ops/geglu.py:55",
                  ("generate", "train", "serve_bf16", "personalize", "personalize_unfused")),
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
}


def kernels_line(results, launches_by_path):
    """Per kernel, the mean over the shapes its paths run (for the two conv
    kernels that no path runs: over their phase-2 shapes) of the times and
    bounds measured in phase 2, and its launches on each path's counted
    run."""
    out = []
    for name, (source, replaces, paths) in KERNELS.items():
        by_path = {p: launches_by_path[p][name] for p in launches_by_path}
        missing = [p for p in paths if by_path[p] == 0]
        if missing:
            raise AssertionError(f"{name} was never launched on the {missing} path")
        rs = [r for r in results[name] if r["paths"]] or results[name]
        mean = lambda key: sum(r[key] for r in rs) / len(rs)
        t_ops = sum(r["ops_ms"] for r in rs)
        t_bytes = sum(r["bytes_ms"] for r in rs)
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": mean("kernel_ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_ms"),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None if rs[0]["library_ms"] is None else mean("library_ms"),
            "exp_bound_ms": mean("exp_bound_ms"),
        })
        if "unfused_ms" in rs[0]:
            out[-1].update(unfused_ms=mean("unfused_ms"), affine_ms=mean("affine_ms"))
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
    launches = {"generate": phase_generate(), "train": phase_train()}
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
