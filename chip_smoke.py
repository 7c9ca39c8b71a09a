#!/usr/bin/env python3
"""Drive the PyTorch port's two paths on one NVIDIA H100: SD-1.5 txt2img
and Stage-1 Arc2Face-distillation training.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero without the final line):
  1. build the four CUDA kernels of the paths (one nvcc per source, in
     parallel) from adaprompt_tpu_torch/csrc/;
  2. hold each kernel against its plain PyTorch version on the card, in
     bf16, at the paths' shapes, and time kernel, plain version and (flash
     attention forward and backward) F.scaled_dot_product_attention as the
     yardstick;
  3. run one full-width UNet forward on the card in bf16 and the same
     weights on the CPU in fp32, and bound the relative error;
  4. run one full-width UNet forward and backward with a masked image (the
     training path: flash backward, GEGLU backward, block recompute) on the
     card in bf16 and on the CPU in fp32, and bound the relative error of
     the gradient with respect to the context;
  5. generate 2 prompts at 512x512 with DDIM-50 through
     StableDiffusionPipeline.generate with random weights from a seed, and
     check that every forward kernel was launched 10 times per UNet
     evaluation and the backward kernel never;
  6. take 4 Stage-1 training steps (bs 4, 512x512, ND 1 and 5 from seed 0)
     through AdaPromptTrainer.train_step at full width with random
     weights, and check the losses, the gradient norms, that the
     SubjBasisGenerator moved, and every kernel's launch count;
  7. print the kernels' JSON line, the card's name and power limit, and
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

def _bound(flops, nbytes, exps=0):
    t_ops = flops / H100_BF16_FLOPS * 1e3
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


def _case_cross(gen, n, c):
    import torch
    from adaprompt_tpu_torch.ops import attention as A
    b, h, s = UNET_BATCH, 8, 77
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
    return f"fused_cross_attention C={c} N={n}", err, mag, 2e-2, ok, res, ""


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


def phase_kernels():
    """Returns {wrapper name: [per-shape results]} for the kernels line."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    # (wrapper, the paths whose shapes these are, case): txt2img has no
    # img_mask, training masks the self-attention keys (bias); the flash
    # backward without bias is on no path and is checked all the same
    gen_, train, both = ("generate",), ("train",), ("generate", "train")
    cases = [("flash_attention_fwd", gen_, lambda: _case_flash(gen, 4096, 40, False)),
             ("flash_attention_fwd", train, lambda: _case_flash(gen, 4096, 40, True)),
             ("flash_attention_fwd", gen_, lambda: _case_flash(gen, 1024, 80, False)),
             ("flash_attention_fwd", train, lambda: _case_flash(gen, 1024, 80, True)),
             ("flash_attention_bwd", (), lambda: _case_flash_bwd(gen, 4096, 40, False)),
             ("flash_attention_bwd", train, lambda: _case_flash_bwd(gen, 4096, 40, True)),
             ("flash_attention_bwd", (), lambda: _case_flash_bwd(gen, 1024, 80, False)),
             ("flash_attention_bwd", train, lambda: _case_flash_bwd(gen, 1024, 80, True)),
             ("fused_cross_attention", gen_, lambda: _case_cross(gen, 4096, 320)),
             ("fused_cross_attention", gen_, lambda: _case_cross(gen, 1024, 640)),
             ("geglu_fwd", both, lambda: _case_geglu(gen, 4096, 320)),
             ("geglu_fwd", both, lambda: _case_geglu(gen, 1024, 640))]
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


def phase_unet_check():
    """One full-width UNet forward (64x64 latents, 2 rows) on the card in
    bf16 against the same weights on the CPU in fp32."""
    import torch
    from adaprompt_tpu_torch.models.unet import UNet
    from adaprompt_tpu_torch.ops.layers import randomize_zero_init, reset_parameters
    gen = torch.Generator(device="cuda").manual_seed(1)
    unet = reset_parameters(UNet(device="cuda", dtype=torch.bfloat16), gen)
    randomize_zero_init(unet, gen)
    x = torch.randn(2, 64, 64, 4, device="cuda", generator=gen).to(torch.bfloat16)
    ctx = torch.randn(1, 2, 77, 768, device="cuda", generator=gen).to(torch.bfloat16)
    ts = torch.tensor([981, 501], device="cuda")
    t0 = time.perf_counter()
    with torch.inference_mode():
        eps = unet(x, ts, ctx, cross_kv=unet.precompute_cross_kv(ctx)).float().cpu()
    card_s = time.perf_counter() - t0
    cpu = UNet(device="cpu", dtype=torch.float32)
    cpu.load_state_dict({k: v.float().cpu() for k, v in unet.state_dict().items()})
    del unet
    t0 = time.perf_counter()
    with torch.inference_mode():
        ctx32 = ctx.float().cpu()
        ref = cpu(x.float().cpu(), ts.cpu(), ctx32, cross_kv=cpu.precompute_cross_kv(ctx32))
    cpu_s = time.perf_counter() - t0
    rel = ((eps - ref).norm() / ref.norm()).item()
    log(f"phase 3 unet: bf16 card vs fp32 CPU relative L2 error {rel:.4e} (bound {UNET_TOL:g}); "
        f"|eps| max {ref.abs().max().item():.3e}; card {card_s:.2f} s (first call), CPU {cpu_s:.1f} s")
    if not (math.isfinite(rel) and rel <= UNET_TOL and ref.abs().max().item() > 0):
        raise AssertionError(f"UNet on the card disagrees with the CPU: relative error {rel}")


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
    want = {"flash_attention_fwd": 20, "flash_attention_bwd": FLASH_BWD_PER_PASS,
            "fused_cross_attention": 0, "geglu_fwd": 20}
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
    want = {n: 10 * steps for n in launches}
    want["flash_attention_bwd"] = 0            # sampling takes no gradient
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
    want = {"flash_attention_fwd": fwd, "flash_attention_bwd": FLASH_BWD_PER_PASS * sum(students),
            "fused_cross_attention": 0, "geglu_fwd": fwd}
    if launches != want:
        raise AssertionError(f"training launches {launches}, expected {want}")
    return launches


KERNELS = {   # wrapper -> (source, TPU kernel it replaces, the paths that launch it)
    "flash_attention_fwd": ("adaprompt_tpu_torch/csrc/flash_attention.cu",
                            "adaprompt_tpu/ops/attention.py:176", ("generate", "train")),
    "flash_attention_bwd": ("adaprompt_tpu_torch/csrc/flash_attention_bwd.cu",
                            "adaprompt_tpu/ops/attention.py:314", ("train",)),
    "fused_cross_attention": ("adaprompt_tpu_torch/csrc/fused_cross_attention.cu",
                              "adaprompt_tpu/ops/attention.py:610", ("generate",)),
    "geglu_fwd": ("adaprompt_tpu_torch/csrc/geglu.cu", "adaprompt_tpu/ops/geglu.py:55",
                  ("generate", "train")),
}


def kernels_line(results, launches_by_path):
    """Per kernel, the mean over the shapes its paths run (each runs 5 times
    per UNet evaluation) of the times and bounds measured in phase 2, and
    its launches on each path's counted run."""
    out = []
    for name, (source, replaces, paths) in KERNELS.items():
        by_path = {p: launches_by_path[p][name] for p in launches_by_path}
        missing = [p for p in paths if by_path[p] == 0]
        if missing:
            raise AssertionError(f"{name} was never launched on the {missing} path")
        rs = [r for r in results[name] if r["paths"]]
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
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps(kernels_line(results, launches)))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
