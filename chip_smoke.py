#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA H100: SD-1.5 txt2img,
Stage-1 Arc2Face-distillation training, zero-shot recon training (the
spliced prompt, activation capture, the fg/bg attention regularizers,
subject conv-attention, and the background "y" token's branch: the CLIP
ViT-H/14 vision tower's masked zero-shot features through the background
SubjBasisGenerator), Stage-2 compositional training (the CLIP teacher
filter, mix-prompt distillation, elastic fg/bg preservation), the rest of the trainer
(full-state resume, AdamW with the EMA, the static textual-inversion recon step, the
sample grid through PromptConditioner), the composed serving stack (DPM-Solver++ 20 steps
with ToMe, DeepCache and the CFG tail, quant="int8"), and the product path
(AdaFacePipeline: photos -> ArcFace -> 16 subject tokens -> personalized
DDIM-50, with UNetConfig.fused_conv); txt2img and distillation also under
each UNetConfig.flash_variant (two-chain, no-max, exp2); the txt2img, infer
and training CLIs over checkpoint files on disk; the evaluation path (the
object (DINO) branch, gen_eval and txt2img --compare_with, image metrics);
face detection (RetinaFace R50 and BiSeNet parsing, their alignment, the
detectors of every CLI, gen_face_masks and face_tools); img2img sampling
(DDIM's eta, mask, stochastic_encode / ddim_decode) under the translate CLI,
the diffusers-format loaders under arc2face_gen, and the demo's REPL; the
full-UNet reconstruction step (the UNet's own weights trained, or a context
against the frozen UNet), the legacy Ada embedder, the class-delta functions
and the training CLI's background overlays.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero without the final line):
  1. build the thirteen CUDA kernels (eleven sources, one nvcc each, in
     parallel) from adaprompt_tpu_torch/csrc/, and log what the exp2 forms
     of the flash kernels changed in the SASS;
  2. log the four flash kernels' resources at D=40 and 80 (registers,
     shared memory, rows a block, blocks an SM; the three forwards and the
     backward's main kernel) and the int8-QK flash attention's three
     kernels', the GEGLU's two kernels' at C=320 and 640,
     the fused cross-attention's two and the int8 GEGLU's and the int8
     cross-attention's four each at their four shapes (also their grids),
     the two plain 3x3 convs' kernels at their four shapes and the fused
     GroupNorm-SiLU-conv's conv and statistics kernels at its three, each
     with the k splits conv_plan picks (their grids checked against the
     plan's);
     hold each kernel against its plain PyTorch version on the card, in
     bf16, at the paths' shapes (the GEGLU, the fused cross-attention and
     both int8 kernels also untimed at ragged shapes, with their launch
     counts checked a call, the int8 GEGLU also where every row's max|g|
     lies in the last 64 columns, the int8 cross-attention where every
     row's max|o| lies in the last head; the
     kernels that no path runs, the two plain 3x3 convs, the int8-QK flash
     attention and the fused self-attention, at the UNet's shapes or the JAX
     tests' and ragged ones, the int8-QK call's own int8 operands also
     against the plain version's; the flash variants and exp2 forms each against
     its own plain version, plus the no-max kernel's underflow guard; each
     flash forward and the backward in both forms also at Sq != Sk with both
     ragged, head dims 8 to 128, one key tile, a key tile masked whole and a
     row masked whole, the two-chain one also at 9 key tiles; the backward's
     pre-pass delta against its plain version, and the spread of its
     atomically summed dq over two calls), and time
     kernel, plain version and, where one PyTorch call computes the same
     function, that call as the yardstick (F.scaled_dot_product_attention
     for flash attention forward and backward, F.conv2d for the two plain
     convs, each of which is also timed beside the other form); beside the
     fused GroupNorm-SiLU-conv, which no single call
     computes, the port's own unfused pair (group_norm + conv2d), its C call,
     its statistics kernel alone and the plain halo conv's C call, beside
     the GEGLU the port's unfused feed-forward on cuBLAS, beside the
     fused cross-attention its unfused chain (cuBLAS, SDPA, cuBLAS), beside
     each int8 kernel its bf16 counterpart at its shape and the port's int8
     chain on cuBLASLt (torch._int_mm); beside the
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
     to the context; then the capture check: the same pass with
     capture_ca=True and the fg/bg regularizers (box fg mask) on its
     attention scores, card against CPU, bounding the relative error of the
     context gradient and of each of the 12 captured score maps, with exact
     launch counts; then the vision-tower check: one seeded 224x224 image
     with a box fg mask through the full-width CLIP ViT-H/14 encode in fp32
     on the card and on the CPU, bounding the relative L2 error of its
     second-to-last hidden states and of pooled (no kernel launched);
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
 10. recon training, right after phase 9's training turns, over phase 6's
     frozen models: an AdaPromptTrainer with arc2face_distill_iter_prob=0
     and fgbg_reg=True and a fresh seeded SubjBasisGenerator takes 4 recon
     steps (two accumulated updates), then one over the same generator with
     use_conv_attn_kernel_size=3 takes 2, then one with a full-width CLIP
     ViT-H/14 behind a ZeroShotFeatureExtractor and a seeded background
     SubjBasisGenerator (514 feature rows) and use_background_token_prob=1
     takes 4 "recon_bg" steps (background vectors spliced per layer);
     check every metric of the JAX step (finite), the cross-layer terms
     (the background one under recon_bg) and the gradient norm > 0, that the
     generators and emb_scales moved, and the exact launch counts (none
     inside the extractor's calls); log s/step, the extractor's time a call
     and peak memory;
 11. Stage-2 compositional training, right after phase 10, over phase 6's
     frozen models and a fresh seeded SubjBasisGenerator: (a) a trainer with
     TrainerConfig.stage2(grad_accum=2) and a CLIPScorer at ViT-B/32's
     published widths (random weights from a seed) takes train_step(3), a
     fresh compositional iteration whose CLIP teacher filter denoises and
     decodes 2 candidates' comp pairs (UNet batch 4, VAE decode of 4) and
     scores them; either decision is accepted, with the launch counts it
     implies (none inside the scorer); (b) a second trainer with
     no_teacher_filter=True takes train_step(3) (fresh) and train_step(6)
     (reuse: the cached x_recon at t in [400, 700)); checks every metric
     of the JAX phase (finite), grad_norm > 0, teacher_filter_disabled,
     that the generator moved, the 12 layers of ca_q_bn_stats and the
     exact launch counts; logs s/step, the filter's time and peak memory;
 12. the rest of the trainer, right after phase 11, over phase 6's trainer
     and frozen models: (a) save_full_state, 2 steps on captured raw batches,
     five times load_full_state and the same 2 steps: equal
     iteration types, host and device draws and first-step loss bit for bit,
     the second step (and the parameters) as close as the resumed runs' own
     spread, the largest over their ten pairs, allows (B4's dq atomics); logs the file's size and the save and
     load times; (b) a trainer with optimizer_type="AdamW" and use_ema=True
     over a fresh generator takes an accumulating and an applying step: the
     parameters move only on the second, the EMA counts 2 updates and equals
     LitEma's formula on a host copy, the checkpoint holds ema_subj_basis;
     (c) the static recon step over a StaticLayerwiseEmbedding (K 16, D 768)
     takes 2 steps with the augmentation mask (B1 and B4 with key bias) and
     its parameters move; (d) log_samples (DDIM-20, n 2, 512x512) writes a
     [512, 1024, 3] strip that the port's PNG reader decodes to the array
     written; exact
     launch counts on each of the four paths;
 13. the CLIs over checkpoints on disk, after phase 8: an AdaFacePipeline at
     full width (random weights, fused_conv off, the generator's
     prompt2token_proj K/V-widened x2 on its last four layers) written as
     the reference's files into a temporary directory (an SD-1.5 .ckpt in
     the LDM layout, float32, with entries no model reads; an AdaFace
     embeddings_gs-*.pt whose generator is pickled under the reference's
     class names; an IResNet-100 .pth in the insightface layout; three
     seeded 512x512 PNG photos) by tools/reference_layouts.py; (a)
     StableDiffusionPipeline.from_checkpoint holds every parameter bit-equal
     to the pipeline written and gives a bit-equal UNet forward; (b)
     txt2img.main over the files (2 images, DDIM-50, scale 4 -> 1) and (c)
     infer.main over them (2 images, DDIM-50): PNGs that decode to the
     images generate returned, std > 0, exactly 500 launches each of B1-B3
     and none of the rest, none while infer personalizes, whose 16 subject
     vectors equal those of an AdaFacePipeline built in memory from the
     same modules on the same photos; logs file sizes, load, save and
     generate times and peak memory beside the card's name and power limit;
 14. the training CLI over a folder of photos, right after phase 13 and in
     its temporary directory, over its .ckpt (as --ckpt and --arc2face_ckpt)
     and ArcFace .pth: a data root of 3 subjects x 3 seeded 512x512 PNG
     photos with masks and one 600x560 photo, and a ViT-B/32 CLIPModel
     state dict (random) written by the phase; train.main for (a) Stage 1,
     bs 4, 4 steps with --ckpt_every 2 and --sample_every 2, SIGUSR1 sent
     50 ms into step 1 (held to the step's end: trainer_state-2 written, the
     run goes on to its last step); (b) --resume_state from that state (its
     first step the saved one); (c) Stage 2 (bs 3) from (a)'s generator with
     the CLIP teacher filter and a torch.profiler trace (a device kernel in
     it); (d) --mode static, 2 steps; each run's files checked, its launches
     of B1-B4 equal to what its metrics rows imply; logs each run's wall
     time, loads, step times, saves and peak memory;
 15. the evaluation path, right after phase 14 and in its temporary
     directory, over phase 13's .ckpt, AdaFace .pt and ArcFace .pth and
     phase 14's data root: (a) the object branch: one subject's 3 photos
     with masks through a ZeroShotFeatureExtractor over a seeded full-width
     CLIP ViT-H/14 and DINO ViT-S/16 (is_face=False, calc_avg off and on),
     the DINO embeddings through a seeded full-width SubjBasisGenerator's
     object branch at out_id_embs_scale 1 and 0.8, fp32 card (TF32 off)
     against the same modules on the CPU, no kernel launched; (b)
     gen_eval.main over two subjects (2 prompts x 2 images, DDIM-50):
     scores.csv with 2 rows of finite scores in [-1, 1], 8 PNGs 512x512,
     exactly 2,000 launches each of B1-B3 and none of the rest, none while
     scoring; (c) txt2img.main --compare_with one subject's folder (2
     images, DDIM-50): its scores in [-1, 1], 500 launches each of B1-B3;
     (d) PSNR, SSIM and the IResNet-100 random-feature cosine of (b)'s
     images against (c)'s; logs each run's wall time, loads, generates,
     the scoring of a folder pair (CLIP, DINO, ArcFace) and peak memory;
 16. face detection, right after phase 15 and in its temporary directory,
     over phase 13's files and phase 14's subjects: (a) a seeded RetinaFace
     R50 (its heads scaled so that ~1 % of a noise canvas's anchors pass the
     0.5 threshold) and a seeded BiSeNet written as Resnet50_Final.pth and
     79999_iter.pth with random BatchNorm statistics; (b) their full-width
     forwards in fp32 on the card (TF32 off, then on) against the CPU on the
     same inputs: RetinaFace's heads at the 640 canvas and BiSeNet's logits
     at batch 8 x 512x512 within 1e-4 relative L2, labels equal where the
     CPU's top-two logits differ by more than the measured error; (c)
     detect_faces' decoding and NMS on the card's and on the CPU's head
     outputs of five photos: equal detections wherever no score lies within
     the measured error of the threshold and no IoU within it of 0.4 (the
     near-ties counted); (d) make_retinaface_detector and
     make_bisenet_detector behind FaceSimilarityEvaluator over 3 photos,
     timed against the centre crop, detect_faces split into canvas,
     forward, decoding and warp; (e) infer.main with
     $ADAPROMPT_RETINAFACE_CKPT set (path "cli_infer_retinaface": B1-B3 500
     each); (f) gen_face_masks over phase 14's subjects (--batch_size 8):
     its files, masks in {0, 255} equal to an in-memory parse_faces, the
     curation each photo's part count implies; (g) face_tools compare, knn
     and filter; (h) train.main, one Stage-1 step with --detector
     retinaface:<pth> (path "cli_train_detector", B1/B3/B4 as its row
     implies); no detection or parsing call launches a kernel; logs whether
     scipy, cv2 and PIL import here;
 17. img2img and the last three CLIs, right after phase 16 and in its
     temporary directory, over phase 13's files and photos: (c)
     translate.main at its defaults (DDIM-50, strength 0.8: 40 steps a
     photo) over the 3 photos (path "cli_translate": B1-B3 1,200 each and
     none of the rest), each PNG decoding to the image decoded; on that
     run's loaded pipeline (a) ddim_decode from the top equal to
     ddim_sample and (b) eta=0.0 given and an all-zero mask equal to the
     default, all bit for bit, eta 0.5 with a half mask twice from one seed
     bit-equal and finite (DDIM-10, 2 images); (d) its UNet and VAE written
     in the diffusers layout in both forms and read back by
     unet_from_diffusers / vae_from_diffusers: parameters, a UNet forward
     and a VAE decode bit-equal; (e) arc2face_gen.main (2 images, DDIM-20)
     with the LDM .ckpt and with (d)'s diffusers UNet saved in bf16 (paths
     "cli_arc2face_gen_ldm", "cli_arc2face_gen_diffusers": 200 each):
     equal images; (f) demo.main (its ArcFace random, as in JAX), warmup
     on, its REPL fed `subject`, `gen` and `quit` with gradio kept from
     importing ("cli_demo": 600 each):
     the fallback line, the saved PNG equal to its image; logs each run's
     wall time, loads, steps and peak memory;
 18. the rest of the personalization chain and the background overlays,
     right after phase 17 and in its temporary directory, over phase 14's
     subjects: (a) make_recon_step over a seeded full-width SD-1.5 UNet in
     fp32 with bf16 activations, its own weights trained under AdamW, 3
     steps at batch 4, 512x512, the aug mask as key mask (path
     "unet_recon": B1 20, B3 20, B4 10 a step, B2 none): step 1's loss and
     gradient norm against the same draws with the kernels' plain versions
     in fp32 (relative 1e-2 and 5e-2), every weight moved, step times and
     peak memory; (b) one context_fn step, a trainable table making the
     context of that UNet frozen ("unet_recon_ctx": B1 20, B3 20, B4 9);
     (c) ada_forward over the 16 CA layers at the 512x512 shapes, batch 4,
     the UNet's to_k, a seeded AdaEmbedder read by ada_from_torch from the
     reference's layout: fp32 card (TF32 off) against the CPU within 1e-4
     relative L2, no launch, its time; (d) merge_cls_token_embeddings and
     distribute_embedding_to_M_tokens on the card bit-equal to the CPU; (e)
     train.main with --overlay_source over a folder of PNG and JPEG
     backgrounds and over a .tar of them ("cli_train_overlay_dir",
     "cli_train_overlay_tar"), --overlay_prob 0.5, 2 recon steps: every
     composite equal to PIL's decode, BICUBIC resize and crop of its source
     pasted in numpy, launches as the rows imply;
 19. print the kernels' JSON line (thirteen rows), the card's name and
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
RECON_STEPS = 4         # two accumulated updates; then RECON_CONV_STEPS with conv-attention
RECON_CONV_STEPS = 2
RECON_BG_STEPS = 4      # two accumulated updates, every step "recon_bg"
COMPOS_STEPS = (3, 6)   # Stage-2 gap 3: a fresh compositional iteration, then its reuse
COMPOS_METRICS = ("loss_compos", "loss_mix_prompt_distill", "loss_prompt_emb_delta",
                  "loss_fg_xlayer_consist", "loss_bg_xlayer_consist", "loss_comp_fg_bg_preserve")
VISION_TOL = 1e-4       # ViT-H/14 fp32 card (TF32 off) vs fp32 CPU, relative L2
RECON_METRICS = ("loss", "loss_recon", "loss_fg_bg_complementary", "loss_subj_mb_suppress",
                 "loss_bg_mf_suppress", "loss_fg_bg_mask_contrast", "loss_fg_xlayer_consist",
                 "loss_bg_xlayer_consist", "grad_norm")
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


def device_ms(fn, iters, warmup=2):
    """Like time_ms, for calls whose host work outlasts their device work:
    the calls are queued behind a ~5 ms spin of the card (torch.cuda._sleep),
    so that the events time the device alone."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(10_000_000)
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


def int8_operands_check(q, k, v, work):
    """B10's operands as one C call left them in `work` (a call with keep_q)
    against `int8_qk_operands` on the same card tensors: q_q and q_s equal bit
    for bit; the key mean's bf16 columns counted where they differ from
    k.mean(1) (its fp32 sum runs in another order: a mean near a bf16
    rounding tie may move by an ulp, and with it a key's row maximum); k_q
    within one level everywhere, k_q and k_s equal in every head whose key
    mean agrees; the pad columns [D, DQ) zero. Returns (ok, detail)."""
    import torch
    from adaprompt_tpu_torch.ops import attention as A
    b, sq, h, d = q.shape
    sk = k.shape[1]
    got = A.int8_flash_workspace(work, b, sq, sk, h, d)
    q_q, q_s, k_qt, k_s, _ = A.int8_qk_operands(q, k, v)
    k_q, k_s = k_qt.transpose(1, 2), k_s[:, 0]
    mean_diff = got["k_mean"] != k.mean(dim=1).reshape(b * h, d)
    cols = int(mean_diff.sum())
    same = ~mean_diff.any(dim=1)                         # heads whose mean agrees
    dk = (got["k_q"][..., :d].int() - k_q.int()).abs()
    ok_q = (torch.equal(got["q_q"][..., :d], q_q) and torch.equal(got["q_s"], q_s[..., 0])
            and not got["q_q"][..., d:].any())
    ok_k = (int(dk.max()) <= 1 and not dk[same].any()
            and torch.equal(got["k_s"][same], k_s[same]) and not got["k_q"][..., d:].any())
    detail = (f"operands: q_q/q_s bit-equal {ok_q}, k_q/k_s {'as stated' if ok_k else 'WRONG'} "
              f"(max level diff {int(dk.max())}), key-mean columns that differ {cols} of "
              f"{b * h * d}")
    return ok_q and ok_k, detail


def _case_flash_int8(gen, s, d, with_bias, b=UNET_BATCH, h=8, sk=None, timed=True):
    """B10 (one C call: the key pass's two kernels and the attention kernel)
    against its plain version, which makes its int8 operands in PyTorch
    (`int8_qk_operands`); its launch count must rise by one a call, and the
    operands the call made must agree with the plain version's
    (`int8_operands_check`). Its distance from exact bf16 attention is
    logged, unbounded. `kernel_ms` is the wrapper's call, `kernel_only_ms`
    its C call alone on allocated operands, `prepass_ms` the key pass alone
    (its two kernels; `device_ms`: its host work outlasts it);
    beside them, timed only: `b1_ms`, B1's forward (wrapper) at the same
    shape, and SDPA as the library call."""
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
    before = A.flash_attention_int8.launches
    out = A.flash_attention_int8(q, k, v, bias, scale)
    if A.flash_attention_int8.launches != before + 1:
        raise AssertionError(f"flash_attention_int8 counted "
                             f"{A.flash_attention_int8.launches - before} launches for one call")
    ref = A.flash_attention_int8_reference(q, k, v, bias, scale)
    err, mag, ok = _compare(out, ref, 2e-2)
    exact = A.attention_reference(q, k, v, bias, scale)[0]
    detail = f"vs exact bf16 attention {(out.float() - exact.float()).abs().max().item():.2e}"
    del ref, exact
    work = torch.empty(A._int8_flash_layout(b, s, sk, h, d)[0], dtype=torch.uint8, device="cuda")
    out_c = torch.empty_like(q)
    A.int8_flash_kernel_call(q, k, v, bias, work, out_c, scale, keep_q=True)
    ops_ok, ops_detail = int8_operands_check(q, k, v, work)
    ok = ok and ops_ok and torch.equal(out_c, out)
    detail += f"; {ops_detail}; C call equals the wrapper's bits {torch.equal(out_c, out)}"
    nan = float("nan")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None if bias is None else bias[:, None, None, :].to(torch.bfloat16)
    res = {"kernel_ms": nan, "kernel_only_ms": nan, "prepass_ms": nan, "plain_ms": nan,
           "library_ms": nan, "b1_ms": nan}
    if timed:
        res.update(
            kernel_ms=time_ms(lambda: A.flash_attention_int8(q, k, v, bias, scale), 10),
            kernel_only_ms=time_ms(lambda: A.int8_flash_kernel_call(q, k, v, bias, work, out_c,
                                                                    scale), 20),
            prepass_ms=device_ms(lambda: A.int8_flash_key_pass(k, work, s), 20),
            plain_ms=time_ms(lambda: A.flash_attention_int8_reference(q, k, v, bias, scale), 3),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=scale), 10),
            b1_ms=time_ms(lambda: A.flash_attention_fwd(q, k, v, bias, scale), 10))
        detail += (f" kernel_only_ms={res['kernel_only_ms']:.4f} prepass_ms={res['prepass_ms']:.4f}"
                   f" b1_ms={res['b1_ms']:.4f} ({res['kernel_ms'] / res['b1_ms']:.2f}x B1)")
    # q.k^T as int8 operations, p.v as bf16 flops; the function's inputs
    # (q, k, v bf16, the bias) read once and the output written once
    nbytes = 2 * b * (s + sk) * h * d * 2 + (b * sk * 4 if with_bias else 0)
    res.update(_bound(2 * b * h * s * sk * d, nbytes, exps=b * h * s * sk,
                      int8_ops=2 * b * h * s * sk * d))
    return (f"flash_attention_int8 D={d} Sq={s} Sk={sk} B={b} H={h} bias={with_bias}", err, mag,
            2e-2, ok, res, detail)


def self_inputs(gen, b, n, c, h, with_bias):
    """B11's operands at [b, n, c] with h heads, on the card: x, the four
    weights, bo (fp32), the scale hd**-0.5, h, a key bias dropping ~30 % of
    the keys (NEG_BIG) or None."""
    import torch
    from adaprompt_tpu_torch.ops import attention as A
    bf = torch.bfloat16
    x = torch.randn(b, n, c, device="cuda", generator=gen).to(bf)
    w = lambda: ((torch.rand(c, c, device="cuda", generator=gen) * 2 - 1) / math.sqrt(c)).to(bf)
    wq, wk, wv, wo = w(), w(), w(), w()
    bo = (torch.rand(c, device="cuda", generator=gen) * 2 - 1) / math.sqrt(c)
    bias = None
    if with_bias:
        keep = torch.rand(b, n, device="cuda", generator=gen) < 0.7
        bias = (keep.float() - 1.0) * (-A.NEG_BIG)
    return x, wq, wk, wv, wo, bo, (c // h) ** -0.5, h, bias


def mha_library(x, wq, wk, wv, wo, bo, scale, h, bias):
    """B11's library yardstick: a function of no arguments making one
    `F.multi_head_attention_forward` call that computes B11's function on
    these operands (in_proj_weight = [Wq; Wk; Wv] without a bias, out_proj
    (Wo, bo), the key bias as a float key_padding_mask, need_weights=False),
    returning [B, N, C]. The call scales q by hd**-0.5 itself, so the scale
    must be that. Timed only: the port never calls it."""
    import torch
    import torch.nn.functional as F
    b, n, c = x.shape
    if abs(scale - (c // h) ** -0.5) > 1e-12:
        raise ValueError("multi_head_attention_forward scales by hd**-0.5 only")
    xt = x.transpose(0, 1)
    w_in = torch.cat([wq, wk, wv])
    bo16 = bo.to(x.dtype)
    mask = None if bias is None else bias.to(x.dtype)
    return lambda: F.multi_head_attention_forward(
        xt, xt, xt, c, h, w_in, None, None, None, False, 0.0, wo, bo16, training=False,
        key_padding_mask=mask, need_weights=False)[0].transpose(0, 1)


def _case_self(gen, n, c, with_bias, b=UNET_BATCH, h=8, timed=True):
    """B11 (one C call: the q-attention and out kernels, after the K|V
    product) against its plain version; its launch count must rise by one a
    call, and two calls must give equal bits (and the C call alone the
    wrapper's). `kernel_ms` is the wrapper's call (K|V product included),
    `kernel_only_ms` its C call alone on allocated operands, `kv_ms` the K|V
    product; `library_ms` one `F.multi_head_attention_forward` call on the
    same operands (`mha_library`), held against the plain version (<= 2e-2 *
    max) before it is timed; beside them, timed only: `b1_ms`, B1's forward
    at this shape, and `unfused_ms`, the chain the port's UNet runs instead
    (three linears, B1, the out-projection)."""
    import torch
    from adaprompt_tpu_torch.ops import attention as A
    bf = torch.bfloat16
    args = self_inputs(gen, b, n, c, h, with_bias)
    x, wq, wk, wv, wo, bo, scale, _, bias = args
    before = A.fused_self_attention.launches
    out = A.fused_self_attention(*args)
    out2 = A.fused_self_attention(*args)
    if A.fused_self_attention.launches != before + 2:
        raise AssertionError(f"fused_self_attention counted "
                             f"{A.fused_self_attention.launches - before} launches for two calls")
    ref = A.fused_self_attention_reference(*args)
    err, mag, ok = _compare(out, ref, 2e-2)
    kv = A.packed_kv(x, wk, wv).contiguous()
    o, out_c = torch.empty_like(x), torch.empty_like(x)
    call = lambda: A.fused_self_kernel_call(x, wq, kv, wo, bo, bias, o, out_c, scale, h)
    call()
    same = torch.equal(out, out2) and torch.equal(out_c, out)
    lib = mha_library(*args)
    lib_err, _, lib_ok = _compare(lib(), ref, 2e-2)
    ok = ok and same and lib_ok
    del ref
    hd = c // h

    def unfused():
        q, k, v = ((x @ m.t()).reshape(b, n, h, hd) for m in (wq, wk, wv))
        o = A.flash_attention_fwd(q, k, v, bias, scale)[0]
        return o.reshape(b, n, c) @ wo.t() + bo.to(bf)

    nan = float("nan")
    res = {"kernel_ms": nan, "kernel_only_ms": nan, "kv_ms": nan, "plain_ms": nan,
           "library_ms": nan, "b1_ms": nan, "unfused_ms": nan}
    if timed:
        q1, k1, v1 = (torch.randn(b, n, h, hd, device="cuda", generator=gen).to(bf)
                      for _ in "qkv")
        res.update(kernel_ms=time_ms(lambda: A.fused_self_attention(*args), 10),
                   kernel_only_ms=time_ms(call, 20),
                   kv_ms=time_ms(lambda: A.packed_kv(x, wk, wv), 10),
                   plain_ms=time_ms(lambda: A.fused_self_attention_reference(*args), 2),
                   library_ms=time_ms(lib, 10),
                   b1_ms=time_ms(lambda: A.flash_attention_fwd(q1, k1, v1, bias, scale), 10),
                   unfused_ms=time_ms(unfused, 10))
    # the flash kernel's work plus the four C x C projections; x in and out
    # once, the four weights, bo and the bias
    flops = 4 * b * n * n * c + 8 * b * n * c * c
    nbytes = 2 * b * n * c * 2 + 4 * c * c * 2 + c * 4 + (b * n * 4 if with_bias else 0)
    res.update(_bound(flops, nbytes, exps=b * h * n * n))
    detail = (f"two calls and the C call equal bit for bit {same}; library vs plain "
              f"{lib_err / mag:.2e}*max")
    if timed:
        detail += (f" kernel_only_ms={res['kernel_only_ms']:.4f} kv_ms={res['kv_ms']:.4f} "
                   f"b1_ms={res['b1_ms']:.4f} unfused_ms={res['unfused_ms']:.4f} "
                   f"(wrapper {res['kernel_ms'] / res['unfused_ms']:.2f}x unfused, "
                   f"{res['kernel_ms'] / res['library_ms']:.2f}x library)")
    return (f"fused_self_attention C={c} N={n} B={b} H={h} bias={with_bias}", err, mag, 2e-2, ok,
            res, detail)


# B11's ragged cases (B, N, C, H, key bias), checked untimed: the old kernel's
# two (1000 rows at C=320 with a bias; 77 rows at C=1280, hd=160), and rows
# across a row tile and a key tile at head dims 24 and 80 (N = 129, 300)
SELF_RAGGED = ((1, 1000, 320, 8, True), (2, 77, 1280, 8, False), (2, 300, 192, 8, True),
               (3, 129, 640, 8, False))


def _case_cross(gen, n, c, b=UNET_BATCH, h=8, timed=True):
    """B2 (one C call: the q-attention and out kernels) against its plain
    version; its launch count must rise by one a call. `kernel_ms` is the
    wrapper's call, `kernel_only_ms` its C call alone on allocated operands
    (where the wrapper's host work exceeds the kernels' time, back-to-back
    wrapper calls measure the host). No single PyTorch call
    computes it (library_ms None); `unfused_ms` is the chain of library calls
    it fuses, the time to beat: F.linear(x, wq) -> SDPA over the 77 keys
    ([B, H, S, hd] views of k and v) -> F.linear(o, wo, bo), in bf16."""
    import torch
    import torch.nn.functional as F
    from adaprompt_tpu_torch.ops import attention as A
    s = 77
    hd = c // h
    bf = torch.bfloat16
    x = torch.randn(b, n, c, device="cuda", generator=gen).to(bf)
    w = lambda: ((torch.rand(c, c, device="cuda", generator=gen) * 2 - 1) / math.sqrt(c)).to(bf)
    wq, wo = w(), w()
    k = torch.randn(b, s, h, hd, device="cuda", generator=gen).to(bf)
    v = torch.randn(b, s, h, hd, device="cuda", generator=gen).to(bf)
    bo = (torch.rand(c, device="cuda", generator=gen) * 2 - 1) / math.sqrt(c)
    scale = hd ** -0.5
    args = (x, wq, k, v, wo, bo, scale, h)
    before = A.fused_cross_attention.launches
    out = A.fused_cross_attention(*args)
    if A.fused_cross_attention.launches != before + 1:
        raise AssertionError(f"fused_cross_attention counted "
                             f"{A.fused_cross_attention.launches - before} launches for one call")
    ref = A.fused_cross_attention_reference(*args)
    err, mag, ok = _compare(out, ref, 2e-2)
    bo16 = bo.to(bf)

    def unfused():
        q = F.linear(x, wq).view(b, n, h, hd).transpose(1, 2)
        o = F.scaled_dot_product_attention(q, k.transpose(1, 2), v.transpose(1, 2), scale=scale)
        return F.linear(o.transpose(1, 2).reshape(b, n, c), wo, bo16)

    o, out2 = torch.empty_like(x), torch.empty_like(x)
    call = lambda: A.fused_cross_kernel_call(x, wq, k, v, wo, bo, o, out2, scale, h)

    nan = float("nan")
    res = {"kernel_ms": time_ms(lambda: A.fused_cross_attention(*args), 10) if timed else nan,
           "kernel_only_ms": time_ms(call, 20) if timed else nan,
           "plain_ms": time_ms(lambda: A.fused_cross_attention_reference(*args), 3)
           if timed else nan,
           "library_ms": None,
           "unfused_ms": time_ms(unfused, 10) if timed else nan}
    flops = b * n * (4 * c * c + 4 * s * c)
    nbytes = 2 * b * n * c * 2 + 2 * c * c * 2 + 2 * b * s * c * 2 + c * 4
    res.update(_bound(flops, nbytes, exps=b * h * n * s))
    detail = f"kernel_only_ms={res['kernel_only_ms']:.4f} unfused_ms={res['unfused_ms']:.4f}"
    return f"fused_cross_attention C={c} N={n} B={b} H={h}", err, mag, 2e-2, ok, res, detail


# B2's ragged cases (B, N, C, H), checked untimed: rows across the row-tile
# edges (N = 70, 100, 127, 129, 300), head dims 8, 12 (not a multiple of 8:
# K/V and o through 2-byte accesses), 32, 64 (one head) and 160, B = 3
CROSS_RAGGED = ((2, 100, 64, 2), (1, 512, 320, 8), (1, 70, 1280, 8), (4, 127, 320, 8),
                (4, 129, 320, 8), (2, 100, 96, 8), (2, 100, 64, 1), (3, 300, 640, 8),
                (2, 65, 64, 8))


def _case_geglu(gen, m, c, timed=True):
    """B3 (one C call: the proj and out kernels) against its plain version,
    on m rows of width c; its launch count must rise by one a call. No single
    PyTorch call computes it (library_ms None); `unfused_ms` is the port's own
    unfused feed-forward in bf16 as `models.unet._geglu_ff` runs it where the
    fused kernel is not taken (proj -> chunk -> a * gelu(gate) -> out on
    cuBLAS), the time to beat."""
    import torch
    import torch.nn.functional as F
    from adaprompt_tpu_torch.ops import geglu as G
    from adaprompt_tpu_torch.ops.layers import gelu
    f = 4 * c
    bf = torch.bfloat16
    u = lambda *shape, fan: ((torch.rand(*shape, device="cuda", generator=gen) * 2 - 1)
                             / math.sqrt(fan))
    x = torch.randn(m, c, device="cuda", generator=gen).to(bf)
    w1, b1 = u(2 * f, c, fan=c).to(bf), u(2 * f, fan=c)
    w2, b2 = u(c, f, fan=f).to(bf), u(c, fan=f)
    args = (x, w1, b1, w2, b2)
    before = G.geglu_fwd.launches
    out = G.geglu_fwd(*args)
    if G.geglu_fwd.launches != before + 1:
        raise AssertionError(f"geglu_fwd counted {G.geglu_fwd.launches - before} launches "
                             "for one call")
    ref = G.geglu_reference(*args)
    err, mag, ok = _compare(out, ref, 1e-2)
    b1h, b2h = b1.to(bf), b2.to(bf)

    def unfused():
        a, gate = F.linear(x, w1, b1h).chunk(2, dim=-1)
        return F.linear(a * gelu(gate), w2, b2h)

    nan = float("nan")
    res = {"kernel_ms": time_ms(lambda: G.geglu_fwd(*args), 10) if timed else nan,
           "plain_ms": time_ms(lambda: G.geglu_reference(*args), 3) if timed else nan,
           "library_ms": None,
           "unfused_ms": time_ms(unfused, 10) if timed else nan}
    flops = 6 * m * c * f
    nbytes = 2 * m * c * 2 + 3 * f * c * 2 + 2 * f * 4 + c * 4
    res.update(_bound(flops, nbytes, exps=m * f))
    detail = f"unfused_ms={res['unfused_ms']:.4f}"
    return f"geglu C={c} M={m}", err, mag, 1e-2, ok, res, detail


# B3's ragged cases (M, C), checked untimed: rows across the 128-row tile
# edge, C = 48 and 16 (K not a multiple of the ring's 64-deep stages, out's
# columns past C in the last 160-wide tile), C = 640 at the UNet's row count
GEGLU_RAGGED = ((50, 320), (33, 640), (96, 16), (127, 320), (129, 320), (257, 320),
                (200, 48), (4096, 640))


def _case_cross_int8(gen, n, c, b, timed=True, h=8, peak_last=False):
    """B5 (one C call: four kernels) against its plain version; its launch
    count must rise by one a call. `kernel_ms` is the wrapper's call,
    `kernel_only_ms` its C call alone on allocated operands, as B2's. No
    single PyTorch call computes it (library_ms None). Beside it, timed only
    and called by nothing in the port: `bf16_ms`, B2's C call at the same
    shape on the weights before quantization, what quant="int8" has to beat;
    `unfused_ms`, the port's own int8 chain in eager PyTorch (quantize_acts ->
    torch._int_mm -> dequantize to bf16 -> SDPA over the 77 keys ->
    quantize_acts -> torch._int_mm -> dequantize + bo), whose distance from
    the plain version is logged. With peak_last, V of the last head is 30x
    larger, so that every row's max|o| lies in the last head (a scale of o
    taken per head would clip or mis-scale there)."""
    import torch
    import torch.nn.functional as F
    from adaprompt_tpu_torch.ops import attention as A
    from adaprompt_tpu_torch.ops.quant import quantize_acts, quantize_weight
    s = 77
    hd = c // h
    bf = torch.bfloat16
    x = torch.randn(b, n, c, device="cuda", generator=gen).to(bf)
    w = lambda: ((torch.rand(c, c, device="cuda", generator=gen) * 2 - 1) / math.sqrt(c)).to(bf)
    wq, wo = w(), w()
    k = torch.randn(b, s, h, hd, device="cuda", generator=gen).to(bf)
    v = torch.randn(b, s, h, hd, device="cuda", generator=gen).to(bf)
    if peak_last:
        v[:, :, -1] *= 30
    bo = (torch.rand(c, device="cuda", generator=gen) * 2 - 1) / math.sqrt(c)
    scale = hd ** -0.5
    (wq_q, wq_s), (wo_q, wo_s) = quantize_weight(wq), quantize_weight(wo)
    args = (x, wq_q, wq_s, k, v, wo_q, wo_s, bo, scale, h)
    before = A.fused_cross_attention_int8.launches
    out = A.fused_cross_attention_int8(*args)
    if A.fused_cross_attention_int8.launches != before + 1:
        raise AssertionError(f"fused_cross_attention_int8 counted "
                             f"{A.fused_cross_attention_int8.launches - before} launches for one call")
    ref = A.fused_cross_attention_int8_reference(*args)
    err, mag, ok = _compare(out, ref, 2e-2)

    def unfused():
        """The eager int8 chain: out [B, N, C] and the head concat o [B*N, C]."""
        x_q, xs = quantize_acts(x.view(b * n, c))
        q = (torch._int_mm(x_q, wq_q.t()).float() * xs * wq_s).to(bf)
        o = F.scaled_dot_product_attention(q.view(b, n, h, hd).transpose(1, 2), k.transpose(1, 2),
                                           v.transpose(1, 2), scale=scale)
        o = o.transpose(1, 2).reshape(b * n, c)
        o_q, os_ = quantize_acts(o)
        return (torch._int_mm(o_q, wo_q.t()).float() * os_ * wo_s + bo).to(bf).view(b, n, c), o

    chain, o = unfused()
    detail = f"unfused rel err {(chain.float() - ref.float()).abs().max().item() / mag:.2e}"
    if peak_last:
        head_max = o.view(b * n, h, hd).abs().amax(-1)
        last = bool((head_max[:, -1] > head_max[:, :-1].amax(-1)).all())
        detail += f"; every row's max|o| in the last head: {last}"
        ok = ok and last
    nan = float("nan")
    res = {"kernel_ms": nan, "kernel_only_ms": nan, "plain_ms": nan, "library_ms": None,
           "bf16_ms": nan, "unfused_ms": nan}
    if timed:
        work = torch.empty(A._cross_int8_workspace_bytes(b, n, c, h), dtype=torch.uint8,
                           device="cuda")
        out2, o16, out16 = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
        res.update(kernel_ms=time_ms(lambda: A.fused_cross_attention_int8(*args), 10),
                   kernel_only_ms=time_ms(lambda: A.fused_cross_int8_kernel_call(
                       x, wq_q, wq_s, k, v, wo_q, wo_s, bo, work, out2, scale, h), 20),
                   plain_ms=time_ms(lambda: A.fused_cross_attention_int8_reference(*args), 3),
                   bf16_ms=time_ms(lambda: A.fused_cross_kernel_call(
                       x, wq, k, v, wo, bo, o16, out16, scale, h), 20),
                   unfused_ms=time_ms(unfused, 10))
        detail = (f"kernel_only_ms={res['kernel_only_ms']:.4f} bf16_ms={res['bf16_ms']:.4f} "
                  f"unfused_ms={res['unfused_ms']:.4f} {detail}")
    # int8: the two C x C projections; bf16: the attention over S keys.
    # Bytes: x in and out (bf16), the int8 weights, their f32 scales and bo, k and v
    nbytes = 2 * b * n * c * 2 + 2 * c * c + 3 * c * 4 + 2 * b * s * c * 2
    res.update(_bound(b * n * 4 * s * c, nbytes, exps=b * h * n * s,
                      int8_ops=b * n * 4 * c * c))
    tag = " max|o| in the last head" if peak_last else ""
    return f"fused_cross_attention_int8 C={c} N={n} B={b} H={h}{tag}", err, mag, 2e-2, ok, res, detail


def _case_geglu_int8(gen, m, c, timed=True, peak_last=False):
    """B6 (one C call: four kernels) against its plain version, on m rows of
    width c; its launch count must rise by one a call. `kernel_ms` is the
    wrapper's call, `kernel_only_ms` its C call alone on allocated operands,
    as B2's. No single PyTorch call
    computes it (library_ms None). Beside it, timed only and called by
    nothing in the port: `bf16_ms`, B3 (geglu_fwd) at the same shape on the
    bf16 weights, what quant="int8" has to beat; `unfused_ms`, the port's own
    int8 chain on cuBLASLt in eager PyTorch (quantize_acts -> torch._int_mm
    -> dequantize -> a * gelu(gate) -> quantize_acts -> torch._int_mm ->
    dequantize), whose distance from the plain version is logged. With
    peak_last, W1's a-half rows of the last 64 g columns are 30x larger, so
    that every row's max|g| lies in the last proj tile (a scale of g taken
    per tile would clip there)."""
    import torch
    from adaprompt_tpu_torch.ops import geglu as G
    from adaprompt_tpu_torch.ops.layers import gelu
    from adaprompt_tpu_torch.ops.quant import quantize_acts, quantize_weight
    f = 4 * c
    bf = torch.bfloat16
    u = lambda *shape, fan: ((torch.rand(*shape, device="cuda", generator=gen) * 2 - 1)
                             / math.sqrt(fan))
    x = torch.randn(m, c, device="cuda", generator=gen).to(bf)
    w1 = u(2 * f, c, fan=c).to(bf)
    if peak_last:
        w1[f - 64:f] *= 30
    b1 = u(2 * f, fan=c)
    w2, b2 = u(c, f, fan=f).to(bf), u(c, fan=f)
    (w1_q, w1_s), (w2_q, w2_s) = quantize_weight(w1), quantize_weight(w2)
    args = (x, w1_q, w1_s, b1, w2_q, w2_s, b2)
    before = G.geglu_int8.launches
    out = G.geglu_int8(*args)
    if G.geglu_int8.launches != before + 1:
        raise AssertionError(f"geglu_int8 counted {G.geglu_int8.launches - before} launches "
                             "for one call")
    ref = G.geglu_int8_reference(*args)
    err, mag, ok = _compare(out, ref, 2e-2)
    nan = float("nan")
    res = {"kernel_ms": nan, "kernel_only_ms": nan, "plain_ms": nan, "library_ms": None,
           "bf16_ms": nan, "unfused_ms": nan}
    detail = ""
    if timed:
        def unfused():
            x_q, xs = quantize_acts(x)
            h = torch._int_mm(x_q, w1_q.t()).float() * xs * w1_s + b1
            a, gate = h.chunk(2, dim=-1)
            g_q, gs = quantize_acts(a * gelu(gate))
            return (torch._int_mm(g_q, w2_q.t()).float() * gs * w2_s + b2).to(bf)

        unfused_err = (unfused().float() - ref.float()).abs().max().item() / mag
        work = torch.empty(G._int8_workspace_bytes(m, c, f), dtype=torch.uint8, device="cuda")
        out2 = torch.empty_like(x)
        res.update(kernel_ms=time_ms(lambda: G.geglu_int8(*args), 10),
                   kernel_only_ms=time_ms(lambda: G.geglu_int8_kernel_call(*args, work, out2), 20),
                   plain_ms=time_ms(lambda: G.geglu_int8_reference(*args), 3),
                   bf16_ms=time_ms(lambda: G.geglu_fwd(x, w1, b1, w2, b2), 10),
                   unfused_ms=time_ms(unfused, 10))
        detail = (f"kernel_only_ms={res['kernel_only_ms']:.4f} bf16_ms={res['bf16_ms']:.4f} "
                  f"unfused_ms={res['unfused_ms']:.4f} unfused rel err {unfused_err:.2e}")
    # 24*M*C^2 int8 operations; x in and out (bf16), the int8 weights (3*C*F
    # bytes), their f32 scales and the biases
    nbytes = 2 * m * c * 2 + 3 * c * f + 2 * (2 * f + c) * 4
    res.update(_bound(0, nbytes, exps=m * f, int8_ops=6 * m * c * f))
    tag = " max|g| in the last 64 columns" if peak_last else ""
    return f"geglu_int8 C={c} M={m}{tag}", err, mag, 2e-2, ok, res, detail


# B6's ragged cases (M, C), checked untimed: rows across the 128-row tile
# edge (and fewer than a tile), C = 32 and 64 (F = 128 and 256: two and four
# 64-column proj tiles, the a/gate interleave), C = 1280 (no cap on C or F),
# C = 640 at the UNet's row count
GEGLU_INT8_RAGGED = ((50, 320), (33, 640), (96, 32), (8, 64), (4096, 640), (127, 320),
                     (129, 320), (257, 320), (70, 1280))


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


CONV_FORMS = ("conv3x3_halo", "conv3x3_im2col")
CONV_KERNELS = ("conv3x3_halo_mma_kernel", "conv3x3_im2col_mma_kernel")    # their main kernels
# B8's and B9's phase-2 shapes: SD-1.5's three ResBlock widths at B=4, and a
# ragged one (C=200 ends a k chunk inside a tap, W=37 no tile's multiple)
CONV_SHAPES = ((4, 64, 64, 320, 320), (4, 32, 32, 640, 640), (4, 16, 16, 1280, 1280),
               (3, 23, 37, 200, 72))


def _case_conv(gen, fn_name, b, h, w, c, o):
    """conv3x3_halo or conv3x3_im2col against its plain version; library:
    F.conv2d (cuDNN) on the same bf16 NHWC tensors. The other form is timed
    on the same tensors too (`other_ms`), and the detail gives the kernel's
    time over F.conv2d's and over the other form's, and its k splits
    (conv_plan)."""
    import torch
    from adaprompt_tpu_torch.ops import conv_halo as CH
    from adaprompt_tpu_torch.ops.layers import conv2d
    x, weight, bias, _, _ = _conv_inputs(gen, b, h, w, c, o)
    fn, ref = getattr(CH, fn_name), getattr(CH, fn_name + "_reference")
    other_name = CONV_FORMS[1 - CONV_FORMS.index(fn_name)]
    other = getattr(CH, other_name)
    packed = CH.pack_conv_weight(weight)
    err, mag, ok = _compare(fn(x, weight, bias, packed=packed), ref(x, weight, bias), CONV_TOL)
    bias16 = bias.to(torch.bfloat16)
    res = {"kernel_ms": time_ms(lambda: fn(x, weight, bias, packed=packed), 10),
           "plain_ms": time_ms(lambda: ref(x, weight, bias), 3),
           "library_ms": time_ms(lambda: conv2d(x, weight, bias16), 10),
           "other_ms": time_ms(lambda: other(x, weight, bias, packed=packed), 10)}
    res.update(_conv_bound(b, h, w, c, o))
    plan = CH.conv_plan(fn_name.split("_")[1], b, h, w, c, o)
    detail = (f"{plan.splits} split(s), {plan.blocks} blocks; "
              f"{res['kernel_ms'] / res['library_ms']:.2f}x F.conv2d, "
              f"{res['kernel_ms'] / res['other_ms']:.2f}x {other_name} "
              f"({res['other_ms']:.4f} ms); "
              f"{18 * b * h * w * c * o / res['kernel_ms'] / 1e9:.0f} TFLOP/s")
    return f"{fn_name} H={h} W={w} C={c} O={o} B={b}", err, mag, CONV_TOL, ok, res, detail


def conv_resources():
    """Log B8's and B9's main kernels' resources at the three SD-1.5 shapes
    at B=4 and the ragged one, each with the k splits conv_plan picks there,
    from the runtime: registers a thread, shared memory a block, the tile,
    resident blocks an SM, blocks in the grid (checked against the plan's),
    local memory a thread."""
    import ctypes
    import torch
    from adaprompt_tpu_torch.ops import conv_halo as CH, cuda_build
    fn = cuda_build.function("conv_halo", "conv_halo_describe",
                             [ctypes.c_int] * 7 + [ctypes.c_void_p])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, h, w, c, o in CONV_SHAPES:
        halo, i2c = (CH.conv_plan(f, b, h, w, c, o, sms) for f in ("halo", "im2col"))
        info = (ctypes.c_int * 14)()
        cuda_build.check(fn(b, h, w, c, o, halo.splits, i2c.splits, ctypes.addressof(info)),
                         "conv_halo_describe")
        _log_kernels("conv3x3_halo/im2col", CONV_KERNELS, f"H={h} W={w} C={c} O={o} B={b} "
                     f"(splits {halo.splits} / {i2c.splits})", info)
        if (info[5], info[12]) != (halo.blocks, i2c.blocks):
            raise AssertionError(f"conv grids {info[5]}, {info[12]} != the plans' "
                                 f"{halo.blocks}, {i2c.blocks}")



GN_CONV_KERNELS = ("gn_silu_conv3x3_mma_kernel", "gn_silu_conv3x3_stats_kernel")
# B7's shapes: the fused table's three keys at B=4 (phase 8's UNet batch)
GN_CONV_SHAPES = ((4, 64, 320, 320), (4, 32, 320, 640), (4, 32, 960, 640))
# every ResBlock conv of the SD-1.5 UNet at 64x64 latents (H, C, O), as
# tests/test_torch_conv_halo.py lists them
SD15_RESBLOCK_SHAPES = ((64, 320, 320), (32, 320, 640), (32, 640, 640), (16, 640, 1280),
                        (16, 1280, 1280), (8, 1280, 1280), (8, 2560, 1280), (16, 2560, 1280),
                        (16, 1920, 1280), (32, 1920, 640), (32, 1280, 640), (32, 960, 640),
                        (64, 960, 320), (64, 640, 320))


def gn_conv_resources():
    """Log B7's conv and statistics kernels' resources at its three shapes,
    with the k splits conv_plan picks there, from the runtime: registers a
    thread, shared memory a block, the tile (the statistics: pixels and
    channels a block), resident blocks an SM, blocks in the grid (the conv's
    checked against the plan's), local memory a thread."""
    import ctypes
    import torch
    from adaprompt_tpu_torch.ops import conv_halo as CH, cuda_build
    fn = cuda_build.function("conv_halo", "gn_silu_conv_describe",
                             [ctypes.c_int] * 7 + [ctypes.c_void_p])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, h, c, o in GN_CONV_SHAPES:
        plan = CH.conv_plan("halo", b, h, h, c, o, sms)
        info = (ctypes.c_int * 14)()
        cuda_build.check(fn(b, h, h, c, o, 32, plan.splits, ctypes.addressof(info)),
                         "gn_silu_conv_describe")
        _log_kernels("gn_silu_conv3x3_halo", GN_CONV_KERNELS,
                     f"H={h} C={c} O={o} B={b} (splits {plan.splits})", info)
        if (info[5], info[12]) != (plan.blocks, b * 32):
            raise AssertionError(f"B7 grids {info[5]}, {info[12]} != {plan.blocks}, {b * 32}")


def _case_gn_conv(gen, b, h, c, o, gn_shift):
    """The fused GroupNorm-SiLU-conv B7 against its plain version; its launch
    count must rise by one a call. No single PyTorch call computes it
    (library_ms None). `kernel_ms` is the wrapper's call, `kernel_only_ms`
    its C call alone on allocated operands (statistics, conv, splits' sum),
    `stats_ms` the statistics kernel alone (device time, queued behind a
    spin: its host work outlasts it), `unfused_ms` the port's own unfused
    pair, layers.group_norm(..., "silu") + conv2d, the time to beat, and
    `halo_ms` B8's C call on the same x, weight and bias, the product loop
    B7 shares. With gn_shift > 0 the case also shows that an unmasked border
    would miss the bound."""
    import ctypes
    import torch
    import torch.nn.functional as F
    from adaprompt_tpu_torch.ops import conv_halo as CH, cuda_build
    from adaprompt_tpu_torch.ops.layers import conv2d, group_norm
    x, weight, bias, gs, gb = _conv_inputs(gen, b, h, h, c, o, gn_shift)
    packed = CH.pack_conv_weight(weight)
    fused = lambda: CH.gn_silu_conv3x3_halo(x, gs, gb, weight, bias, packed=packed)
    before = CH.gn_silu_conv3x3_halo.launches
    out = fused()
    if CH.gn_silu_conv3x3_halo.launches != before + 1:
        raise AssertionError(f"gn_silu_conv3x3_halo counted "
                             f"{CH.gn_silu_conv3x3_halo.launches - before} launches for one call")
    ref = CH.gn_silu_conv3x3_halo_reference(x, gs, gb, weight, bias)
    err, mag, ok = _compare(out, ref, CONV_TOL)
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
    plan = CH.conv_plan("halo", b, h, h, c, o)
    work = torch.empty(CH._gn_conv_workspace_bytes(b, h, h, c, o, 32, plan.splits),
                       dtype=torch.uint8, device="cuda")
    out2, out8 = torch.empty_like(out), torch.empty_like(out)
    part8 = torch.empty((plan.splits, b * h * h, o), device="cuda", dtype=torch.float32)
    fn8 = cuda_build.function("conv_halo", "conv3x3_halo_fwd",
                              [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream().cuda_stream
    halo = lambda: cuda_build.check(fn8(x.data_ptr(), packed.data_ptr(), bias.data_ptr(),
                                        out8.data_ptr(), part8.data_ptr(), b, h, h, c, o,
                                        plan.splits, stream), "conv3x3_halo_fwd")
    gs16, gb16, bias16 = (t.to(torch.bfloat16) for t in (gs, gb, bias))
    unfused = lambda: conv2d(group_norm(x, gs16, gb16, eps=1e-5, activation="silu"), weight, bias16)
    res = {"kernel_ms": time_ms(fused, 10),
           "kernel_only_ms": time_ms(lambda: CH.gn_silu_conv_kernel_call(
               x, gs, gb, packed, bias, work, out2, 32, 1e-5, plan.splits), 20),
           "plain_ms": time_ms(lambda: CH.gn_silu_conv3x3_halo_reference(x, gs, gb, weight, bias), 3),
           "library_ms": None,
           "unfused_ms": time_ms(unfused, 10),
           "stats_ms": device_ms(lambda: CH.gn_affine_kernel(x, gs, gb), 20),
           "halo_ms": time_ms(halo, 20)}
    if not torch.equal(out2, out):
        raise AssertionError("gn_silu_conv3x3_halo: the C call alone and the wrapper disagree")
    res.update(_conv_bound(b, h, h, c, o, extra_bytes=8 * c))
    detail += (f" {plan.splits} split(s), {plan.blocks} blocks; "
               f"kernel_only_ms={res['kernel_only_ms']:.4f} stats_ms={res['stats_ms']:.4f} "
               f"unfused_ms={res['unfused_ms']:.4f} halo_ms={res['halo_ms']:.4f}; "
               f"{res['kernel_ms'] / res['unfused_ms']:.2f}x unfused, C call "
               f"{res['kernel_only_ms'] / (res['halo_ms'] + res['stats_ms']):.2f}x B8 + stats; "
               f"{18 * b * h * h * c * o / res['kernel_only_ms'] / 1e9:.0f} TFLOP/s")
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


FLASH_INT8_KERNELS = ("flash_int8_key_sum_kernel", "flash_int8_key_quant_kernel",
                      "flash_fwd_int8_kernel")


def int8_flash_resources():
    """Log B10's three kernels' resources at the UNet's head dims, from the
    runtime: registers a thread, shared memory a block, rows a block (keys
    for the key pass), resident blocks an SM, local memory a thread."""
    import ctypes
    from adaprompt_tpu_torch.ops import cuda_build
    fn = cuda_build.function("flash_attention_int8", "flash_attention_int8_describe",
                             [ctypes.c_int, ctypes.c_void_p])
    for d in (40, 80):
        info = (ctypes.c_int * 15)()
        cuda_build.check(fn(d, ctypes.addressof(info)), "flash_attention_int8_describe")
        for k, name in enumerate(FLASH_INT8_KERNELS):
            i = info[5 * k:5 * k + 5]
            log(f"kernel flash_attention_int8 {name} D={d}: {i[0]} registers a thread, {i[1]} B "
                f"shared memory a block, {i[2]} {'keys' if k < 2 else 'query rows'} a block, "
                f"{i[3]} blocks an SM, {i[4]} B local memory a thread")


GEGLU_INT8_KERNELS = ("geglu_int8_quant_x_kernel", "geglu_int8_proj_kernel",
                      "geglu_int8_quant_g_kernel", "geglu_int8_out_kernel")


def geglu_resources():
    """Log B3's two kernels' resources at the UNet's two fused widths, from
    the runtime: registers a thread, shared memory a block, the tile, resident
    blocks an SM, blocks in the grid, local memory a thread."""
    import ctypes
    from adaprompt_tpu_torch.ops import cuda_build
    fn = cuda_build.function("geglu", "geglu_describe", [ctypes.c_int] * 3 + [ctypes.c_void_p])
    for m, c in ((UNET_BATCH * 4096, 320), (UNET_BATCH * 1024, 640)):
        info = (ctypes.c_int * 14)()
        cuda_build.check(fn(m, c, 4 * c, ctypes.addressof(info)), "geglu_describe")
        _log_kernels("geglu_fwd", ("geglu_proj_kernel", "geglu_out_kernel"), f"C={c} M={m}",
                         info)


def _log_kernels(wrapper, names, shape, info):
    """One line per kernel of a C call that launches several from its
    describe entry's info (seven values a kernel, in the order of names)."""
    for k, name in enumerate(names):
        i = info[7 * k:7 * k + 7]
        log(f"kernel {wrapper} {name} {shape}: {i[0]} registers a thread, {i[1]} B shared "
            f"memory a block, {i[2]} x {i[3]} tile, {i[4]} blocks an SM, {i[5]} blocks in the "
            f"grid, {i[6]} B local memory a thread")


def geglu_int8_resources():
    """Log B6's four kernels' resources at its four serving shapes, from the
    runtime: registers a thread, shared memory a block, the tile, resident
    blocks an SM, blocks in the grid, local memory a thread."""
    import ctypes
    from adaprompt_tpu_torch.ops import cuda_build
    fn = cuda_build.function("geglu_int8", "geglu_int8_describe",
                             [ctypes.c_int] * 3 + [ctypes.c_void_p])
    for m, c in ((4 * 2048, 320), (2 * 2048, 320), (4 * 1024, 640), (2 * 1024, 640)):
        info = (ctypes.c_int * 28)()
        cuda_build.check(fn(m, c, 4 * c, ctypes.addressof(info)), "geglu_int8_describe")
        _log_kernels("geglu_int8", GEGLU_INT8_KERNELS, f"C={c} M={m}", info)


CROSS_INT8_KERNELS = ("cross_int8_quant_x_kernel", "cross_int8_q_attn_kernel",
                      "cross_int8_quant_o_kernel", "cross_int8_out_kernel")


def cross_int8_resources():
    """Log B5's four kernels' resources at its four serving shapes, from the
    runtime: registers a thread, shared memory a block, the tile, resident
    blocks an SM, blocks in the grid, local memory a thread."""
    import ctypes
    from adaprompt_tpu_torch.ops import cuda_build
    fn = cuda_build.function("fused_cross_attention_int8", "fused_cross_int8_describe",
                             [ctypes.c_int] * 4 + [ctypes.c_void_p])
    for b, n, c in ((4, 4096, 320), (4, 1024, 640), (2, 4096, 320), (2, 1024, 640)):
        info = (ctypes.c_int * 28)()
        cuda_build.check(fn(b, n, c, 8, ctypes.addressof(info)), "fused_cross_int8_describe")
        _log_kernels("fused_cross_attention_int8", CROSS_INT8_KERNELS, f"C={c} N={n} B={b}", info)


def cross_resources():
    """Log B2's two kernels' resources at its four main-path shapes, from the
    runtime: registers a thread, shared memory a block, the tile, resident
    blocks an SM, blocks in the grid, local memory a thread."""
    import ctypes
    from adaprompt_tpu_torch.ops import cuda_build
    fn = cuda_build.function("fused_cross_attention", "fused_cross_describe",
                             [ctypes.c_int] * 4 + [ctypes.c_void_p])
    for b, n, c in ((UNET_BATCH, 4096, 320), (UNET_BATCH, 1024, 640), (2, 4096, 320),
                    (2, 1024, 640)):
        info = (ctypes.c_int * 14)()
        cuda_build.check(fn(b, n, c, 8, ctypes.addressof(info)), "fused_cross_describe")
        _log_kernels("fused_cross_attention", ("cross_q_attn_kernel", "cross_out_kernel"),
                         f"C={c} N={n} B={b}", info)


def self_resources():
    """Log B11's two kernels' resources at its four timed shapes (the two
    with and without a key bias share them) and at hd=160, from the
    runtime: registers a thread, shared memory a block, the tile, resident
    blocks an SM, blocks in the grid, local memory a thread."""
    import ctypes
    from adaprompt_tpu_torch.ops import cuda_build
    fn = cuda_build.function("fused_self_attention", "fused_self_describe",
                             [ctypes.c_int] * 4 + [ctypes.c_void_p])
    for b, n, c in ((UNET_BATCH, 4096, 320), (UNET_BATCH, 1024, 640), (2, 77, 1280)):
        info = (ctypes.c_int * 14)()
        cuda_build.check(fn(b, n, c, 8, ctypes.addressof(info)), "fused_self_describe")
        _log_kernels("fused_self_attention", ("self_q_attn_kernel", "self_out_kernel"),
                     f"C={c} N={n} B={b}", info)


def phase_kernels():
    """Returns {wrapper name: [per-shape results]} for the kernels line."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    flash_resources()
    int8_flash_resources()
    geglu_resources()
    cross_resources()
    self_resources()
    geglu_int8_resources()
    cross_int8_resources()
    conv_resources()
    gn_conv_resources()
    # (wrapper, the paths whose shapes these are, case): txt2img and the
    # compositional iterations have no img_mask, recon and distillation
    # training mask the self-attention keys (bias); the flash backward
    # without bias is the compositional step's (batch 4, as here). The
    # serving stack merges the 64x64 level's 4096 tokens to 2048 (ToMe 0.5)
    # for self-attention and the feed-forward, never for cross-attention,
    # and runs batch 4 in the CFG steps and batch 2 in the cond-only tail.
    gen_, train = ("generate",), ("train",)
    serve, s8 = ("serve_int8", "serve_bf16"), ("serve_int8",)
    # the product path is the txt2img UNet (batch 4) plus the fused convs,
    # whose three shapes are the keys of conv_halo._FUSED_TABLE
    pers = ("personalize",)
    gen_ = gen_ + pers
    compos = ("compos_filter", "compos")
    both = gen_ + train + compos
    from adaprompt_tpu_torch.ops.attention import FlashVariant as V
    cases = [("flash_attention_fwd", gen_ + compos, lambda: _case_flash(gen, 4096, 40, False)),
             ("flash_attention_fwd", train, lambda: _case_flash(gen, 4096, 40, True)),
             ("flash_attention_fwd", gen_ + serve + compos,
              lambda: _case_flash(gen, 1024, 80, False)),
             ("flash_attention_fwd", train, lambda: _case_flash(gen, 1024, 80, True)),
             ("flash_attention_fwd", serve, lambda: _case_flash(gen, 2048, 40, False)),
             ("flash_attention_bwd", ("compos",), lambda: _case_flash_bwd(gen, 4096, 40, False)),
             ("flash_attention_bwd", train, lambda: _case_flash_bwd(gen, 4096, 40, True)),
             ("flash_attention_bwd", ("compos",), lambda: _case_flash_bwd(gen, 1024, 80, False)),
             ("flash_attention_bwd", train, lambda: _case_flash_bwd(gen, 1024, 80, True)),
             ("fused_cross_attention", gen_ + ("serve_bf16",),
              lambda: _case_cross(gen, 4096, 320)),
             ("fused_cross_attention", gen_ + ("serve_bf16",),
              lambda: _case_cross(gen, 1024, 640)),
             ("fused_cross_attention", ("serve_bf16",), lambda: _case_cross(gen, 4096, 320, 2)),
             ("fused_cross_attention", ("serve_bf16",), lambda: _case_cross(gen, 1024, 640, 2)),
             ("geglu_fwd", both, lambda: _case_geglu(gen, UNET_BATCH * 4096, 320)),
             ("geglu_fwd", both + ("serve_bf16",),
              lambda: _case_geglu(gen, UNET_BATCH * 1024, 640)),
             ("geglu_fwd", ("serve_bf16",), lambda: _case_geglu(gen, UNET_BATCH * 2048, 320)),
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
    for h, c, o in SD15_RESBLOCK_SHAPES:
        if (4, h, c, o) in GN_CONV_SHAPES:
            continue
        cases.append(("gn_silu_conv3x3_halo", (),
                      lambda s=(h, c, o): _case_gn_conv(gen, 4, *s, 0.0)))
    for m_, c_ in GEGLU_RAGGED:
        cases.append(("geglu_fwd", (), lambda a=(m_, c_): _case_geglu(gen, *a, timed=False)))
    for m_, c_ in GEGLU_INT8_RAGGED:
        cases.append(("geglu_int8", (), lambda a=(m_, c_): _case_geglu_int8(gen, *a,
                                                                            timed=False)))
    cases.append(("geglu_int8", (), lambda: _case_geglu_int8(gen, 2048, 320, timed=False,
                                                             peak_last=True)))
    cases.append(("geglu_int8", (), lambda: _case_geglu_int8(gen, 1000, 640, timed=False,
                                                             peak_last=True)))
    for b_, n_, c_, h_ in CROSS_RAGGED:
        cases.append(("fused_cross_attention", (), lambda a=(n_, c_, b_, h_): _case_cross(
            gen, *a, timed=False)))
        cases.append(("fused_cross_attention_int8", (), lambda a=(n_, c_, b_), h=h_: (
            _case_cross_int8(gen, *a, timed=False, h=h))))
    cases.append(("fused_cross_attention_int8", (), lambda: _case_cross_int8(
        gen, 4096, 320, 2, timed=False, peak_last=True)))
    cases.append(("fused_cross_attention_int8", (), lambda: _case_cross_int8(
        gen, 1000, 640, 1, timed=False, peak_last=True)))
    # the two plain convs run on no path (wired nowhere, as in the JAX package)
    for fn_name in CONV_FORMS:
        for shape in CONV_SHAPES:
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
    for b_, n_, c_, h_, biased in SELF_RAGGED:
        cases.append(("fused_self_attention", (), lambda a=(n_, c_, biased), kw=dict(
            b=b_, h=h_): _case_self(gen, *a, timed=False, **kw)))
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
    context. Then the capture check on the same weights and inputs: the
    pass with capture_ca=True, the fg/bg regularizers of a recon step on
    its 12 captured score maps (a box fg mask, subject rows 5..20) added to
    the loss at the weight that gives their context gradient the card's
    norm of sum(eps * g)'s, card against CPU: the context gradient and each
    score map."""
    import torch
    from adaprompt_tpu_torch.models.unet import UNet
    from adaprompt_tpu_torch.ops.attention import FlashVariant
    from adaprompt_tpu_torch.ops.layers import randomize_zero_init, reset_parameters
    from adaprompt_tpu_torch.train import fgbg
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

    fg = torch.zeros(1, 64, 64, 1)
    fg[:, 16:48, 20:44] = 1.0
    rows = torch.arange(5, 21)[None]

    def capture_grad(model, dev, dt, eps_weight, reg_weight):
        c = ctx.to(dev, torch.float32).requires_grad_(True)
        eps, caps = model(x.to(dev, dt), ts.to(dev), c.to(dt)[None], img_mask=mask.to(dev),
                          capture_ca=True)
        scores = {li: v.float() for li, v in caps["attnscore"].items()}
        suppress = fgbg.calc_fg_bg_complementary_loss(scores, rows.to(dev), None, 1,
                                                      fg_grad_scale=0.1, fg_mask=fg.to(dev))[1]
        xlayer = fgbg.calc_fg_bg_xlayer_consist_loss(scores, rows.to(dev), None, 1)[0]
        (eps_weight * (eps.float() * g.to(dev)).sum() + reg_weight * (suppress + xlayer)).backward()
        return (c.grad.float().cpu(), {li: v.detach().cpu() for li, v in scores.items()},
                (suppress.item(), xlayer.item()))

    before = read_counts()
    t0 = time.perf_counter()
    card = context_grad(unet, "cuda", bf)
    card_s = time.perf_counter() - t0
    card_exp2 = context_grad(unet, "cuda", bf, dataclasses.replace(
        unet.cfg, flash_variant=FlashVariant(exp2=True)))
    counts = counts_since(before)
    before = read_counts()
    t0 = time.perf_counter()
    reg_card, scores_card, terms_card = capture_grad(unet, "cuda", bf, 0.0, 1.0)
    cap_s = time.perf_counter() - t0
    cap_counts = counts_since(before)
    reg_weight = (card.norm() / reg_card.norm()).item()
    cap_card = card + reg_weight * reg_card
    cpu = UNet(device="cpu", dtype=torch.float32)
    cpu.load_state_dict({k: v.float().cpu() for k, v in unet.state_dict().items()})
    del unet
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = context_grad(cpu, "cpu", torch.float32)
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cap_ref, scores_ref, terms_ref = capture_grad(cpu, "cpu", torch.float32, 1.0, reg_weight)
    cap_cpu_s = time.perf_counter() - t0
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
    rel_l2 = lambda a, b: ((a - b).norm() / b.norm()).item()
    rel_cap = rel_l2(cap_card, cap_ref)
    rel_scores = {li: rel_l2(scores_card[li], scores_ref[li]) for li in scores_ref}
    log(f"phase 4 capture: d(loss)/d(context) with the fg/bg terms (weight {reg_weight:.4e}) bf16 "
        f"card vs fp32 CPU relative L2 error {rel_cap:.4e}; attnscore maps "
        + ", ".join(f"{li}: {r:.4e}" for li, r in rel_scores.items())
        + f" (bound {UNET_GRAD_TOL:g} each); suppress, xlayer card {terms_card[0]:.6f}, "
        f"{terms_card[1]:.6f} CPU {terms_ref[0]:.6f}, {terms_ref[1]:.6f}; card {cap_s:.2f} s, "
        f"CPU {cap_cpu_s:.1f} s; launches {nz(cap_counts)}")
    if list(scores_card) != list(scores_ref) or len(scores_ref) != 12:
        raise AssertionError(f"captured layers {list(scores_card)} vs {list(scores_ref)}")
    for name, r in (("context gradient", rel_cap), *rel_scores.items()):
        if not (math.isfinite(r) and r <= UNET_GRAD_TOL):
            raise AssertionError(f"capture check: {name} on the card disagrees with the CPU: {r}")
    if not (terms_ref[0] > 0 and terms_ref[1] > 0 and math.isfinite(reg_weight)):
        raise AssertionError(f"capture check: regularizer terms {terms_ref}, weight {reg_weight}")
    # forward, its recompute and one backward; the capturing cross-attention is plain
    want = {n: 0 for n in cap_counts}
    want.update(flash_attention_fwd=20, flash_attention_bwd=FLASH_BWD_PER_PASS, geglu_fwd=20)
    if cap_counts != want:
        raise AssertionError(f"capture check launches {cap_counts}, expected {want}")


def vision_tower_check(seed: int = 7) -> dict:
    """One seeded 224x224 photo with a box fg mask through the full-width
    CLIP ViT-H/14 encode (fp32, random weights from `seed`) on the card and,
    with the same weights and input, on the CPU: the relative L2 errors of
    the second-to-last hidden states (what the zero-shot features read) and
    of pooled, the kernel launches of the card's pass (its attention takes
    the full pairwise mask and is plain), and the times."""
    import numpy as np
    import torch
    from adaprompt_tpu_torch.models.clip_vision import (CLIP_VIT_H14_VISION, CLIPVisionModel,
                                                        preprocess)
    cfg = CLIP_VIT_H14_VISION
    card = CLIPVisionModel.random_init(seed, cfg, device="cuda")
    n_params = sum(p.numel() for p in card.parameters())
    rng = np.random.default_rng(seed)
    photo = rng.integers(0, 256, (1, cfg.image_size, cfg.image_size, 3), dtype=np.uint8)
    mask = torch.zeros(1, cfg.image_size, cfg.image_size, 1)
    mask[:, 56:168, 70:154] = 1.0
    x = preprocess(photo, cfg.image_size, device="cuda")
    before = read_counts()
    with torch.no_grad():
        card.encode(x, attn_mask=mask.cuda())              # first call
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = card.encode(x, attn_mask=mask.cuda(), output_hidden_states=True)
        got = (out["hidden_states"][-2].cpu(), out["pooled"].cpu())
    card_s = time.perf_counter() - t0
    launches = counts_since(before)
    cpu = CLIPVisionModel(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    del card, out
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = cpu.encode(x.cpu(), attn_mask=mask, output_hidden_states=True)
    cpu_s = time.perf_counter() - t0
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    return {"hidden_states[-2]": rel(got[0], ref["hidden_states"][-2]),
            "pooled": rel(got[1], ref["pooled"]), "launches": nz(launches),
            "params_M": n_params / 1e6, "card_s": card_s, "cpu_s": cpu_s,
            "hidden_max": ref["hidden_states"][-2].abs().max().item()}


def phase_vision_check():
    """Phase 4, the vision-tower check: vision_tower_check within VISION_TOL."""
    t0 = time.perf_counter()
    r = vision_tower_check()
    log(f"phase 4 vision: CLIP ViT-H/14 ({r['params_M']:.1f} M parameters) fp32 card vs fp32 "
        f"CPU, 224x224 with a box fg mask: relative L2 error of hidden_states[-2] "
        f"{r['hidden_states[-2]']:.4e}, pooled {r['pooled']:.4e} (bound {VISION_TOL:g} each); "
        f"|hidden_states[-2]| max {r['hidden_max']:.3e}; card {r['card_s']:.3f} s (second "
        f"call), CPU {r['cpu_s']:.1f} s, the check {time.perf_counter() - t0:.1f} s all told; "
        f"launches {r['launches']}")
    for name in ("hidden_states[-2]", "pooled"):
        if not (math.isfinite(r[name]) and r[name] <= VISION_TOL):
            raise AssertionError(f"vision tower {name} on the card disagrees with the CPU: "
                                 f"{r[name]}")
    if r["launches"]:
        raise AssertionError(f"the vision tower launched kernels: {r['launches']}")


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
    by_path.update(phase_recon(tr, tmp.name))
    by_path.update(phase_compos(tr, tmp.name))
    by_path.update(phase_trainer_state(tr, tmp.name))
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


def _recon_turn(path, trainer, n_steps, after_update=None):
    """n_steps recon steps of `trainer` with the launch counts set to 0 just
    before: checks each step's metrics (finite, the cross-layer terms and the
    gradient norm > 0; under recon_bg the background term too) and the exact
    launches, logs them with s/step and peak memory. Calls after_update()
    after the first accumulated update. Returns the launch counts."""
    import torch
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2 ** 30    # every model and state held so far
    rows, times = [], []
    for i in range(n_steps):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        m = trainer.train_step(i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        rows.append({k: (float(v) if isinstance(v, torch.Tensor) else v) for k, v in m.items()})
        if after_update is not None and i == trainer.cfg.grad_accum - 1:
            after_update()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for r, sec in zip(rows, times):
        log(f"phase 10 {path} step {r['step']}: " + " ".join(
            f"{k}={r[k]:.6e}" for k in RECON_METRICS) + f" {sec:.3f} s")
    log(f"phase 10 {path}: {n_steps} recon steps bs 4 512x512 bf16 fgbg_reg in "
        f"{sum(times):.3f} s (step times {[round(sec, 3) for sec in times]}); peak memory "
        f"{peak:.2f} GiB ({resident:.2f} GiB held before the first step); "
        f"launches {nz(launches)}")
    iter_type = "recon_bg" if path == "recon_bg" else "recon"
    for r in rows:
        if not (r["iter_type"] == iter_type and all(math.isfinite(r[k]) for k in RECON_METRICS)
                and r["loss_fg_xlayer_consist"] > 0 and r["grad_norm"] > 0
                and (iter_type == "recon" or r["loss_bg_xlayer_consist"] > 0)):
            raise AssertionError(f"bad {path} metrics {r}")
    # a student pass, its recompute and one backward a step; the 77-key
    # cross-attention, capturing or under conv-attention, is plain
    want = {n: 0 for n in launches}
    want.update(flash_attention_fwd=20 * n_steps,
                flash_attention_bwd=FLASH_BWD_PER_PASS * n_steps, geglu_fwd=20 * n_steps)
    if launches != want:
        raise AssertionError(f"{path} launches {launches}, expected {want}")
    trainer._flush_metrics()
    return launches


def phase_recon(tr, out_dir):
    """Phase 10: zero-shot recon training through AdaPromptTrainer.train_step
    over phase 6's frozen models (student UNet, SD and Arc2Face CLIP-L, VAE)
    with a fresh SubjBasisGenerator from a seed: RECON_STEPS steps with the
    fg/bg regularizers, then RECON_CONV_STEPS with subject conv-attention
    (kernel size 3) over the same generator, then RECON_BG_STEPS with the
    background token (phase_recon_bg). Returns {path: launch counts}."""
    import torch
    from adaprompt_tpu_torch.adaface.subj_basis_generator import SUBJ_CONFIG, SubjBasisGenerator
    from adaprompt_tpu_torch.ops.layers import reset_parameters
    from adaprompt_tpu_torch.train.trainer import (AdaPromptTrainer, TrainerConfig,
                                                   synthetic_raw_batches)
    t0 = time.perf_counter()
    sbg = reset_parameters(SubjBasisGenerator(SUBJ_CONFIG, device="cuda"),
                           torch.Generator(device="cuda").manual_seed(5))
    cfg = TrainerConfig(seed=1, out_dir=out_dir, arc2face_distill_iter_prob=0.0, fgbg_reg=True)
    make = lambda c: AdaPromptTrainer(tr.frozen, tr.vae, tr.tokenizer, SUBJ_CONFIG, sbg,
                                      synthetic_raw_batches(1), c, synthetic_faces=True)
    rt = make(cfg)
    torch.cuda.synchronize()
    log(f"phase 10 recon trainer: built in {time.perf_counter() - t0:.1f} s")
    watched = {n: p.detach().clone() for n, p in sbg.named_parameters()
               if n in ("hidden_state_layer_weights", "prompt2token_proj.layers.11.mlp.fc2.weight",
                        "prompt2token_proj.token_embedding")}
    watched["emb_scales"] = rt.state.params["emb_scales"].detach().clone()
    moved = {}

    def check_moved():
        now = dict(sbg.named_parameters(), emb_scales=rt.state.params["emb_scales"])
        moved.update({n: not torch.equal(p, now[n]) for n, p in watched.items()})

    by_path = {"recon": _recon_turn("recon", rt, RECON_STEPS, check_moved)}
    conv = make(dataclasses.replace(cfg, use_conv_attn_kernel_size=3))
    by_path["recon_conv"] = _recon_turn("recon_conv", conv, RECON_CONV_STEPS)
    log(f"phase 10 SubjBasisGenerator and emb_scales moved after the first update: {moved}")
    if not (moved and all(moved.values())):
        raise AssertionError(f"recon steps left parameters unmoved: {moved}")
    del rt, conv
    by_path["recon_bg"] = phase_recon_bg(tr, sbg, out_dir)
    return by_path


class _Timed:
    """Wraps a callable (a zero-shot feature extractor, a teacher filter, a
    scorer): each call is timed (synchronized before and after) and the
    kernels launched inside it are counted."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kwargs):
        import torch
        torch.cuda.synchronize()
        before, t0 = read_counts(), time.perf_counter()
        out = self.fn(*args, **kwargs)
        torch.cuda.synchronize()
        self.calls.append((time.perf_counter() - t0, nz(counts_since(before))))
        return out


def phase_recon_bg(tr, sbg, out_dir):
    """Phase 10, recon_bg: a trainer over the same frozen models and subject
    generator with the background branch: a full-width CLIP ViT-H/14 (fp32,
    random weights from a seed) behind a ZeroShotFeatureExtractor, a seeded
    background SubjBasisGenerator over its [B, 2 x 257, 1280] features, and
    use_background_token_prob=1, so that each of RECON_BG_STEPS steps is a
    "recon_bg" step; checks its metrics and launches (none inside the
    extractor) and that both generators and emb_scales[1] moved. Returns
    the launch counts."""
    import torch
    from adaprompt_tpu_torch.adaface.subj_basis_generator import (SUBJ_CONFIG, SubjBasisConfig,
                                                                  SubjBasisGenerator)
    from adaprompt_tpu_torch.adaface.zs_features import ZeroShotFeatureExtractor
    from adaprompt_tpu_torch.models.clip_vision import CLIP_VIT_H14_VISION, CLIPVisionModel
    from adaprompt_tpu_torch.ops.layers import reset_parameters
    from adaprompt_tpu_torch.train.trainer import (AdaPromptTrainer, TrainerConfig,
                                                   synthetic_raw_batches)
    t0 = time.perf_counter()
    vision = CLIPVisionModel.random_init(8, CLIP_VIT_H14_VISION, device="cuda")
    # the zero-shot features concatenate the fg and the bg pass: 2 x 257 rows
    bg_cfg = SubjBasisConfig(placeholder_is_bg=True, num_out_embs_per_layer=4,
                             num_id_vecs_bg=2 * CLIP_VIT_H14_VISION.seq_len)
    bg = reset_parameters(SubjBasisGenerator(bg_cfg, device="cuda"),
                          torch.Generator(device="cuda").manual_seed(9))
    ext = _Timed(ZeroShotFeatureExtractor(vision))
    cfg = TrainerConfig(seed=2, out_dir=out_dir, arc2face_distill_iter_prob=0.0, fgbg_reg=True)
    bt = AdaPromptTrainer(tr.frozen, tr.vae, tr.tokenizer, SUBJ_CONFIG, sbg,
                          synthetic_raw_batches(2), cfg, synthetic_faces=True,
                          bg_basis_cfg=bg_cfg, bg_params=bg, zs_extractor=ext,
                          use_background_token_prob=1.0)
    torch.cuda.synchronize()
    log(f"phase 10 recon_bg trainer: built in {time.perf_counter() - t0:.1f} s; CLIP ViT-H/14 "
        f"{sum(p.numel() for p in vision.parameters()) / 1e6:.1f} M parameters (fp32), "
        f"background generator {sum(p.numel() for p in bg.parameters()) / 1e6:.2f} M")
    watched = {("bg_basis", n): p.detach().clone() for n, p in bg.named_parameters()
               if n in ("bg_proj_in.weight", "latent_queries", "pos_embs",
                        "prompt_translator.to_v.weight")}
    watched[("subj_basis", "hidden_state_layer_weights")] = \
        sbg.hidden_state_layer_weights.detach().clone()
    watched[("emb_scales", "1")] = bt.state.params["emb_scales"][1].detach().clone()
    moved = {}

    def check_moved():
        now = {("bg_basis", n): p for n, p in bg.named_parameters()}
        now[("subj_basis", "hidden_state_layer_weights")] = sbg.hidden_state_layer_weights
        now[("emb_scales", "1")] = bt.state.params["emb_scales"][1]
        moved.update({".".join(k): not torch.equal(p, now[k]) for k, p in watched.items()})

    launches = _recon_turn("recon_bg", bt, RECON_BG_STEPS, check_moved)
    times = [round(sec, 4) for sec, _ in ext.calls]
    log(f"phase 10 recon_bg extractor: {len(ext.calls)} calls (4 images 512x512 -> 224, fg and "
        f"bg ViT-H/14 passes; the first also the zero image's) in {times} s; launches inside "
        f"{[c for _, c in ext.calls]}")
    log(f"phase 10 recon_bg generators and emb_scales[1] moved after the first update: {moved}; "
        f"the part {time.perf_counter() - t0:.1f} s all told")
    if len(ext.calls) != RECON_BG_STEPS or any(c for _, c in ext.calls):
        raise AssertionError(f"extractor calls {ext.calls}: expected {RECON_BG_STEPS}, "
                             "launching no kernel")
    if not (moved and all(moved.values())):
        raise AssertionError(f"recon_bg steps left parameters unmoved: {moved}")
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
            f"{peak:.3f} GiB; image std {imgs.std():.2f}; launches {nz(launches[path])}")
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


def _step_timed(trainer, step_idx):
    import torch
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    m = trainer.train_step(step_idx)
    torch.cuda.synchronize()
    row = {k: (float(v) if isinstance(v, torch.Tensor) else v) for k, v in m.items()}
    return row, time.perf_counter() - t1


def phase_compos(tr, out_dir):
    """Phase 11: Stage-2 compositional iterations through
    AdaPromptTrainer.train_step over phase 6's frozen models and a fresh
    seeded SubjBasisGenerator. (a) the CLIP teacher filter: a trainer with
    a ViT-B/32 CLIPScorer (random weights) takes train_step(3); (b) a
    trainer with no_teacher_filter=True takes train_step(3) (fresh) and
    train_step(6) (reuse). Returns {path: launch counts}."""
    import torch
    from adaprompt_tpu_torch.adaface.subj_basis_generator import SUBJ_CONFIG, SubjBasisGenerator
    from adaprompt_tpu_torch.eval.clip_scorer import CLIPScorer
    from adaprompt_tpu_torch.ops.layers import reset_parameters
    from adaprompt_tpu_torch.train.trainer import (AdaPromptTrainer, TrainerConfig,
                                                   synthetic_raw_batches)
    t0 = time.perf_counter()
    sbg = reset_parameters(SubjBasisGenerator(SUBJ_CONFIG, device="cuda"),
                           torch.Generator(device="cuda").manual_seed(11))
    scorer = CLIPScorer.random_init(12, tr.tokenizer, device="cuda")
    scorer_calls = _Timed(scorer.txt_to_img_similarity)
    scorer.txt_to_img_similarity = scorer_calls
    make = lambda cfg, scorer: AdaPromptTrainer(
        tr.frozen, tr.vae, tr.tokenizer, SUBJ_CONFIG, sbg, synthetic_raw_batches(3), cfg,
        synthetic_faces=True, clip_scorer=scorer)
    ft = make(TrainerConfig.stage2(grad_accum=2, seed=3, out_dir=out_dir), scorer)
    filter_calls = _Timed(ft._teacher_filter)
    ft._teacher_filter = filter_calls
    torch.cuda.synchronize()
    log(f"phase 11 filter trainer: built in {time.perf_counter() - t0:.1f} s; CLIPScorer ViT-B/32 "
        f"{sum(p.numel() for p in scorer.parameters()) / 1e6:.1f} M parameters (fp32)")

    # (a) the filter: one fresh compositional iteration
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    row, sec = _step_timed(ft, COMPOS_STEPS[0])
    launches_filter = read_counts()
    ft._flush_metrics()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    (f_sec, f_launch), = filter_calls.calls
    (s_sec, s_launch), = scorer_calls.calls
    teachable = row["iter_type"] == "compos_distill"
    log(f"phase 11 compos_filter step {COMPOS_STEPS[0]}: {row['iter_type']} "
        f"loss_clip_subj_comp={row['loss_clip_subj_comp']:.6e} "
        f"loss_clip_cls_comp={row['loss_clip_cls_comp']:.6e} teachable={row['teachable']} "
        f"teachable_frac={row['teachable_frac']} in {sec:.3f} s (the filter {f_sec:.3f} s: 2 "
        f"candidates, UNet batch 4 + VAE decode of 4 at 512x512, the scorer {s_sec:.3f} s); "
        f"peak memory {peak:.2f} GiB; launches {nz(launches_filter)}; inside the filter "
        f"{f_launch}, inside the scorer {s_launch}")
    if not all(math.isfinite(row[k]) for k in ("loss_clip_subj_comp", "loss_clip_cls_comp")):
        raise AssertionError(f"bad filter metrics {row}")
    if row["teachable"] != float(teachable) or row["teachable_frac"] != float(teachable):
        raise AssertionError(f"the filter's decision and its counters disagree: {row}")
    want = {n: 0 for n in launches_filter}
    want.update(flash_attention_fwd=10, geglu_fwd=10)          # one conditional UNet pass
    if f_launch != nz(want) or s_launch:
        raise AssertionError(f"filter launches {f_launch}, scorer {s_launch}: expected "
                             f"{nz(want)} and none")
    if teachable:                        # the with-gradient step followed
        want.update(flash_attention_fwd=30, geglu_fwd=30, flash_attention_bwd=FLASH_BWD_PER_PASS)
    if launches_filter != want:
        raise AssertionError(f"compos_filter launches {launches_filter}, expected {want}")
    del ft, filter_calls

    # (b) the train phase: a fresh iteration, then its reuse
    tt = make(TrainerConfig.stage2(grad_accum=2, seed=4, out_dir=out_dir, no_teacher_filter=True),
              None)
    tt._ensure_compos()
    ts_seen = []
    real_phase = tt._compos_phase

    def phase(state, mp, batch, gen):
        ts_seen.append(batch["t"].tolist())
        return real_phase(state, mp, batch, gen)

    tt._compos_phase = phase
    watched = {n: p.detach().clone() for n, p in sbg.named_parameters()
               if n in ("hidden_state_layer_weights", "prompt2token_proj.layers.11.mlp.fc2.weight",
                        "prompt2token_proj.token_embedding")}
    watched["emb_scales"] = tt.state.params["emb_scales"].detach().clone()
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    rows, times = [], []
    for i in COMPOS_STEPS:
        r, sec = _step_timed(tt, i)
        rows.append(r)
        times.append(sec)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    now = dict(sbg.named_parameters(), emb_scales=tt.state.params["emb_scales"])
    moved = {n: not torch.equal(p, now[n]) for n, p in watched.items()}
    for r, sec, ts in zip(rows, times, ts_seen):
        log(f"phase 11 compos step {r['step']}: t={ts} " + " ".join(
            f"{k}={r[k]:.6e}" for k in COMPOS_METRICS + ("grad_norm",)) + f" {sec:.3f} s")
    bn = tt.ca_q_bn_stats
    log(f"phase 11 compos: {len(COMPOS_STEPS)} compositional steps (UNet batch 4, 512x512, bf16, "
        f"fresh then reuse) in {sum(times):.3f} s (step times {[round(x, 3) for x in times]}); "
        f"peak memory {peak:.2f} GiB ({resident:.2f} GiB held before the first step); "
        f"generator and emb_scales moved after the update: {moved}; ca_q_bn_stats layers "
        f"{sorted(bn)}; launches {nz(launches)}; the phase {time.perf_counter() - t0:.1f} s "
        f"all told")
    for r in rows:
        if not (r["iter_type"] == "compos_distill" and r["teacher_filter_disabled"] == 1.0
                and all(math.isfinite(r[k]) for k in COMPOS_METRICS) and r["grad_norm"] > 0
                and r["loss_fg_xlayer_consist"] > 0 and r["loss_comp_fg_bg_preserve"] > 0):
            raise AssertionError(f"bad compos metrics {r}")
    fresh_t, reuse_t = ts_seen
    if not (len(set(fresh_t)) == 1 and 800 <= fresh_t[0] < 1000
            and all(400 <= x < 700 for x in reuse_t)):
        raise AssertionError(f"t of the fresh {fresh_t} and the reuse {reuse_t} iteration")
    if not all(moved.values()):
        raise AssertionError(f"compos steps left parameters unmoved: {moved}")
    if sorted(bn) != [7, 8, 12, 16, 17, 18, 19, 20, 21, 22, 23, 24] or not all(
            torch.isfinite(v).all() for ent in bn.values() for v in ent.values()):
        raise AssertionError(f"ca_q_bn_stats layers {sorted(bn)}")
    # a student pass (no key bias), its recompute and one backward a step
    n = len(COMPOS_STEPS)
    want = {k: 0 for k in launches}
    want.update(flash_attention_fwd=20 * n, flash_attention_bwd=FLASH_BWD_PER_PASS * n,
                geglu_fwd=20 * n)
    if launches != want:
        raise AssertionError(f"compos launches {launches}, expected {want}")
    tt._flush_metrics()
    return {"compos_filter": launches_filter, "compos": launches}


# ---------------------------------------------------------------------------
# Phase 12: the rest of the trainer (full-state resume, AdamW with EMA, the
# static textual-inversion step, the sample grid)
# ---------------------------------------------------------------------------

RESUME_STEPS = 2        # rerun after the save, then after each of RESUMED_RUNS loads
RESUMED_RUNS = 5
SAMPLE_STEPS = 20       # log_samples: DDIM-20, n = 2 (UNet batch 4 with CFG), 512x512
STATIC_STEPS = 2        # K = 16 vectors at D = 768, one accumulated Prodigy update


def _sbg_snapshot(sbg):
    return {n: p.detach().clone() for n, p in sbg.named_parameters()}


def _max_diff(a, b):
    return max(float((a[n].float() - b[n].float()).abs().max()) for n in a)


def _resume_run(tr, raws, first_step):
    """RESUME_STEPS steps of `tr` on the captured raw batches: the metrics
    (tensors as floats), the numpy stream's and the device generator's state
    after each step, and the generator's parameters after the last."""
    import torch
    tr.batch_iterator = iter(list(raws))
    rows, states = [], []
    for i in range(RESUME_STEPS):
        r, _ = _step_timed(tr, first_step + i)
        rows.append({k: v for k, v in r.items() if k not in ("step_time_s", "device_mem_gb",
                                                              "device_peak_mem_gb")})
        states.append((json.dumps(tr.rng.bit_generator.state), bytes(tr.gen.get_state().numpy())))
    torch.cuda.synchronize()
    return rows, states, _sbg_snapshot(tr.state.params["subj_basis"])


def phase_resume(tr, step0):
    """(a) The full state of phase 6's trainer on the card: save, take
    RESUME_STEPS steps on captured raw batches; then RESUMED_RUNS times,
    load and take them again. The iteration types, the host draws, the
    generator states and the first step's loss must be equal bit for bit in
    all runs (the forward is deterministic from equal parameters and draws);
    the first step applies an accumulated update, so what follows differs
    only by B4's dq atomics: the unresumed run must stay as close to the
    first resumed one, in the second step's loss and in every parameter, as
    4x the resumed runs' own spread, the largest over their pairs (with a
    floor of 1e-7 of the loss and two ulps of the largest parameter). Two
    resumed runs alone can happen to sum alike (a spread of 7e-8 against
    1e-5 to 7e-5 in other runs) and make the bound a draw: five runs make ten
    pairs (three still left a run 7 % inside its bound).
    Returns the resumed run's launch counts."""
    import os
    import torch
    step = step0
    if tr.state.optimizer.mini_step == 0:       # save where the next step applies an update
        _step_timed(tr, step)
        step += 1
    tr._flush_metrics()
    source = tr.batch_iterator
    raws = [next(source) for _ in range(RESUME_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = tr.save_full_state(step)
    save_s = time.perf_counter() - t0
    size_gb = os.path.getsize(path) / 2 ** 30
    n_params = sum(p.numel() for p in tr.state.params["subj_basis"].parameters())
    torch.cuda.reset_peak_memory_stats()
    runs, loads, counts = [_resume_run(tr, raws, step)], [], []
    for _ in range(RESUMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        meta = tr.load_full_state(path)
        torch.cuda.synchronize()
        loads.append(time.perf_counter() - t0)
        if meta["step"] != step or tr.state.optimizer.mini_step != 1:
            raise AssertionError(f"load_full_state: meta step {meta['step']}, mini_step "
                                 f"{tr.state.optimizer.mini_step}")
        zero_counts()
        runs.append(_resume_run(tr, raws, step))
        counts.append(read_counts())
    launches = counts[0]                  # the path's counted run: the first resumed one
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tr.batch_iterator = source
    os.remove(path)
    (rows0, st0, p0), (rows1, st1, p1) = runs[:2]
    key = "loss_arc2face_distill"
    pairs = [(a, b) for i, a in enumerate(runs[1:]) for b in runs[i + 2:]]
    spread_loss = max(abs(a[0][1][key] - b[0][1][key]) for a, b in pairs)
    spread_params = max(_max_diff(a[2], b[2]) for a, b in pairs)
    diff_loss = abs(rows0[1][key] - rows1[1][key])
    diff_params = _max_diff(p0, p1)
    # 4x the resumed runs' spread, and a floor: 1e-7 of the loss, two ulps
    # of the largest parameter (a lost optimizer slot or D moves the update
    # itself, ~1e-5 here, far above either)
    bound_loss = 4 * spread_loss + 1e-7 * abs(rows1[1][key])
    ulp = max(float(torch.finfo(torch.float32).eps * v.abs().max()) for v in p1.values())
    bound_params = 4 * spread_params + 2 * ulp
    log(f"phase 12 resume: state of {n_params / 1e6:.1f} M trainable parameters, "
        f"{size_gb:.3f} GiB, saved in {save_s:.3f} s, loaded in {[round(x, 3) for x in loads]} s; "
        f"peak memory {peak:.2f} GiB")
    for i, (rows, _, _) in enumerate(runs):
        name = "unresumed" if i == 0 else f"resumed {i}"
        log(f"phase 12 resume {name}: " + "; ".join(
            f"step {r['step']} {r['iter_type']} ND={r['num_denoising_steps']} {key}={r[key]!r} "
            f"grad_norm={r['grad_norm']!r}" for r in rows))
    log(f"phase 12 resume second step: |unresumed - resumed| loss {diff_loss:.4e}, parameters "
        f"{diff_params:.4e}; the {RESUMED_RUNS} resumed runs' spread (B4's dq atomics) loss "
        f"{spread_loss:.4e}, "
        f"parameters {spread_params:.4e}; bounds: loss {bound_loss:.4e} (4 x spread + 1e-7 x "
        f"loss), parameters {bound_params:.4e} (4 x spread + 2 ulps of the largest, "
        f"{ulp:.3e}); launches {nz(launches)}")
    for rows, st, _ in runs[1:]:
        if [(r["iter_type"], r.get("num_denoising_steps")) for r in rows] != \
                [(r["iter_type"], r.get("num_denoising_steps")) for r in rows0] or st != st0:
            raise AssertionError("a resumed run took other iterations or host/device draws")
        if rows[0][key] != rows0[0][key]:
            raise AssertionError(f"the first resumed step's loss {rows[0][key]!r} is not the "
                                 f"unresumed one's {rows0[0][key]!r}")
    if not (diff_loss <= bound_loss and diff_params <= bound_params):
        raise AssertionError("the resumed run strays from the unresumed one beyond the runs' "
                             "own spread")
    # per step at ND 1: a teacher pass, a student pass and its recompute; one backward
    want = {n: 0 for n in launches}
    want.update(flash_attention_fwd=30 * RESUME_STEPS,
                flash_attention_bwd=FLASH_BWD_PER_PASS * RESUME_STEPS, geglu_fwd=30 * RESUME_STEPS)
    if launches != want:
        raise AssertionError(f"resume launches {launches}, expected {want}")
    return launches, step + RESUME_STEPS


def phase_adamw_ema(tr, out_dir):
    """(b) A trainer over phase 6's frozen models and a fresh seeded
    SubjBasisGenerator with optimizer_type="AdamW" and use_ema=True takes an
    accumulating and an applying step (ND 1): the parameters move only on the
    second, the EMA counts 2 updates and its shadow is LitEma's formula on a
    host copy, and the checkpoint holds ema_subj_basis. Returns the launches."""
    import numpy as np
    import torch
    from adaprompt_tpu_torch.adaface.subj_basis_generator import SUBJ_CONFIG, SubjBasisGenerator
    from adaprompt_tpu_torch.ops.layers import reset_parameters
    from adaprompt_tpu_torch.train.ema import ema_decay_at
    from adaprompt_tpu_torch.train.trainer import (AdaPromptTrainer, TrainerConfig,
                                                   synthetic_raw_batches)
    t0 = time.perf_counter()
    sbg = reset_parameters(SubjBasisGenerator(SUBJ_CONFIG, device="cuda"),
                           torch.Generator(device="cuda").manual_seed(13))
    cfg = TrainerConfig(seed=6, out_dir=out_dir, optimizer_type="AdamW", use_ema=True,
                        max_num_denoising_steps=1)
    at = AdaPromptTrainer(tr.frozen, tr.vae, tr.tokenizer, SUBJ_CONFIG, sbg,
                          synthetic_raw_batches(6), cfg, synthetic_faces=True)
    host = lambda t: t.detach().float().cpu().numpy()
    shadow = {n: host(v) for n, v in at.ema.shadow.items()}
    params0 = {n: host(p) for n, p in sbg.named_parameters()}
    watched = ("hidden_state_layer_weights", "prompt2token_proj.layers.11.mlp.fc2.weight",
               "prompt2token_proj.token_embedding")
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    rows, times, moved = [], [], []
    for i in range(2):
        r, sec = _step_timed(at, i)
        rows.append(r)
        times.append(sec)
        now = {n: host(p) for n, p in sbg.named_parameters()}
        moved.append({n for n in now if not np.array_equal(now[n], params0[n])})
        # LitEma on the host: the count incremented first, then the decay
        c = np.float32(1.0) - ema_decay_at(i + 1, cfg.ema_decay)
        now["emb_scales"] = host(at.state.params["emb_scales"])
        shadow = {n: s - (s - now[n.split("subj_basis.", 1)[-1]]) * c for n, s in shadow.items()}
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ema_err = max(float(np.abs(host(at.ema.shadow[n]) - s).max()) for n, s in shadow.items())
    ckpt = np.load(at.save_checkpoint(2))
    ema_keys = [k for k in ckpt.files if k.startswith("ema_subj_basis/")]
    log(f"phase 12 adamw_ema: 2 steps (AdamW, b2 0.993, EMA decay {cfg.ema_decay}) in "
        f"{[round(x, 3) for x in times]} s; losses {[r['loss_arc2face_distill'] for r in rows]}; "
        f"parameters moved after each step {[len(m) for m in moved]} of {len(params0)}; EMA "
        f"num_updates {at.ema.num_updates}, max |shadow - host LitEma| {ema_err:.3e}; checkpoint "
        f"ema_subj_basis entries {len(ema_keys)}; peak memory {peak:.2f} GiB; built and run in "
        f"{time.perf_counter() - t0:.1f} s; launches {nz(launches)}")
    if moved[0] or not set(watched) <= moved[1]:
        raise AssertionError(f"parameters moved {moved}: expected none, then {watched}")
    if at.ema.num_updates != 2 or ema_err > 1e-6:
        raise AssertionError(f"EMA count {at.ema.num_updates}, |shadow - LitEma| {ema_err}")
    if len(ema_keys) != len(params0) or not all(
            np.isfinite(r["loss_arc2face_distill"]) and r["grad_norm"] > 0 for r in rows):
        raise AssertionError(f"checkpoint ema_subj_basis {len(ema_keys)} entries, rows {rows}")
    want = {n: 0 for n in launches}
    want.update(flash_attention_fwd=60, flash_attention_bwd=2 * FLASH_BWD_PER_PASS, geglu_fwd=60)
    if launches != want:
        raise AssertionError(f"adamw_ema launches {launches}, expected {want}")
    at._flush_metrics()
    return launches


def phase_static(tr):
    """(c) The static textual-inversion step over phase 6's frozen UNet and
    text encoder: a StaticLayerwiseEmbedding with K = 16 at D = 768 takes
    STATIC_STEPS steps on a recon batch with its augmentation mask (so B1 and
    B4 take the key bias); its parameters move. Returns the launches."""
    import torch
    from adaprompt_tpu_torch.adaface.static_embedder import (StaticEmbedderConfig,
                                                             StaticLayerwiseEmbedding)
    from adaprompt_tpu_torch.train import steps as steps_mod
    from adaprompt_tpu_torch.train.trainer import TrainerConfig, build_optimizer, \
        make_static_recon_step
    scfg = StaticEmbedderConfig(num_vectors=16, out_emb_dim=768)
    emb = StaticLayerwiseEmbedding(scfg, torch.Generator(device="cuda").manual_seed(14),
                                   device="cuda")
    params = {"static_emb": emb}
    state = steps_mod.TrainState(params, build_optimizer(
        TrainerConfig(), steps_mod.trainable_parameters(params)))
    step = make_static_recon_step(tr.frozen, scfg)
    batch = tr.prepare_recon_batch(next(tr.batch_iterator))
    if not (batch["aug_mask"] == 0).any():
        raise AssertionError("the recon batch's augmentation mask masks nothing")
    before = {n: p.detach().clone() for n, p in emb.named_parameters()}
    gen = torch.Generator(device="cuda").manual_seed(15)
    zero_counts()
    rows, times = [], []
    for _ in range(STATIC_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step(state, tr._fp, batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        rows.append({k: float(v) for k, v in m.items()})
    launches = read_counts()
    moved = {n: not torch.equal(p, before[n]) for n, p in emb.named_parameters()}
    log(f"phase 12 static_recon: {STATIC_STEPS} steps (StaticLayerwiseEmbedding L 16 K 16 D 768, "
        f"{sum(p.numel() for p in emb.parameters()) / 1e6:.3f} M parameters, bs 4 512x512 bf16, "
        f"aug_mask) in {[round(x, 3) for x in times]} s; {rows}; moved {moved}; "
        f"launches {nz(launches)}")
    if not all(all(math.isfinite(v) for v in r.values()) and r["grad_norm"] > 0 for r in rows):
        raise AssertionError(f"bad static recon metrics {rows}")
    if not all(moved.values()):
        raise AssertionError(f"the static embedder did not move: {moved}")
    # a student pass with key bias, its recompute and one backward a step
    want = {n: 0 for n in launches}
    want.update(flash_attention_fwd=20 * STATIC_STEPS,
                flash_attention_bwd=FLASH_BWD_PER_PASS * STATIC_STEPS,
                geglu_fwd=20 * STATIC_STEPS)
    if launches != want:
        raise AssertionError(f"static_recon launches {launches}, expected {want}")
    return launches


def phase_log_samples(tr, step):
    """(d) log_samples on phase 6's trainer: DDIM-20 of 2 images at 512x512
    through PromptConditioner and the trainer's own frozen models; the strip
    [512, 1024, 3] read back through the port's PNG reader equals the array
    written.
    Returns the launches."""
    import numpy as np
    import torch
    from adaprompt_tpu_torch.utils import png
    from adaprompt_tpu_torch.utils.png import read_png
    written, write = [], png.write_png
    png.write_png = lambda path, img: (written.append(np.array(img)), write(path, img))[1]
    try:
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = tr.log_samples(step, num_steps=SAMPLE_STEPS)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = read_counts()
        t0 = time.perf_counter()
        tr.log_samples(step + 1, num_steps=SAMPLE_STEPS)   # the pipeline built: timed again
        torch.cuda.synchronize()
        again = time.perf_counter() - t0
    finally:
        png.write_png = write
    strip = read_png(path)
    log(f"phase 12 log_samples: DDIM-{SAMPLE_STEPS} n=2 512x512 bf16 in {sec:.3f} s (again "
        f"{again:.3f} s); strip {strip.shape}, std {strip.std():.2f}; launches {nz(launches)}")
    if strip.shape != (512, 1024, 3) or not np.array_equal(strip, written[0]):
        raise AssertionError(f"the PNG strip {strip.shape} is not the array written")
    if strip.std() < 1.0:
        raise AssertionError("the sample strip is flat")
    # CFG over n = 2: one UNet evaluation of batch 4 a step, 10 layers of each kernel
    want = {n: 0 for n in launches}
    want.update(flash_attention_fwd=10 * SAMPLE_STEPS, fused_cross_attention=10 * SAMPLE_STEPS,
                geglu_fwd=10 * SAMPLE_STEPS)
    if launches != want:
        raise AssertionError(f"log_samples launches {launches}, expected {want}")
    return launches


def phase_trainer_state(tr, out_dir):
    """Phase 12, right after phase 11, over phase 6's trainer and frozen
    models: (a) full-state resume, (b) AdamW with EMA, (c) the static recon
    step, (d) log_samples. Returns {path: launch counts}."""
    t0 = time.perf_counter()
    by_path = {}
    by_path["resume"], step = phase_resume(tr, 1000)
    by_path["adamw_ema"] = phase_adamw_ema(tr, out_dir)
    by_path["static_recon"] = phase_static(tr)
    by_path["log_samples"] = phase_log_samples(tr, step)
    log(f"phase 12: {time.perf_counter() - t0:.1f} s all told")
    return by_path


# ---------------------------------------------------------------------------
# Phase 13: the txt2img and infer CLIs over the reference's checkpoint files
# ---------------------------------------------------------------------------

CLI_STEPS = 50          # DDIM-50, 2 images: UNet batch 4 with CFG, as phases 5 and 8
CLI_IMAGES = 2
CLI_MKV_BEGIN = 8       # prompt2token_proj's k/v widened x2 on layers 8-11
CLI_SECONDS = {}        # path -> (main(argv) wall seconds, personalization seconds)


class _PatchedCalls:
    """For the duration of a `with`, `owner.name` goes through a wrapper
    that synchronizes before and after each call and keeps (seconds,
    kwargs, result, the launches inside the call), and in `starts` the
    host clock at which each call began."""

    def __init__(self, owner, name):
        self.owner, self.name, self.calls, self.starts = owner, name, [], []

    def __enter__(self):
        import torch
        self.orig = getattr(self.owner, self.name)

        def wrapped(*a, **k):
            torch.cuda.synchronize()
            before, t0 = read_counts(), time.perf_counter()
            self.starts.append(t0)
            out = self.orig(*a, **k)
            torch.cuda.synchronize()
            self.calls.append((time.perf_counter() - t0, k, out, nz(counts_since(before))))
            return out

        setattr(self.owner, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)

    @property
    def seconds(self):
        return sum(c[0] for c in self.calls)


def _check_cli_images(path, paths, generated):
    """The CLI's PNGs decode to the images generate returned: uint8 512x512, std > 0."""
    import numpy as np
    from adaprompt_tpu_torch.utils.png import read_png
    images = np.concatenate(generated)
    if len(paths) != CLI_IMAGES or images.shape != (CLI_IMAGES, 512, 512, 3):
        raise AssertionError(f"{path}: {len(paths)} PNGs, generate returned {images.shape}")
    for p, img in zip(paths, images):
        got = read_png(p)
        if not np.array_equal(got, img):
            raise AssertionError(f"{path}: {p} does not decode to the image generate returned")
        if not got.std() > 0:
            raise AssertionError(f"{path}: {p} is flat")
    return images


def _check_cli_launches(path, counts, passes=CLI_STEPS):
    """B1, B2 and B3 launched 10 times a UNet pass, no other kernel."""
    want = {n: 0 for n in counts}
    want.update(flash_attention_fwd=10 * passes, fused_cross_attention=10 * passes,
                geglu_fwd=10 * passes)
    if counts != want:
        raise AssertionError(f"{path} launches {counts}, expected {want}")


def _run_cli(path, main, argv, card):
    """main(argv) with its loaders (the SD checkpoint, the generator, the
    ArcFace trunk), generate and, for infer, the personalization timed,
    and its launches checked; returns (the PNG paths, {name: _PatchedCalls})."""
    import torch
    from adaprompt_tpu_torch.adaface.wrapper import AdaFacePipeline
    from adaprompt_tpu_torch.cli import common
    from adaprompt_tpu_torch.pipeline import StableDiffusionPipeline
    timers = {"load_pipeline": _PatchedCalls(common, "load_pipeline"),
              "load_subj_basis": _PatchedCalls(common, "load_subj_basis"),
              "load_arcface": _PatchedCalls(common, "load_arcface"),
              "generate": _PatchedCalls(StableDiffusionPipeline, "generate"),
              "personalize": _PatchedCalls(AdaFacePipeline, "generate_adaface_embeddings")}
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for tm in timers.values():
        tm.__enter__()
    try:
        paths = main(argv)
    finally:
        for tm in timers.values():
            tm.__exit__()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    load = sum(timers[k].seconds for k in ("load_pipeline", "load_subj_basis", "load_arcface"))
    gen = timers["generate"].seconds
    CLI_SECONDS[path] = (seconds, timers["personalize"].seconds)
    log(f"phase {13 if path in _CLIS else 16} {path}: main(argv) to its last PNG {seconds:.3f} s = load {load:.3f} s (SD "
        f"checkpoint {timers['load_pipeline'].seconds:.3f}, generator "
        f"{timers['load_subj_basis'].seconds:.3f}, ArcFace {timers['load_arcface'].seconds:.3f}) "
        f"+ generate {gen:.3f} s ({CLI_IMAGES} images 512x512 DDIM-{CLI_STEPS} bf16) + the rest "
        f"{seconds - load - gen:.3f} s (face embedding, personalization, PNGs); peak memory "
        f"{peak:.2f} GiB; launches {nz(counts)}; {card}")
    _check_cli_launches(path, counts)
    return paths, timers


def phase_clis(tmp):
    """Phase 13: the txt2img and infer CLIs over the reference's checkpoint
    files, written from a full-width AdaFacePipeline with random weights
    (fused_conv off) into the temporary directory `tmp`. Returns ({path:
    launch counts}, {name: file path} of the files written)."""
    import os
    import numpy as np
    import torch
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    import reference_layouts as rl
    from adaprompt_tpu_torch.adaface.subj_basis_generator import (
        extend_prompt2token_proj_attention)
    from adaprompt_tpu_torch.adaface.wrapper import AdaFacePipeline
    from adaprompt_tpu_torch.cli import infer, txt2img
    from adaprompt_tpu_torch.eval.face_eval import FaceSimilarityEvaluator
    from adaprompt_tpu_torch.ops.layers import randomize_zero_init
    from adaprompt_tpu_torch.pipeline import StableDiffusionPipeline
    from adaprompt_tpu_torch.utils.png import read_png, write_png
    from adaprompt_tpu_torch.utils.torch_port import load_state_dict
    card = card_line()
    t_phase = t0 = time.perf_counter()
    ada = AdaFacePipeline.random_init(0)
    pipe, sbg, arc = ada.pipe, ada.subj_basis, ada.face_embedder.arcface
    gen = torch.Generator(device="cuda").manual_seed(3)
    randomize_zero_init(pipe.unet, gen)
    extend_prompt2token_proj_attention(sbg, 2, begin_layer=CLI_MKV_BEGIN, generator=gen)
    torch.cuda.synchronize()
    widths = [lp["attn"]["k"].weight.shape[0] for lp in sbg.prompt2token_proj.layers]
    log(f"phase 13 random_init: {time.perf_counter() - t0:.1f} s; prompt2token_proj k widths "
        f"{widths}")

    files = {"sd": os.path.join(tmp, "v1-5-random.ckpt"),
             "adaface": os.path.join(tmp, "embeddings_gs-0.pt"),
             "arcface": os.path.join(tmp, "glint360k_r100-random.pth")}
    photos = os.path.join(tmp, "photos")
    os.makedirs(photos)
    t0 = time.perf_counter()
    torch.save(rl.sd_checkpoint(pipe), files["sd"])
    sd_sec = time.perf_counter() - t0
    rl.write_adaface_pt(files["adaface"], {"z": sbg},
                        {"z": pipe.tokenizer.encode_raw("z")[0]})
    torch.save(rl.arcface_insightface(arc), files["arcface"])
    rng = np.random.default_rng(13)
    photo_paths = [write_png(os.path.join(photos, f"photo{i}.png"),
                             rng.integers(0, 256, (512, 512, 3)).astype(np.uint8))
                   for i in range(3)]
    sizes = {k: os.path.getsize(v) / 2 ** 20 for k, v in files.items()}
    log("phase 13 files: " + ", ".join(f"{os.path.basename(files[k])} {sizes[k]:.1f} MiB"
                                       for k in files)
        + f"; the SD checkpoint written in {sd_sec:.3f} s; {card}")

    # (a) from_checkpoint against the pipeline written
    t0 = time.perf_counter()
    n_entries = len(load_state_dict(files["sd"]))
    load_sec = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loaded = StableDiffusionPipeline.from_checkpoint(files["sd"])
    torch.cuda.synchronize()
    from_sec = time.perf_counter() - t0
    vocab = pipe.text.cfg.vocab_size
    bad = []
    for name in ("unet", "vae", "text"):
        want = getattr(pipe, name).state_dict()
        got = getattr(loaded, name).state_dict()
        if name == "text":
            want = dict(want, token_embedding=want["token_embedding"][:vocab])
        if sorted(got) != sorted(want):
            raise AssertionError(f"from_checkpoint's {name} has other parameters")
        bad += [f"{name}.{k}" for k in want if got[k].dtype != want[k].dtype
                or not torch.equal(got[k], want[k])]
    if bad:
        raise AssertionError(f"from_checkpoint differs from the pipeline written at {bad[:8]}")
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((2, 64, 64, 4), generator=g, device="cuda").to(torch.bfloat16)
    ctx = torch.randn((2, 77, 768), generator=g, device="cuda").to(torch.bfloat16)
    ts = torch.tensor([981, 501], device="cuda")
    with torch.inference_mode():
        eps_mem, eps_loaded = pipe.unet(x, ts, ctx), loaded.unet(x, ts, ctx)
    if not (torch.equal(eps_mem, eps_loaded) and float(eps_mem.float().abs().max()) > 0):
        raise AssertionError("the loaded UNet's forward differs from the written one's: max "
                             f"{float((eps_mem.float() - eps_loaded.float()).abs().max())}")
    n_params = sum(p.numel() for m in (loaded.unet, loaded.vae, loaded.text)
                   for p in m.parameters())
    log(f"phase 13 from_checkpoint: load_state_dict {load_sec:.3f} s ({n_entries} entries), "
        f"from_checkpoint {from_sec:.3f} s; {n_params / 1e6:.1f} M parameters bit-equal to "
        f"the pipeline written, UNet forward bit-equal (max |eps| "
        f"{float(eps_mem.float().abs().max()):.4f}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; {card}")
    del loaded, eps_loaded
    torch.cuda.empty_cache()

    # (b) txt2img
    out = os.path.join(tmp, "txt2img")
    paths, timers = _run_cli("cli_txt2img", txt2img.main, [
        "--ckpt", files["sd"], "--adaface_ckpt", files["adaface"], "--ref_images", photos,
        "--arcface_ckpt", files["arcface"], "--prompt", "a photo of a z person in the park",
        "--n_samples", str(CLI_IMAGES), "--ddim_steps", str(CLI_STEPS), "--scale", "4", "1",
        "--outdir", out], card)
    launches = {"cli_txt2img": read_counts()}
    gen_calls = timers["generate"].calls
    imgs = _check_cli_images("cli_txt2img", paths, [c[2] for c in gen_calls])
    ctx_shape = tuple(gen_calls[0][1]["context"].shape)
    if ctx_shape != (16, CLI_IMAGES, 77, 768):
        raise AssertionError(f"txt2img's context {ctx_shape}, expected layerwise [16, 2, 77, 768]")
    log(f"phase 13 cli_txt2img: {len(paths)} PNGs decoded equal to generate's images, std "
        f"{imgs.std():.2f}; context {ctx_shape}")

    # (c) infer, against an AdaFacePipeline built in memory from the same modules
    out = os.path.join(tmp, "infer")
    paths, timers = _run_cli("cli_infer", infer.main, [
        "--ckpt", files["sd"], "--subject", photos, "--adaface_ckpt", files["adaface"],
        "--arcface_ckpt", files["arcface"], "--prompt", "portrait of a z person",
        "--out_image_count", str(CLI_IMAGES), "--num_steps", str(CLI_STEPS), "--outdir", out],
        card)
    launches["cli_infer"] = read_counts()
    imgs = _check_cli_images("cli_infer", paths, [c[2] for c in timers["generate"].calls])
    (pers_sec, _, vecs, during), = timers["personalize"].calls
    if during:
        raise AssertionError(f"infer launched {during} while personalizing")
    mem = AdaFacePipeline(pipe, sbg, sbg.cfg, pipe.text, pipe.text.cfg,
                          face_embedder=FaceSimilarityEvaluator(arc))
    mem_vecs = mem.generate_adaface_embeddings(images_np=[read_png(p) for p in photo_paths],
                                               seed=42)
    if tuple(vecs.shape) != (16, 768) or not torch.equal(vecs, mem_vecs):
        raise AssertionError(f"infer's subject vectors {tuple(vecs.shape)} differ from the "
                             "in-memory pipeline's: max "
                             f"{float((vecs - mem_vecs).abs().max())}")
    log(f"phase 13 cli_infer: personalization {pers_sec * 1e3:.1f} ms, no launch; 16 subject "
        f"vectors equal to the in-memory AdaFacePipeline's (std {float(vecs.std()):.4f}); "
        f"{len(paths)} PNGs decoded equal to generate's images, std {imgs.std():.2f}")
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s")
    return launches, files


# ---------------------------------------------------------------------------
# Phase 14: the training CLI over a folder of photos
# ---------------------------------------------------------------------------

TRAIN_CLI_S1_STEPS = 4      # bs 4 (the README's Stage-1 batch), two accumulated updates
TRAIN_CLI_USR1_STEP = 1     # SIGUSR1 arrives during this step of the Stage-1 run
TRAIN_CLI_S2_STEPS = 4      # bs 3 (the Stage-2 default), gap 3: step 3 compositional
TRAIN_CLI_STATIC_STEPS = 2
TRAIN_CLI_EVERY = 2         # --ckpt_every and --sample_every of the Stage-1 run
TRAIN_CLI_SUBJECTS = 3
TRAIN_CLI_PHOTOS = 3        # 512x512 PNGs a subject, each with a _mask PNG


def _train_cli_data(tmp):
    """A data root of TRAIN_CLI_SUBJECTS subjects, each TRAIN_CLI_PHOTOS
    seeded 512x512 PNG photos with elliptic _mask PNGs, the first subject
    also a 600x560 photo without a mask (the loader resizes it). Returns the
    data root."""
    import os
    import numpy as np
    from adaprompt_tpu_torch.utils.png import write_png
    rng = np.random.default_rng(14)
    root = os.path.join(tmp, "subjects")
    yy, xx = np.mgrid[:512, :512]
    for s in range(TRAIN_CLI_SUBJECTS):
        d = os.path.join(root, f"subject{s}")
        os.makedirs(d)
        for i in range(TRAIN_CLI_PHOTOS):
            write_png(os.path.join(d, f"{i}.png"), rng.integers(0, 256, (512, 512, 3), np.uint8))
            cy, cx, ry, rx = rng.uniform(200, 312), rng.uniform(200, 312), 150, 110
            mask = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1).astype(np.uint8) * 255
            write_png(os.path.join(d, f"{i}_mask.png"), np.repeat(mask[..., None], 3, axis=2))
    write_png(os.path.join(root, "subject0", "wide.png"),
              rng.integers(0, 256, (560, 600, 3), np.uint8))
    return root


def _train_cli_want(rows, samples=0):
    """The launches a run's metrics rows imply: a distillation step 10
    forwards of B1 and B3 a teacher pass (ND) and 20 a student pass and its
    recompute (min(ND, 7 // bs) students), 9 of B4 a student backward; a recon
    step one student pass (B1 20, B3 20, B4 9); a compositional step the
    filter's conditional pass (B1 10, B3 10) and, when it keeps a candidate,
    a student pass (B1 20, B3 20, B4 9); each log_samples B1-B3 200
    (DDIM-20, UNet batch 4)."""
    fwd = bwd = 0
    for r in rows:
        kind = r["iter_type"]
        if kind == "arc2face_distill":
            nd = r["num_denoising_steps"]
            students = min(nd, max(7 // r["distill_bs"], 1))
            fwd, bwd = fwd + 10 * (nd + 2 * students), bwd + FLASH_BWD_PER_PASS * students
        elif kind in ("recon", "static"):
            fwd, bwd = fwd + 20, bwd + FLASH_BWD_PER_PASS
        elif kind == "compos_distill_skipped":
            fwd += 10
        elif kind == "compos_distill":
            fwd, bwd = fwd + 30, bwd + FLASH_BWD_PER_PASS
        else:
            raise AssertionError(f"unexpected iteration {r}")
    return dict(flash_attention_fwd=fwd + 10 * SAMPLE_STEPS * samples, flash_attention_bwd=bwd,
                geglu_fwd=fwd + 10 * SAMPLE_STEPS * samples,
                fused_cross_attention=10 * SAMPLE_STEPS * samples)


def _run_train_cli(path, argv, card, usr1_step=None):
    """train.main(argv) with its loaders, steps, samples and saves timed and
    its launches counted; under `usr1_step` a timer sends SIGUSR1 to the
    process 50 ms into that step. Returns (metrics rows, {name:
    _PatchedCalls}, seconds, launches)."""
    import json
    import os
    import signal
    import threading
    import torch
    from adaprompt_tpu_torch.cli import common, train
    from adaprompt_tpu_torch.eval.clip_scorer import CLIPScorer
    from adaprompt_tpu_torch.train import steps as steps_mod
    from adaprompt_tpu_torch.train.trainer import AdaPromptTrainer
    timers = {"load_pipeline": _PatchedCalls(common, "load_pipeline"),
              "load_teacher": _PatchedCalls(train, "load_teacher"),
              "load_arcface": _PatchedCalls(common, "load_arcface"),
              "clip_from_torch": _PatchedCalls(CLIPScorer, "from_torch"),
              "step": _PatchedCalls(AdaPromptTrainer, "train_step"),
              "static_step": _PatchedCalls(steps_mod.StaticReconStep, "__call__"),
              "log_samples": _PatchedCalls(AdaPromptTrainer, "log_samples"),
              "save_checkpoint": _PatchedCalls(AdaPromptTrainer, "save_checkpoint"),
              "save_full_state": _PatchedCalls(AdaPromptTrainer, "save_full_state"),
              "load_full_state": _PatchedCalls(AdaPromptTrainer, "load_full_state"),
              "load_checkpoint": _PatchedCalls(AdaPromptTrainer, "load_checkpoint")}
    for tm in timers.values():
        tm.__enter__()
    timed_step = AdaPromptTrainer.train_step
    usr1 = []

    def step(self, i):
        if i == usr1_step:
            usr1.append(threading.Timer(0.05, os.kill, (os.getpid(), signal.SIGUSR1)))
            usr1[-1].start()
        return timed_step(self, i)

    AdaPromptTrainer.train_step = step
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        train.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        AdaPromptTrainer.train_step = timed_step
        for tm in reversed(list(timers.values())):
            tm.__exit__()
        for t in usr1:
            t.join()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out = argv[argv.index("--out_dir") + 1]
    rows = []       # the static mode writes no metrics
    if os.path.exists(os.path.join(out, "metrics.jsonl")):
        with open(os.path.join(out, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
    loads = {k: round(timers[k].seconds, 3) for k in ("load_pipeline", "load_teacher",
                                                       "load_arcface", "clip_from_torch",
                                                       "load_full_state", "load_checkpoint")
             if timers[k].calls}
    saves = {k: [round(c[0], 3) for c in timers[k].calls]
             for k in ("save_checkpoint", "save_full_state", "log_samples") if timers[k].calls}
    steps = [round(c[0], 3) for c in timers["step"].calls + timers["static_step"].calls]
    files = sorted(os.listdir(out))
    log(f"phase {16 if path in _DETECT else 18 if path in _PERSONAL else 14} {path}: main(argv) to its last file {seconds:.3f} s; loads {loads} s; step "
        f"times {steps} s; samples and saves {saves} s; peak memory {peak:.2f} GiB; files "
        f"{files}; launches {nz(launches)}; {card}")
    return rows, timers, seconds, launches


def _check_train_rows(path, rows, steps):
    if [r["step"] for r in rows] != list(steps):
        raise AssertionError(f"{path} took steps {[r['step'] for r in rows]}, expected {steps}")
    for r in rows:
        loss = r.get("loss", r.get("loss_arc2face_distill", r.get("loss_compos")))
        skipped = r["iter_type"] == "compos_distill_skipped"
        if not skipped and not (math.isfinite(loss) and math.isfinite(r["grad_norm"])
                                and r["grad_norm"] > 0):
            raise AssertionError(f"{path}: bad metrics {r}")
    log(f"phase {16 if path in _DETECT else 18 if path in _PERSONAL else 14} {path} steps: " + "; ".join(
        f"{r['step']} {r['iter_type']}"
        + (f" ND={r['num_denoising_steps']} bs={r['distill_bs']}" if "distill_bs" in r else "")
        + (f" loss={r.get('loss', r.get('loss_arc2face_distill', r.get('loss_compos'))):.6f}"
           if "grad_norm" in r else "")
        for r in rows))


def _check_train_launches(path, launches, want):
    full = {n: 0 for n in launches}
    full.update(want)
    if launches != full:
        raise AssertionError(f"{path} launches {nz(launches)}, expected {nz(full)}")


def phase_train_cli(tmp, files):
    """Phase 14: cli.train.main over a folder of photos, after phase 13 and
    in its temporary directory, on its SD-1.5 .ckpt (as --ckpt and as
    --arc2face_ckpt) and its ArcFace .pth, with a full-width ViT-B/32
    CLIPModel state dict written here: (a) Stage 1, bs 4, with
    --ckpt_every and --sample_every, SIGUSR1 during a step (the full state
    written when that step ends, the run goes on to its last step); (b)
    --resume_state from that state (its first step is the saved one); (c)
    Stage 2 (bs 3) from (a)'s generator with the CLIP teacher filter and a
    torch.profiler trace; (d) --mode static, 2 steps. Each run's launches of
    B1-B4 equal what its metrics rows imply. Returns ({path: launch counts},
    the data root)."""
    import glob
    import json
    import os
    import torch
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    import reference_layouts as rl
    from adaprompt_tpu_torch.eval.clip_scorer import CLIPScorer
    from adaprompt_tpu_torch.utils.png import read_png
    card = card_line()
    t_phase = t0 = time.perf_counter()
    root = _train_cli_data(tmp)
    clip_path = os.path.join(tmp, "clip-vit-b32-random.bin")
    torch.save(rl.clip_model_hf(CLIPScorer.random_init(15)), clip_path)
    log(f"phase 14 data: {TRAIN_CLI_SUBJECTS} subjects x {TRAIN_CLI_PHOTOS} 512x512 PNG photos "
        f"with masks (+1 at 600x560), a ViT-B/32 CLIPModel state dict of "
        f"{os.path.getsize(clip_path) / 2 ** 20:.1f} MiB, written in "
        f"{time.perf_counter() - t0:.1f} s")
    model = ["--ckpt", files["sd"], "--data_roots", root]
    teacher = ["--arc2face_ckpt", files["sd"], "--arcface_ckpt", files["arcface"]]
    by_path = {}

    # (a) Stage 1 with samples, checkpoints and a SIGUSR1 save
    s1 = os.path.join(tmp, "train_s1")
    s1_args = model + teacher + [
        "--stage", "1", "--bs", "4", "--num_steps", str(TRAIN_CLI_S1_STEPS),
        "--ckpt_every", str(TRAIN_CLI_EVERY), "--sample_every", str(TRAIN_CLI_EVERY),
        "--seed", "14"]
    rows, timers, _, launches = _run_train_cli("cli_train_s1", s1_args + ["--out_dir", s1], card,
                                               usr1_step=TRAIN_CLI_USR1_STEP)
    _check_train_rows("cli_train_s1", rows, range(TRAIN_CLI_S1_STEPS))
    n_samples = TRAIN_CLI_S1_STEPS // TRAIN_CLI_EVERY
    _check_train_launches("cli_train_s1", launches, _train_cli_want(rows, n_samples))
    (state_sec, _, state_path, _), = timers["save_full_state"].calls
    states = glob.glob(os.path.join(s1, "trainer_state-*.npz"))
    want_files = {f"embeddings_gs-{k}.npz" for k in range(TRAIN_CLI_EVERY, TRAIN_CLI_S1_STEPS + 1,
                                                          TRAIN_CLI_EVERY)}
    want_files |= {f"samples_gs-{k}.png" for k in range(TRAIN_CLI_EVERY, TRAIN_CLI_S1_STEPS + 1,
                                                        TRAIN_CLI_EVERY)}
    if states != [state_path] or not want_files <= set(os.listdir(s1)):
        raise AssertionError(f"cli_train_s1 wrote {sorted(os.listdir(s1))}; expected one "
                             f"trainer_state and {sorted(want_files)}")
    saved_at = int(os.path.basename(states[0])[len("trainer_state-"):-len(".npz")])
    if saved_at != TRAIN_CLI_USR1_STEP + 1:     # held to the end of the step it arrived in
        raise AssertionError(f"SIGUSR1 during step {TRAIN_CLI_USR1_STEP} saved "
                             f"{os.path.basename(states[0])}")
    strip = read_png(os.path.join(s1, f"samples_gs-{TRAIN_CLI_EVERY}.png"))
    log(f"phase 14 cli_train_s1: SIGUSR1 during step {TRAIN_CLI_USR1_STEP} saved "
        f"{os.path.basename(states[0])} ({os.path.getsize(states[0]) / 2 ** 30:.3f} GiB in "
        f"{state_sec:.3f} s) and the run went on to step {rows[-1]['step']}; sample strip "
        f"{strip.shape} std {strip.std():.2f}")
    by_path["cli_train_s1"] = launches

    # (b) --resume_state from the SIGUSR1 save
    s1r = os.path.join(tmp, "train_s1_resumed")
    rows, timers, _, launches = _run_train_cli(
        "cli_train_resume", s1_args + ["--out_dir", s1r, "--resume_state", states[0]], card)
    _check_train_rows("cli_train_resume", rows, range(saved_at, TRAIN_CLI_S1_STEPS))
    samples = sum(1 for k in range(saved_at + 1, TRAIN_CLI_S1_STEPS + 1) if k % TRAIN_CLI_EVERY == 0)
    _check_train_launches("cli_train_resume", launches, _train_cli_want(rows, samples))
    (meta,) = [c[2] for c in timers["load_full_state"].calls]
    if meta["step"] != saved_at:
        raise AssertionError(f"the resumed state's step {meta['step']}, saved at {saved_at}")
    by_path["cli_train_resume"] = launches

    # (c) Stage 2 from (a)'s generator, with the CLIP teacher filter and a trace
    s2, prof = os.path.join(tmp, "train_s2"), os.path.join(tmp, "train_s2_trace")
    rows, timers, _, launches = _run_train_cli("cli_train_s2", model + teacher + [
        "--stage", "2", "--num_steps", str(TRAIN_CLI_S2_STEPS), "--seed", "15",
        "--adaface_ckpt", os.path.join(s1, f"embeddings_gs-{TRAIN_CLI_S1_STEPS}.npz"),
        "--clip_ckpt", clip_path, "--profile_dir", prof, "--out_dir", s2], card)
    _check_train_rows("cli_train_s2", rows, range(TRAIN_CLI_S2_STEPS))
    _check_train_launches("cli_train_s2", launches, _train_cli_want(rows))
    compos = [r for r in rows if r["iter_type"].startswith("compos")]
    if [r["step"] for r in compos] != [3] or len(timers["load_checkpoint"].calls) != 1:
        raise AssertionError(f"cli_train_s2: compositional steps {compos}, generator loads "
                             f"{len(timers['load_checkpoint'].calls)}")
    with open(os.path.join(prof, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    log(f"phase 14 cli_train_s2: the filter decided {compos[0]['iter_type']} "
        f"(loss_clip_subj_comp {compos[0].get('loss_clip_subj_comp')}); trace of steps 2-3: "
        f"{os.path.getsize(os.path.join(prof, 'trace.json')) / 2 ** 20:.1f} MiB, "
        f"{len(kernels)} device kernels, {sum(e.get('dur', 0) for e in kernels) / 1e3:.1f} ms "
        f"of kernel time")
    if not kernels:
        raise AssertionError("cli_train_s2: the torch.profiler trace holds no device kernel")
    by_path["cli_train_s2"] = launches

    # (d) the static textual-inversion mode
    st = os.path.join(tmp, "train_static")
    _, timers, _, launches = _run_train_cli("cli_train_static", model + [
        "--mode", "static", "--num_steps", str(TRAIN_CLI_STATIC_STEPS), "--ckpt_every", "1",
        "--out_dir", st], card)
    rows = [{"iter_type": "static"}] * len(timers["static_step"].calls)
    if len(rows) != TRAIN_CLI_STATIC_STEPS or not all(
            os.path.exists(os.path.join(st, f"static_emb_gs-{k}.npz"))
            for k in range(1, TRAIN_CLI_STATIC_STEPS + 1)):
        raise AssertionError(f"cli_train_static: {len(rows)} steps, files {os.listdir(st)}")
    _check_train_launches("cli_train_static", launches, _train_cli_want(rows))
    by_path["cli_train_static"] = launches
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s; {card}")
    return by_path, root


# ---------------------------------------------------------------------------
# Phase 15: the evaluation path (the object branch, gen_eval, txt2img
# --compare_with, image metrics)
# ---------------------------------------------------------------------------

EVAL_SUBJECTS = ("subject0", "subject1")    # gen_eval's two of phase 14's three
EVAL_PROMPTS = 2        # --max_prompts: 2 prompts x 2 images a subject, DDIM-50
EVAL_IMAGES = 2         # --n_per_prompt


def _rel(a, b) -> float:
    return float((a.detach().float().cpu() - b.detach().float().cpu()).norm() / b.float().norm())


def phase_object_branch(root, card):
    """(a) One subject's photos (with their masks) through a
    ZeroShotFeatureExtractor over a seeded full-width CLIP ViT-H/14 and DINO
    ViT-S/16 with is_face=False, calc_avg off and on, then the DINO
    embeddings through the object branch of a seeded full-width
    SubjBasisGenerator at out_id_embs_scale 1 and 0.8: fp32 (TF32 off) on
    the card against the same modules on the CPU within VISION_TOL
    (relative L2; calc_avg's reference the mean of the CPU's per-image
    outputs, the DINO mean re-normalized), no kernel launched."""
    import os
    import numpy as np
    import torch
    from adaprompt_tpu_torch.adaface.subj_basis_generator import SUBJ_CONFIG, SubjBasisGenerator
    from adaprompt_tpu_torch.adaface.zs_features import ZeroShotFeatureExtractor
    from adaprompt_tpu_torch.models.clip_vision import CLIP_VIT_H14_VISION, CLIPVisionModel
    from adaprompt_tpu_torch.models.dino import DINO
    from adaprompt_tpu_torch.ops.layers import reset_parameters
    from adaprompt_tpu_torch.utils.png import read_png, to_grey
    from adaprompt_tpu_torch.utils.tokenizer import CLIPTokenizer
    t0 = time.perf_counter()
    folder = os.path.join(root, EVAL_SUBJECTS[1])
    names = sorted(f for f in os.listdir(folder) if not f.endswith("_mask.png"))
    photos = [read_png(os.path.join(folder, f)) for f in names]
    masks = [(to_grey(read_png(os.path.join(folder, f[:-4] + "_mask.png"))) > 127)
             .astype(np.float32) for f in names]
    vision = CLIPVisionModel.random_init(15, CLIP_VIT_H14_VISION, device="cuda")
    dino = DINO.random_init(16, device="cuda")
    sbg = reset_parameters(SubjBasisGenerator(SUBJ_CONFIG, device="cuda"),
                           torch.Generator(device="cuda").manual_seed(17))
    cpu = {}
    for name, m in (("vision", vision), ("dino", dino), ("sbg", sbg)):
        cpu[name] = type(m)(m.cfg, device="cpu")
        cpu[name].load_state_dict({k: v.cpu() for k, v in m.state_dict().items()}, strict=True)
    tok = CLIPTokenizer.load(None)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    card_x = ZeroShotFeatureExtractor(vision, dino=dino)
    before = read_counts()
    times, got = [], {}
    with torch.no_grad():
        for calc_avg in (False, True):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            got[calc_avg] = card_x(photos, fg_masks=masks, is_face=False, calc_avg=calc_avg)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        branch = {}
        for scale in (1.0, 0.8):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            branch[scale] = sbg(tok, raw_id_embs=got[False][1], out_id_embs_scale=scale,
                                is_face=False)[0]
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
    launches = nz(counts_since(before))
    t1 = time.perf_counter()
    with torch.no_grad():
        ref_f, ref_ids, _ = ZeroShotFeatureExtractor(cpu["vision"], dino=cpu["dino"])(
            photos, fg_masks=masks, is_face=False)
        ref_branch = {s: cpu["sbg"](tok, raw_id_embs=ref_ids, out_id_embs_scale=s,
                                    is_face=False)[0] for s in branch}
    cpu_s = time.perf_counter() - t1
    avg_ids = ref_ids.mean(0, keepdim=True)
    errs = {"clip_features": _rel(got[False][0], ref_f), "dino_ids": _rel(got[False][1], ref_ids),
            "clip_features_avg": _rel(got[True][0], ref_f.mean(0, keepdim=True)),
            "dino_ids_avg": _rel(got[True][1], avg_ids / avg_ids.norm(dim=-1, keepdim=True))}
    errs.update({f"object_branch@{s}": _rel(branch[s], ref_branch[s]) for s in branch})
    shapes = (tuple(got[False][0].shape), tuple(got[False][1].shape), tuple(branch[1.0].shape))
    log(f"phase 15 object branch: {len(photos)} photos 512x512 with masks, is_face=False, "
        f"features {shapes[0]}, DINO ids {shapes[1]}, subject vectors {shapes[2]}; fp32 card vs "
        f"fp32 CPU relative L2 {({k: f'{v:.3e}' for k, v in errs.items()})} (bound "
        f"{VISION_TOL:g}); card extractor {times[0]:.3f} s (calc_avg off, zero image included), "
        f"{times[1]:.3f} s (on), object branch {times[2] * 1e3:.1f} / {times[3] * 1e3:.1f} ms "
        f"(scale 1 / 0.8, the pad embeddings computed); CPU {cpu_s:.1f} s, models built in "
        f"{build_s:.1f} s; launches {launches}; {card}")
    if shapes != ((len(photos), 2 * CLIP_VIT_H14_VISION.seq_len, 1280), (len(photos), 384),
                  (len(photos), 16, 16, 768)):
        raise AssertionError(f"object branch shapes {shapes}")
    bad = {k: v for k, v in errs.items() if not (math.isfinite(v) and v <= VISION_TOL)}
    if bad:
        raise AssertionError(f"the object branch on the card disagrees with the CPU: {bad}")
    if launches:
        raise AssertionError(f"the object branch launched kernels: {launches}")
    if _rel(branch[0.8], branch[1.0]) < 1e-3:
        raise AssertionError("out_id_embs_scale 0.8 did not blend the pad embeddings in")


def _eval_timers():
    """The loaders, generate, personalization and each score of a CLI run."""
    from adaprompt_tpu_torch.adaface.wrapper import AdaFacePipeline
    from adaprompt_tpu_torch.cli import common
    from adaprompt_tpu_torch.eval import harness
    from adaprompt_tpu_torch.eval.clip_scorer import CLIPScorer
    from adaprompt_tpu_torch.eval.dino_eval import DINOEvaluator
    from adaprompt_tpu_torch.eval.face_eval import FaceSimilarityEvaluator
    from adaprompt_tpu_torch.pipeline import StableDiffusionPipeline
    return {"load_pipeline": _PatchedCalls(common, "load_pipeline"),
            "load_subj_basis": _PatchedCalls(common, "load_subj_basis"),
            "load_arcface": _PatchedCalls(common, "load_arcface"),
            "generate": _PatchedCalls(StableDiffusionPipeline, "generate"),
            "personalize": _PatchedCalls(AdaFacePipeline, "generate_adaface_embeddings"),
            "compare_folders": _PatchedCalls(harness, "compare_folders"),
            "clip": _PatchedCalls(CLIPScorer, "evaluate"),
            "dino": _PatchedCalls(DINOEvaluator, "image_pairwise_similarity"),
            "embed_folder": _PatchedCalls(FaceSimilarityEvaluator, "embed_folder")}


def _run_eval_cli(path, main, argv, generates, card):
    """main(argv) timed (its loaders, generates, personalizations and, for
    each folder pair, compare_folders with its CLIP, DINO and ArcFace
    parts) with its launches counted: `generates` DDIM-50 generates, 10 * 50
    launches of B1-B3 each, none of the rest, none inside compare_folders.
    Returns (main's result, {name: _PatchedCalls}, [per folder pair: its
    seconds, those of its parts, its FolderScores], the launches)."""
    import torch
    timers = _eval_timers()
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for tm in timers.values():
        tm.__enter__()
    try:
        out = main(argv)
    finally:
        for tm in reversed(list(timers.values())):
            tm.__exit__()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loads = {k: round(timers[k].seconds, 3) for k in ("load_pipeline", "load_subj_basis",
                                                       "load_arcface")}
    gens = [round(c[0], 3) for c in timers["generate"].calls]
    pairs = []
    for start, (sec, _, scores, inside) in zip(timers["compare_folders"].starts,
                                               timers["compare_folders"].calls):
        arc = sum(c[0] for t, c in zip(timers["embed_folder"].starts, timers["embed_folder"].calls)
                  if start <= t <= start + sec)
        clip = next(c[0] for t, c in zip(timers["clip"].starts, timers["clip"].calls)
                    if start <= t <= start + sec)
        dino = next(c[0] for t, c in zip(timers["dino"].starts, timers["dino"].calls)
                    if start <= t <= start + sec)
        pairs.append(dict(seconds=sec, clip=clip, dino=dino, arcface=arc, scores=scores,
                          launches=inside))
    log(f"phase 15 {path}: main(argv) {seconds:.3f} s; loads {loads} s; "
        f"{len(gens)} generates ({EVAL_IMAGES} images 512x512 DDIM-50 bf16) {gens} s; "
        f"personalization {[round(c[0] * 1e3, 1) for c in timers['personalize'].calls]} ms; "
        f"compare_folders " + "; ".join(
            f"{p['seconds']:.3f} s (CLIP {p['clip']:.3f}, DINO {p['dino']:.3f}, ArcFace "
            f"{p['arcface']:.3f}, PNG reads and resizes the rest)" for p in pairs)
        + f"; peak memory {peak:.2f} GiB; launches {nz(launches)}; {card}")
    want = {n: 0 for n in launches}
    per = 10 * 50 * generates
    want.update(flash_attention_fwd=per, fused_cross_attention=per, geglu_fwd=per)
    if len(gens) != generates or launches != want:
        raise AssertionError(f"{path}: {len(gens)} generates, launches {nz(launches)}; "
                             f"expected {generates}, {nz(want)}")
    if any(p["launches"] for p in pairs):
        raise AssertionError(f"{path} launched {[p['launches'] for p in pairs]} while scoring")
    return out, timers, pairs, launches


def _check_scores(path, scores):
    bad = {k: v for k, v in scores.items() if not (math.isfinite(v) and -1.0 <= v <= 1.0)}
    if bad:
        raise AssertionError(f"{path} scores out of [-1, 1]: {bad}")


def phase_eval(tmp, files, root):
    """Phase 15, after phase 14 in its temporary directory: (a) the object
    branch; (b) gen_eval.main over two of phase 14's subjects (2 prompts x 2
    images, DDIM-50) with phase 13's .ckpt, AdaFace .pt and ArcFace .pth;
    (c) txt2img.main --compare_with one subject's folder (2 images,
    DDIM-50); (d) PSNR, SSIM and the IResNet-100 random-feature cosine of
    (b)'s images against (c)'s. Returns {path: launch counts}."""
    import csv
    import os
    import numpy as np
    from adaprompt_tpu_torch.cli import gen_eval, txt2img
    from adaprompt_tpu_torch.eval import image_metrics
    from adaprompt_tpu_torch.utils.png import read_png
    card = card_line()
    t_phase = time.perf_counter()
    phase_object_branch(root, card)

    # (b) gen_eval
    out = os.path.join(tmp, "gen_eval")
    rows, _, pairs, launches = _run_eval_cli("cli_gen_eval", gen_eval.main, [
        "--ckpt", files["sd"], "--subjects_root", root, "--subjects", *EVAL_SUBJECTS,
        "--max_prompts", str(EVAL_PROMPTS), "--n_per_prompt", str(EVAL_IMAGES),
        "--adaface_ckpt", files["adaface"], "--arcface_ckpt", files["arcface"],
        "--outdir", out], len(EVAL_SUBJECTS) * EVAL_PROMPTS, card)
    by_path = {"cli_gen_eval": launches}
    with open(os.path.join(out, "scores.csv"), newline="") as f:
        table = list(csv.DictReader(f))
    if [r["subject"] for r in table] != list(EVAL_SUBJECTS) or len(pairs) != len(EVAL_SUBJECTS):
        raise AssertionError(f"gen_eval scored {[r['subject'] for r in table]}")
    for r in table:
        _check_scores(f"gen_eval {r['subject']}", {k: float(v) for k, v in r.items()
                                                   if k != "subject"})
    imgs = {}
    for s in EVAL_SUBJECTS:
        names = sorted(os.listdir(os.path.join(out, s)))
        imgs[s] = np.stack([read_png(os.path.join(out, s, n)) for n in names])
        if len(names) != EVAL_PROMPTS * EVAL_IMAGES or imgs[s].shape[1:] != (512, 512, 3) or \
                not all(im.std() > 0 for im in imgs[s]):
            raise AssertionError(f"gen_eval {s}: {names}, {imgs[s].shape}")
    log("phase 15 cli_gen_eval: scores.csv " + "; ".join(
        f"{r['subject']} " + " ".join(f"{k} {float(v):.4f}" for k, v in r.items()
                                      if k != "subject") for r in table)
        + f"; {sum(len(v) for v in imgs.values())} PNGs 512x512, std "
        f"{[round(float(v.std()), 2) for v in imgs.values()]}")

    # (c) txt2img --compare_with
    folder = os.path.join(root, EVAL_SUBJECTS[1])
    out = os.path.join(tmp, "txt2img_compare")
    paths, _, pairs, launches = _run_eval_cli("cli_txt2img_compare", txt2img.main, [
        "--ckpt", files["sd"], "--adaface_ckpt", files["adaface"], "--ref_images", folder,
        "--arcface_ckpt", files["arcface"], "--prompt", "a photo of a z person in the park",
        "--n_samples", str(EVAL_IMAGES), "--compare_with", folder, "--outdir", out], 1, card)
    by_path["cli_txt2img_compare"] = launches
    (pair,) = pairs
    scores = {k: getattr(pair["scores"], k) for k in ("sim_img", "sim_text", "sim_dino")}
    _check_scores("txt2img --compare_with", scores)
    if pair["scores"].sim_face is not None or len(paths) != EVAL_IMAGES:
        raise AssertionError(f"txt2img --compare_with: {paths}, {pair['scores']}")
    log(f"phase 15 cli_txt2img_compare: " + " ".join(f"{k} {v:.4f}" for k, v in scores.items()))

    # (d) image metrics: (b)'s first subject's first prompt against (c)'s images
    a = imgs[EVAL_SUBJECTS[0]][:EVAL_IMAGES]
    b = np.stack([read_png(p) for p in paths])
    t0 = time.perf_counter()
    psnr, ssim = image_metrics.psnr(a, b), image_metrics.ssim(a, b)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cos = image_metrics.random_arcface_cosine(a, b)       # IResNet-100, random, on the card
    cos_s = time.perf_counter() - t0
    same = image_metrics.random_arcface_cosine(a, a)
    log(f"phase 15 image_metrics: {EVAL_IMAGES} gen_eval images against {EVAL_IMAGES} txt2img "
        f"images: PSNR {psnr:.4f} dB, SSIM {ssim:.6f} ({host_s:.3f} s on the host), "
        f"IResNet-100 random-feature cosine {cos:.6f} ({cos_s:.3f} s, weights made from the "
        f"seed included), against itself {same:.6f}; {card}")
    if not (math.isfinite(psnr) or np.array_equal(a, b)) or not -1.0 <= ssim <= 1.0 or \
            not -1.0 <= cos <= 1.0 or abs(same - 1.0) > 1e-4:
        raise AssertionError(f"image metrics PSNR {psnr}, SSIM {ssim}, cosine {cos}, {same}")
    log(f"phase 15: {time.perf_counter() - t_phase:.1f} s; {card}")
    return by_path


# ---------------------------------------------------------------------------
# Phase 16: face detection (RetinaFace R50, BiSeNet parsing, the alignment),
# the detectors of the CLIs, gen_face_masks and face_tools
# ---------------------------------------------------------------------------

DETECT_TOL = 1e-4       # fp32 card (TF32 off) vs fp32 CPU, relative L2
DETECT_PASS = 0.01      # the share of a noise canvas's anchors the seeded RetinaFace scores > 0.5
PARSE_BATCH = 8         # BiSeNet's batch at 512x512 (gen_face_masks' default)


def _seeded_retinaface(seed):
    """A RetinaFace with random weights from `seed` on the card, its heads
    scaled on the canvas of a seeded 512x512 noise photo so that the
    face-logit margin has std 2
    and the boxes and landmarks std 1, the face channels' bias set so that
    DETECT_PASS of the anchors score above 0.5 (random ResNet weights leave
    the heads at std ~80, and half the anchors above it)."""
    import numpy as np
    import torch
    from adaprompt_tpu_torch.models.retinaface import RetinaFace, canvas
    model = RetinaFace.random_init(seed, device="cuda")
    noise = np.random.default_rng(seed).integers(0, 256, (512, 512, 3), dtype=np.uint8)
    x = torch.from_numpy(canvas(noise)[0][None]).cuda()
    with torch.no_grad():
        logits, loc, ldm = model(x)
        margin = logits[0, :, 1] - logits[0, :, 0]
        for name, scale in (("ClassHead", 2.0 / margin.std()), ("BboxHead", 1.0 / loc.std()),
                            ("LandmarkHead", 1.0 / ldm.std())):
            for conv in model.heads[name]:
                conv.weight.mul_(scale)
        logits = model(x)[0]
        cut = torch.quantile(logits[0, :, 1] - logits[0, :, 0], 1.0 - DETECT_PASS)
        for conv in model.heads["ClassHead"]:
            conv.bias[1::2] -= cut              # channel 2a + 1: anchor a's face logit
    return model


def _pair_ious(boxes, i, j):
    """IoU of boxes i and j (index arrays), as `retinaface.nms` computes it."""
    import numpy as np
    x0, y0, x1, y1 = boxes.T
    areas = np.maximum(x1 - x0, 0) * np.maximum(y1 - y0, 0)
    inter = (np.maximum(np.minimum(x1[i], x1[j]) - np.maximum(x0[i], x0[j]), 0)
             * np.maximum(np.minimum(y1[i], y1[j]) - np.maximum(y0[i], y0[j]), 0))
    return inter / (areas[i] + areas[j] - inter + 1e-12)


def _nms_pairs(boxes, scores, iou_thresh=0.4):
    """The comparisons the host NMS (`retinaface.nms`) makes: (kept box i,
    each remaining box j, their IoU), as arrays."""
    import numpy as np
    order = np.argsort(scores)[::-1]
    out = []
    while order.size:
        i, rest = np.full(order.size - 1, order[0]), order[1:]
        iou = _pair_ious(boxes, i, rest)
        out.append((i, rest, iou))
        order = rest[iou <= iou_thresh]
    if not out:
        return np.zeros(0, int), np.zeros(0, int), np.zeros(0)
    return tuple(np.concatenate(a) for a in zip(*out))


def _compare_detections(cpu, card, hw, scale):
    """detect_faces' host decoding and NMS of one photo's head outputs from
    the CPU and from the card: equal detections unless a near-tie (a score
    within 4x the measured probability error of 0.5, two candidates' scores
    within it of each other, or an IoU the NMS compares within 4x the
    measured IoU error of 0.4) could flip one. Returns (detections, near-tie
    counts, probability error, IoU error, equal)."""
    import numpy as np
    from adaprompt_tpu_torch.models import retinaface as trf
    (pc, lc, dc), (pg, lg, dg) = cpu, card
    p_err = float(np.abs(pg - pc).max())
    tol = 4 * p_err + 1e-7
    keep = pc > 0.5
    near = {"threshold": int((np.abs(pc - 0.5) <= tol).sum()), "order": 0, "iou": 0}
    pri = trf.priors(640, 640)
    iou_err = 0.0
    if near["threshold"] == 0:
        bc = trf.decode_boxes(lc[keep], pri[keep])
        bg = trf.decode_boxes(lg[keep], pri[keep])
        i, j, iou = _nms_pairs(bc, pc[keep])
        if len(i):
            iou_err = float(np.abs(_pair_ious(bg, i, j) - iou).max())
            iou_tol = 4 * iou_err + 1e-7
            near["iou"] = int((np.abs(iou - 0.4) <= iou_tol).sum())
            # two overlapping candidates whose order could swap (the first kept suppresses)
            near["order"] = int(((np.abs(pc[keep][i] - pc[keep][j]) <= tol)
                                 & (iou > 0.4 - iou_tol)).sum())
    det_c = trf.decode_detections(pc, lc, dc, hw, scale)
    det_g = trf.decode_detections(pg, lg, dg, hw, scale)
    equal = len(det_c[1]) == len(det_g[1]) and all(
        np.allclose(a, b, atol=tol_abs, rtol=0) for a, b, tol_abs in
        zip(det_g, det_c, (1e-2, tol, 1e-2)))
    return det_g, near, p_err, iou_err, equal


def _detector_files(tmp):
    """(a) The seeded RetinaFace and BiSeNet written in the public layouts
    (random BatchNorm statistics); their paths and the models loaded back
    from them on the card and on the CPU."""
    import os
    import torch
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    import reference_layouts as rl
    from adaprompt_tpu_torch.models import bisenet, retinaface
    paths = {"retinaface": os.path.join(tmp, "Resnet50_Final-random.pth"),
             "bisenet": os.path.join(tmp, "79999_iter-random.pth")}
    torch.save(rl.retinaface_pytorch(_seeded_retinaface(16), seed=16), paths["retinaface"])
    torch.save(rl.bisenet_face_parsing(bisenet.BiSeNet.random_init(17, device="cuda"), seed=17),
               paths["bisenet"])
    models = {(name, dev): mod.load(paths[name], device=dev)
              for name, mod in (("retinaface", retinaface), ("bisenet", bisenet))
              for dev in ("cuda", "cpu")}
    return paths, models


def _detection_forwards(models, photos, parse_photos, card):
    """(b) RetinaFace's heads on the photos' 640 canvases and BiSeNet's
    logits at PARSE_BATCH x 512x512, fp32 card (TF32 off, then on) against
    the CPU; returns (the canvases and scales, the head outputs {device:
    (probs, loc, ldm)})."""
    import numpy as np
    import torch
    from adaprompt_tpu_torch.models import bisenet as tbis, retinaface as trf
    from adaprompt_tpu_torch.utils.resize import pil_bilinear
    canv = [trf.canvas(p) for p in photos]
    x = np.stack([c for c, _ in canv])
    errs, heads = {}, {}
    with torch.no_grad():
        raw = {dev: models["retinaface", dev](torch.from_numpy(x).to(dev)) for dev in ("cpu", "cuda")}
        for name, c, g in zip(("class", "boxes", "landmarks"), raw["cpu"], raw["cuda"]):
            errs["retinaface_" + name] = _rel(g, c)
        for dev, (logits, loc, ldm) in raw.items():     # head_outputs' softmax, on each device
            heads[dev] = (torch.softmax(logits, dim=-1)[..., 1].cpu().numpy(),
                          loc.cpu().numpy(), ldm.cpu().numpy())
        parse_in = np.stack([pil_bilinear(p, 512, 512) for p in parse_photos[:PARSE_BATCH]])
        xb = torch.from_numpy(tbis.preprocess(parse_in))
        lc = models["bisenet", "cpu"](xb)
        lg = models["bisenet", "cuda"](xb.cuda())
        errs["bisenet_logits"] = _rel(lg, lc)
        torch.backends.cudnn.allow_tf32 = True
        try:
            tf32 = {"retinaface_class": _rel(models["retinaface", "cuda"](
                        torch.from_numpy(x).cuda())[0], raw["cpu"][0]),
                    "bisenet_logits": _rel(models["bisenet", "cuda"](xb.cuda()), lc)}
            lab_tf32 = models["bisenet", "cuda"](xb.cuda()).argmax(-1).cpu()
        finally:
            torch.backends.cudnn.allow_tf32 = False
    lc, lg = lc.numpy(), lg.cpu().numpy()
    err = float(np.abs(lg - lc).max())
    top2 = np.sort(lc, axis=-1)
    gap = top2[..., -1] - top2[..., -2]
    clear = gap > err
    lab_c, lab_g = lc.argmax(-1), lg.argmax(-1)
    flips = int((lab_c != lab_g)[clear].sum())
    log(f"phase 16 forwards: RetinaFace R50 {len(photos)} canvases 640x640, BiSeNet "
        f"{PARSE_BATCH}x512x512, fp32 card vs fp32 CPU relative L2 "
        f"{({k: f'{v:.3e}' for k, v in errs.items()})} (bound {DETECT_TOL:g}); with TF32 "
        f"convolutions (PyTorch's default, cudnn.allow_tf32=True) "
        f"{({k: f'{v:.3e}' for k, v in tf32.items()})}, BiSeNet labels differing from the "
        f"CPU's {int((lab_tf32.numpy() != lab_c).sum())} of {lab_c.size}; BiSeNet max |logit "
        f"error| {err:.3e}, near-ties (top-two gap <= it) {int((~clear).sum())} of {clear.size}, "
        f"labels differing elsewhere {flips}; {card}")
    bad = {k: v for k, v in errs.items() if not (math.isfinite(v) and v <= DETECT_TOL)}
    if bad or flips:
        raise AssertionError(f"the detectors on the card disagree with the CPU: {bad}, {flips} "
                             "labels flipped away from near-ties")
    return canv, heads


def _detect_timings(models, photos, card):
    """(d) detect_faces split per photo (canvas, forward + softmax, decoding
    and NMS, similarity and warp), the forward's device time at 640 and
    BiSeNet's at PARSE_BATCH x 512, and FaceSimilarityEvaluator over 3
    photos with each detector against the centre crop."""
    import numpy as np
    import torch
    from adaprompt_tpu_torch.cli import common
    from adaprompt_tpu_torch.eval import face_detect as tfd
    from adaprompt_tpu_torch.eval.face_eval import FaceSimilarityEvaluator, make_detector
    from adaprompt_tpu_torch.models import retinaface as trf
    rf = models["retinaface", "cuda"]
    split = {"canvas": [], "forward": [], "decode_nms": [], "warp": []}
    faces = []
    for img in photos:
        for _ in range(2):                  # the second pass timed
            t0 = time.perf_counter()
            x, scale = trf.canvas(img)
            t1 = time.perf_counter()
            probs, loc, ldm = trf.head_outputs(rf, x[None])
            t2 = time.perf_counter()
            boxes, scores, landms = trf.decode_detections(probs[0], loc[0], ldm[0],
                                                          img.shape[:2], scale)
            t3 = time.perf_counter()
            crops = [tfd.warp_affine(img, tfd.umeyama_similarity(l, tfd.ARCFACE_TEMPLATE), 112)
                     for l in landms[:4]]
            t4 = time.perf_counter()
        for k, a, b in (("canvas", t0, t1), ("forward", t1, t2), ("decode_nms", t2, t3),
                        ("warp", t3, t4)):
            split[k].append((b - a) * 1e3)
        faces.append(len(crops))
    xb = torch.from_numpy(np.random.default_rng(18).normal(0, 60, (1, 640, 640, 3))
                          .astype(np.float32)).cuda()
    xp = torch.from_numpy(np.random.default_rng(19).normal(0, 1, (PARSE_BATCH, 512, 512, 3))
                          .astype(np.float32)).cuda()
    with torch.no_grad():
        rf_ms = time_ms(lambda: rf(xb), 5)
        bis_ms = time_ms(lambda: models["bisenet", "cuda"](xp), 5)
    arc = common.load_arcface(None, "cuda")
    dets = {"retinaface": tfd.make_retinaface_detector(rf),
            "bisenet": tfd.make_bisenet_detector(models["bisenet", "cuda"]),
            "center_crop": make_detector("center_crop")}
    three, ev_s, found = photos[:3], {}, {}
    for name, det in dets.items():
        ev = FaceSimilarityEvaluator(arc, detector=det)
        ev(images_np=three)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        embs = ev(images_np=three)
        torch.cuda.synchronize()
        ev_s[name] = time.perf_counter() - t0
        found[name] = 0 if embs is None else len(embs)
    log(f"phase 16 detect_faces a photo (ms, photos 512x512 to 600x560): " + ", ".join(
        f"{k} {[round(v, 2) for v in vs]}" for k, vs in split.items())
        + f"; faces kept {faces}; RetinaFace forward at 640 {rf_ms:.3f} ms on the device, "
        f"BiSeNet {PARSE_BATCH}x512x512 {bis_ms:.3f} ms; FaceSimilarityEvaluator over 3 photos "
        + ", ".join(f"{k} {v * 1e3:.1f} ms ({found[k]} embeddings)" for k, v in ev_s.items())
        + f"; {card}")
    if found["center_crop"] != 3:
        raise AssertionError(f"the centre crop embedded {found['center_crop']} photos")
    return dict(split=split, rf_ms=rf_ms, bis_ms=bis_ms, evaluator_s=ev_s)


def _parse_subjects(root, model):
    """Each photo of the subject folders under `root` resized to 512x512 as
    gen_face_masks resizes it, and its labels from parse_faces in the same
    batches: {(subject, name): (image, labels)}."""
    import os
    from adaprompt_tpu_torch.cli.gen_face_masks import _list_images
    from adaprompt_tpu_torch.models import bisenet as tbis
    from adaprompt_tpu_torch.utils.png import read_image_mode
    from adaprompt_tpu_torch.utils.resize import pil_bilinear_rgb
    out = {}
    for subj in sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))):
        names = _list_images(os.path.join(root, subj))
        for i in range(0, len(names), PARSE_BATCH):
            chunk = names[i:i + PARSE_BATCH]
            imgs = []
            for n in chunk:
                mode, px, palette = read_image_mode(os.path.join(root, subj, n))
                imgs.append(pil_bilinear_rgb(mode, px, 512, 512, palette))
            for name, img, lab in zip(chunk, imgs, tbis.parse_faces(model, imgs)):
                out[subj, name] = (img, lab)
    return out


def _check_face_masks(root, out, result, parsed, trash, inspect):
    """(f) gen_face_masks' files against `_parse_subjects`: each photo
    written as its resized image and a mask (mode L, values in {0, 255})
    equal to (labels != 0) * 255, or copied where its part count sends it
    (<= trash, >= inspect). Returns the photos written, trashed, inspected."""
    import os
    import numpy as np
    from adaprompt_tpu_torch.utils.png import read_png, read_png_mode
    parts, where = {}, {"out": 0, "trash": 0, "inspect": 0}
    for (subj, name), (img, lab) in parsed.items():
        n = len(np.unique(lab))
        parts[n] = parts.get(n, 0) + 1
        kind = "trash" if n <= trash else "inspect" if n >= inspect else "out"
        where[kind] += 1
        if kind != "out":
            if not os.path.exists(os.path.join(f"{root}_{kind}", subj, name)):
                raise AssertionError(f"gen_face_masks: {subj}/{name} ({n} parts) not in {kind}")
            continue
        mode, mask, _ = read_png_mode(os.path.join(out, subj, name[:-4] + "_mask.png"))
        if mode != "L" or not set(np.unique(mask)) <= {0, 255} or \
                not np.array_equal(mask, (lab != 0).astype(np.uint8) * 255) or \
                not np.array_equal(read_png(os.path.join(out, subj, name)), img):
            raise AssertionError(f"gen_face_masks: {subj}/{name}'s files differ from the "
                                 "in-memory parse")
    if parts != result["parts"] or where["out"] != result["written"]:
        raise AssertionError(f"gen_face_masks: {result} against the in-memory parse {parts}")
    return where


def phase_detect(tmp, files, root):
    """Phase 16, after phase 15 in its temporary directory: face detection
    over phase 13's files and phase 14's subjects (see the module's phase
    list, (a)-(h)). Returns {path: launch counts}."""
    import importlib.util
    import os
    import shutil
    import numpy as np
    import torch
    from adaprompt_tpu_torch.cli import face_tools, gen_face_masks, infer
    from adaprompt_tpu_torch.cli.gen_face_masks import _list_images
    from adaprompt_tpu_torch.models import bisenet as tbis, retinaface as trf
    from adaprompt_tpu_torch.utils.png import read_png
    card = card_line()
    t_phase = time.perf_counter()
    optional = {m: importlib.util.find_spec(m) is not None
                for m in ("scipy", "cv2", "PIL", "yaml", "safetensors", "regex", "onnx")}
    log(f"phase 16 packages importable here (the port needs none of them): {optional}")

    # (a) the weight files
    t0 = time.perf_counter()
    paths, models = _detector_files(tmp)
    n_params = {name: sum(p.numel() for p in models[name, "cuda"].parameters()) / 1e6
                for name in paths}
    log(f"phase 16 files: " + ", ".join(f"{os.path.basename(p)} {os.path.getsize(p) / 2 ** 20:.1f} "
                                        f"MiB" for p in paths.values())
        + f"; written and loaded (card and CPU) in {time.perf_counter() - t0:.1f} s; parameters "
        f"(M, running statistics aside) {({k: round(v, 2) for k, v in n_params.items()})}")
    detect_calls = _PatchedCalls(trf, "detect_faces")
    parse_calls = _PatchedCalls(tbis, "parse_faces")
    detect_calls.__enter__()
    parse_calls.__enter__()
    try:
        # (b) the forwards, card against CPU
        subject_photos = [read_png(os.path.join(root, s, n))
                          for s in sorted(os.listdir(root)) if os.path.isdir(os.path.join(root, s))
                          for n in _list_images(os.path.join(root, s))]
        photos = [read_png(os.path.join(root, "subject0", "0.png")),
                  read_png(os.path.join(root, "subject0", "wide.png")),
                  read_png(os.path.join(root, "subject1", "1.png")),
                  np.random.default_rng(16).integers(0, 256, (333, 517, 3), dtype=np.uint8)]
        canv, heads = _detection_forwards(models, photos, subject_photos, card)

        # (c) the host decoding and NMS of both devices' outputs
        summary = []
        for k, (img, (_, scale)) in enumerate(zip(photos, canv)):
            cpu = tuple(a[k] for a in heads["cpu"])
            dev = tuple(a[k] for a in heads["cuda"])
            det, near, p_err, iou_err, equal = _compare_detections(cpu, dev, img.shape[:2], scale)
            summary.append(f"{img.shape[1]}x{img.shape[0]}: {len(det[1])} faces, "
                           f"{int((cpu[0] > 0.5).sum())} candidates, |dp| {p_err:.2e}, |dIoU| "
                           f"{iou_err:.2e}, near-ties {near}, equal {equal}")
            if not equal and not any(near.values()):
                raise AssertionError(f"detections on the card differ from the CPU's with no "
                                     f"near-tie: {summary[-1]}")
            if not len(det[1]):
                raise AssertionError(f"the seeded RetinaFace found no face: {summary[-1]}")
        log("phase 16 detections, card vs CPU head outputs: " + "; ".join(summary))

        # (d) the detectors behind the evaluator, timed
        timings = _detect_timings(models, photos, card)

        # (e) infer with $ADAPROMPT_RETINAFACE_CKPT
        by_path = {}
        os.environ["ADAPROMPT_RETINAFACE_CKPT"] = paths["retinaface"]
        try:
            n_before = len(detect_calls.calls)
            out_dir = os.path.join(tmp, "infer_retinaface")
            cli_paths, timers = _run_cli("cli_infer_retinaface", infer.main, [
                "--ckpt", files["sd"], "--subject", os.path.join(tmp, "photos"),
                "--adaface_ckpt", files["adaface"], "--arcface_ckpt", files["arcface"],
                "--prompt", "portrait of a z person", "--out_image_count", str(CLI_IMAGES),
                "--num_steps", str(CLI_STEPS), "--outdir", out_dir], card)
            by_path["cli_infer_retinaface"] = read_counts()
            _check_cli_images("cli_infer_retinaface", cli_paths,
                              [c[2] for c in timers["generate"].calls])
            n_det = len(detect_calls.calls) - n_before
            (_, _, vecs, during), = timers["personalize"].calls
            if n_det != 3 or during or tuple(vecs.shape) != (16, 768):
                raise AssertionError(f"infer with RetinaFace: {n_det} detect_faces calls, "
                                     f"launches {during} while personalizing, {vecs.shape}")
            (w13, p13), (w16, p16) = CLI_SECONDS["cli_infer"], CLI_SECONDS["cli_infer_retinaface"]
            log(f"phase 16 cli_infer_retinaface: {n_det} photos through RetinaFace; main(argv) "
                f"{w16:.3f} s against phase 13's centre crop {w13:.3f} s; personalization "
                f"{p16 * 1e3:.1f} ms against {p13 * 1e3:.1f} ms; {card}")

            # (g) face_tools over phase 14's subjects, RetinaFace from the environment
            zero_counts()
            arc = ["--arcface_ckpt", files["arcface"]]
            t0 = time.perf_counter()
            avg, n_ok, n_nf = face_tools.main(arc + ["compare", os.path.join(root, "subject0"),
                                                     os.path.join(root, "subject1")])
            nearest = face_tools.main(arc + ["knn", os.path.join(root, "subject0", "0.png"),
                                             os.path.join(root, "subject1"), "--k", "2"])
            src = shutil.copytree(os.path.join(root, "subject2"), os.path.join(tmp, "filter_src"))
            n_src = len(os.listdir(src))
            rejected = face_tools.main(arc + ["filter", src, "--threshold", "0.5", "--reject_dir",
                                              os.path.join(tmp, "rejected")])
            tools_s = time.perf_counter() - t0
            moved = os.listdir(os.path.join(tmp, "rejected"))
            if not (-1 <= avg <= 1 and n_ok + n_nf == 6 and len(nearest) <= 2
                    and len(moved) == len(rejected) and len(moved) + len(os.listdir(src)) == n_src
                    and not nz(read_counts())):
                raise AssertionError(f"face_tools: compare {avg, n_ok, n_nf}, knn {nearest}, "
                                     f"filter {rejected}, launches {nz(read_counts())}")
            log(f"phase 16 face_tools: compare {avg:.4f} ({n_ok} scored, {n_nf} faceless), knn "
                f"{[(round(s, 4), os.path.basename(p)) for s, p in nearest]}, filter rejected "
                f"{len(rejected)} of {n_src} files at 0.5; {tools_s:.3f} s with 3 model loads; "
                "no launch")
        finally:
            del os.environ["ADAPROMPT_RETINAFACE_CKPT"]

        # (f) gen_face_masks over phase 14's subjects, its thresholds at the ends of the
        # photos' part counts (so that it trashes, inspects and writes as the counts allow)
        parsed = _parse_subjects(root, models["bisenet", "cuda"])
        counts = sorted({len(np.unique(lab)) for _, lab in parsed.values()})
        trash = counts[0] if len(counts) >= 2 else -1
        inspect = counts[-1] if len(counts) >= 3 else 10000
        zero_counts()
        out = os.path.join(tmp, "face_masks")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = gen_face_masks.main([
            "--bisenet_ckpt", paths["bisenet"], "--src", root, "--out", out, "--batch_size",
            str(PARSE_BATCH), "--trash_min_parts", str(trash), "--inspect_max_parts",
            str(inspect)])
        torch.cuda.synchronize()
        masks_s = time.perf_counter() - t0
        if nz(read_counts()):
            raise AssertionError(f"gen_face_masks launched {nz(read_counts())}")
        where = _check_face_masks(root, out, result, parsed, trash, inspect)
        log(f"phase 16 gen_face_masks: {len(parsed)} photos (batches of up to {PARSE_BATCH}, "
            f"cut at each subject folder) in {masks_s:.3f} s with the model load, "
            f"{len(parsed) / masks_s:.2f} images/s; parts {result['parts']}, thresholds "
            f"{trash} / {inspect}; {where} as an in-memory parse_faces of the same batches "
            "implies; masks in {0, 255} equal to its labels")
        if not where["out"]:
            raise AssertionError("gen_face_masks wrote no mask")

        # (h) one Stage-1 step of the training CLI with --detector retinaface:<pth>
        n_before = len(detect_calls.calls)
        rows, _, _, launches = _run_train_cli("cli_train_detector", [
            "--ckpt", files["sd"], "--data_roots", root, "--arc2face_ckpt", files["sd"],
            "--arcface_ckpt", files["arcface"], "--detector", "retinaface:" + paths["retinaface"],
            "--stage", "1", "--bs", "4", "--num_steps", "1", "--seed", "16",
            "--out_dir", os.path.join(tmp, "train_detector")], card)
        _check_train_rows("cli_train_detector", rows, range(1))
        _check_train_launches("cli_train_detector", launches, _train_cli_want(rows))
        n_det = len(detect_calls.calls) - n_before
        if n_det < 4:
            raise AssertionError(f"cli_train_detector ran detect_faces {n_det} times")
        by_path["cli_train_detector"] = launches
        log(f"phase 16 cli_train_detector: {n_det} photos through RetinaFace in one step")
    finally:
        parse_calls.__exit__()
        detect_calls.__exit__()
    inside = [c[3] for c in detect_calls.calls + parse_calls.calls if c[3]]
    if inside:
        raise AssertionError(f"detection or parsing launched kernels: {inside[:4]}")
    log(f"phase 16: {len(detect_calls.calls)} detect_faces and {len(parse_calls.calls)} "
        f"parse_faces calls, no kernel launched inside any; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
        f"{time.perf_counter() - t_phase:.1f} s; {card}")
    return by_path


# ---------------------------------------------------------------------------
# Phase 17: img2img sampling, the translate, arc2face_gen and demo CLIs, and
# the diffusers-format loaders
# ---------------------------------------------------------------------------

IMG2IMG_STEPS = 10          # (a) and (b): DDIM-10 on phase 13's UNet, 2 images (UNet batch 4)
TRANSLATE_STEPS, TRANSLATE_STRENGTH = 50, 0.8       # translate's defaults: t_start 40
ARC2FACE_STEPS, ARC2FACE_IMAGES = 20, 2
DEMO_STEPS = 20


def _run_counted(path, main, argv, patched, card, passes):
    """main(argv) from zeroed counts, under the _PatchedCalls `patched`
    ({name: (owner, attribute)}); its launches checked. Returns (main's
    result, {name: _PatchedCalls}, seconds, launch counts)."""
    import torch
    timers = {k: _PatchedCalls(*v) for k, v in patched.items()}
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for tm in timers.values():
        tm.__enter__()
    try:
        out = main(argv)
    finally:
        for tm in timers.values():
            tm.__exit__()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    log(f"phase 17 {path}: main(argv) {seconds:.3f} s; "
        + ", ".join(f"{k} {v.seconds:.3f} s ({len(v.calls)} calls)" for k, v in timers.items())
        + f"; peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches "
        f"{nz(counts)}; {card}")
    _check_cli_launches(path, counts, passes)
    return out, timers, seconds, counts


def _img2img_options(pipe, photo, card):
    """(a) ddim_decode from the top equals ddim_sample; (b) eta=0.0 given
    equals the default, an all-zero mask equals no mask (all bit for bit),
    and eta 0.5 with a half mask is repeatable from one generator seed."""
    import numpy as np
    import torch
    from adaprompt_tpu_torch.pipeline import DEFAULT_NEGATIVE_PROMPT, eps_model
    from adaprompt_tpu_torch.sampling import ddim
    dt = pipe.compute_dtype
    with torch.inference_mode():
        cond = pipe.encode_prompt(["a photo of a person"] * 2)
        uncond = pipe.encode_prompt([DEFAULT_NEGATIVE_PROMPT] * 2)
        model_fn = eps_model(pipe.unet, torch.cat([cond, uncond])[None].to(dt), dt,
                             pipe.unet_cfg)
        g = torch.Generator(device="cuda").manual_seed(17)
        x_T = torch.randn((2, 64, 64, 4), generator=g, device="cuda")
        x0 = pipe.encode_image(np.stack([photo] * 2).astype(np.float32) / np.float32(127.5)
                               - 1.0)
        half = torch.zeros_like(x_T)
        half[:, :, :32] = 1.0
        kw = dict(num_steps=IMG2IMG_STEPS, guidance_scale=4.0, sched=pipe.sched)
        runs, secs = {}, {}
        for name, fn in (
                ("sample", lambda: ddim.ddim_sample(model_fn, x_T, **kw)),
                ("decode", lambda: ddim.ddim_decode(model_fn, x_T, IMG2IMG_STEPS, **kw)),
                ("eta_0", lambda: ddim.ddim_sample(model_fn, x_T, eta=0.0, **kw)),
                ("mask_0", lambda: ddim.ddim_sample(model_fn, x_T, mask=torch.zeros_like(x_T),
                                                    x0=x0, **kw)),
                ("eta_0.5_mask", lambda: ddim.ddim_sample(
                    model_fn, x_T, eta=0.5, mask=half, x0=x0,
                    generator=torch.Generator(device="cuda").manual_seed(5), **kw)),
                ("eta_0.5_mask_again", lambda: ddim.ddim_sample(
                    model_fn, x_T, eta=0.5, mask=half, x0=x0,
                    generator=torch.Generator(device="cuda").manual_seed(5), **kw))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[name] = fn()
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
    ref = runs["sample"]
    for name in ("decode", "eta_0", "mask_0"):
        if not torch.equal(runs[name], ref):
            raise AssertionError(f"phase 17 {name} differs from ddim_sample: max "
                                 f"{float((runs[name] - ref).abs().max())}")
    a, b = runs["eta_0.5_mask"], runs["eta_0.5_mask_again"]
    if not (torch.equal(a, b) and bool(torch.isfinite(a).all())):
        raise AssertionError("phase 17 eta 0.5 with a mask: two runs from one seed differ or "
                             "are not finite")
    moved = float((a - ref).abs().max())
    if not moved > 0:
        raise AssertionError("phase 17 eta 0.5 with a mask left ddim_sample's result as it was")
    log(f"phase 17 (a) ddim_decode(t_start={IMG2IMG_STEPS}) equals ddim_sample bit for bit; "
        f"(b) eta=0.0 given and an all-zero mask equal the default bit for bit, eta 0.5 with a "
        f"half mask twice from seed 5 bit-equal and finite (max |diff| from eta 0: "
        f"{moved:.4f}); DDIM-{IMG2IMG_STEPS}, 2 images 512x512, seconds "
        + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()) + f"; {card}")


def _diffusers_loaders(pipe, out_path, card):
    """(d) The loaded pipeline's UNet and VAE written in the diffusers
    layout, in both forms, read back through the port's loaders: parameters
    and a forward bit-equal. The conv-form UNet is saved to `out_path` in
    the weights' own dtype, for arc2face_gen."""
    import os
    import torch
    import reference_layouts as rl
    from adaprompt_tpu_torch.models.unet import UNet
    from adaprompt_tpu_torch.models.vae import VAE
    from adaprompt_tpu_torch.utils.diffusers_port import unet_from_diffusers, vae_from_diffusers
    g = torch.Generator(device="cuda").manual_seed(18)
    x = torch.randn((2, 64, 64, 4), generator=g, device="cuda").to(pipe.compute_dtype)
    ctx = torch.randn((2, 77, 768), generator=g, device="cuda").to(pipe.compute_dtype)
    ts = torch.tensor([981, 501], device="cuda")
    z = torch.randn((1, 64, 64, 4), generator=g, device="cuda").to(pipe.compute_dtype)
    with torch.inference_mode():
        eps_want, img_want = pipe.unet(x, ts, ctx), pipe.vae.decode(z)
    secs = {}
    for kind, forms in (("unet", ({}, {"linear_proj": True})),
                        ("vae", ({}, {"legacy_attn_names": True}))):
        module = getattr(pipe, kind)
        want = module.state_dict()
        for form in forms:
            tag = f"{kind}{'_' + next(iter(form)) if form else ''}"
            t0 = time.perf_counter()
            sd = (rl.unet_diffusers if kind == "unet" else rl.vae_diffusers)(module, **form)
            t1 = time.perf_counter()
            cls, load = (UNet, unet_from_diffusers) if kind == "unet" else (VAE, vae_from_diffusers)
            got = cls(module.cfg, device="cuda", dtype=pipe.compute_dtype)
            got.load_state_dict(load(sd, module.cfg), strict=True)
            torch.cuda.synchronize()
            secs[tag] = (t1 - t0, time.perf_counter() - t1)
            bad = [k for k, v in got.state_dict().items() if not torch.equal(v, want[k])]
            with torch.inference_mode():
                same = torch.equal(got(x, ts, ctx), eps_want) if kind == "unet" else \
                    torch.equal(got.decode(z), img_want)
            if bad or not same:
                raise AssertionError(f"phase 17 {tag}: parameters {bad[:6]} or the forward "
                                     "differ from the module written")
            if kind == "unet" and not form:
                t0 = time.perf_counter()
                torch.save({k: v.to(pipe.compute_dtype) for k, v in sd.items()}, out_path)
                secs["save"] = (time.perf_counter() - t0, 0.0)
            del sd, got
    n = sum(p.numel() for p in pipe.unet.parameters()) + sum(
        p.numel() for p in pipe.vae.parameters())
    log(f"phase 17 (d) diffusers loaders: UNet and VAE ({n / 1e6:.1f} M parameters) in both "
        f"forms bit-equal to the modules written, the UNet forward and VAE decode bit-equal; "
        f"seconds (write, read and load) " + ", ".join(
            f"{k} {w:.3f}+{r:.3f}" for k, (w, r) in secs.items() if k != "save")
        + f"; the conv-form UNet saved as {os.path.getsize(out_path) / 2 ** 30:.2f} GiB "
        f"({pipe.compute_dtype}) in {secs['save'][0]:.3f} s; {card}")


def phase_img2img(tmp, files):
    """Phase 17, after phase 16 in its temporary directory, over phase 13's
    files (the SD .ckpt, the AdaFace .pt, the ArcFace .pth, the 3 photos):
    (c) translate.main at its defaults over the photos (DDIM-50, strength
    0.8: 40 steps a photo), first, for its loaded pipeline; (a) and (b) the
    img2img options on that pipeline's UNet; (d) the diffusers loaders at
    full width; (e) arc2face_gen.main with the LDM .ckpt and with (d)'s
    diffusers UNet file (the same weights: equal images); (f) the demo's
    main, warmup on, the REPL fed `subject`, `gen` and `quit` (gradio is
    kept from being imported, so that no server starts). Returns {path:
    launch counts}."""
    import builtins
    import contextlib
    import io
    import os
    import numpy as np
    from adaprompt_tpu_torch.adaface.wrapper import AdaFacePipeline
    from adaprompt_tpu_torch.cli import arc2face_gen, common, demo, translate
    from adaprompt_tpu_torch.eval.face_eval import list_images
    from adaprompt_tpu_torch.pipeline import StableDiffusionPipeline
    from adaprompt_tpu_torch.sampling import ddim
    from adaprompt_tpu_torch.utils.png import read_png
    card = card_line()
    t_phase = time.perf_counter()
    photos = os.path.join(tmp, "photos")
    photo_paths = list_images(photos)
    by_path = {}

    # (c) translate
    t_start = int(TRANSLATE_STEPS * TRANSLATE_STRENGTH)
    out = os.path.join(tmp, "translate")
    paths, timers, seconds, by_path["cli_translate"] = _run_counted(
        "cli_translate", translate.main,
        ["--ckpt", files["sd"], "--adaface_ckpt", files["adaface"], "--arcface_ckpt",
         files["arcface"], "--in_folder", photos, "--outdir", out],
        {"load_pipeline": (common, "load_pipeline"),
         "personalize": (AdaFacePipeline, "generate_adaface_embeddings"),
         "encode_image": (StableDiffusionPipeline, "encode_image"),
         "ddim_decode": (ddim, "ddim_decode"),
         "decode_latents": (StableDiffusionPipeline, "decode_latents")},
        card, len(photo_paths) * t_start)
    decoded = [c[2] for c in timers["decode_latents"].calls]
    dec = timers["ddim_decode"]
    if [os.path.basename(p) for p in paths] != [os.path.basename(p) for p in photo_paths]:
        raise AssertionError(f"translate wrote {paths}")
    for p, img in zip(paths, decoded):
        got = read_png(p)
        if got.shape != (512, 512, 3) or not np.array_equal(got, img[0]) or not got.std() > 0:
            raise AssertionError(f"translate's {p} is not the image decoded")
    log(f"phase 17 (c) cli_translate: {len(paths)} photos 512x512, {t_start} DDIM steps each "
        f"(UNet batch 2, {1e3 * dec.seconds / (len(paths) * t_start):.1f} ms a step): "
        f"{seconds / len(paths):.3f} s a photo all told, ddim_decode "
        f"{[round(c[0], 3) for c in dec.calls]} s, encode_image "
        f"{[round(c[0], 3) for c in timers['encode_image'].calls]} s; PNGs decoded equal to "
        f"decode_latents' images, std {[round(float(im.std()), 2) for im in decoded]}; {card}")
    pipe = timers["load_pipeline"].calls[0][2]

    # (a), (b), (d) on translate's loaded pipeline
    _img2img_options(pipe, read_png(photo_paths[0]), card)
    unet_file = os.path.join(tmp, "arc2face_unet_diffusers.bin")
    _diffusers_loaders(pipe, unet_file, card)
    del pipe, timers

    # (e) arc2face_gen from the LDM checkpoint, then from the diffusers UNet
    images = {}
    for path, teacher in (("cli_arc2face_gen_ldm", files["sd"]),
                          ("cli_arc2face_gen_diffusers", unet_file)):
        paths, timers, seconds, by_path[path] = _run_counted(
            path, arc2face_gen.main,
            ["--ckpt", files["sd"], "--arc2face_ckpt", teacher, "--ref_images", photos,
             "--arcface_ckpt", files["arcface"], "--n_samples", str(ARC2FACE_IMAGES),
             "--ddim_steps", str(ARC2FACE_STEPS), "--outdir", os.path.join(tmp, path)],
            {"load_pipeline": (common, "load_pipeline"),
             "load_teacher": (arc2face_gen, "load_teacher"),
             "generate": (StableDiffusionPipeline, "generate")}, card, ARC2FACE_STEPS)
        (_, kw, imgs, _), = timers["generate"].calls
        if tuple(kw["context"].shape) != (1, ARC2FACE_IMAGES, 21, 768) or len(paths) != 2 or \
                not all(np.array_equal(read_png(p), im) for p, im in zip(paths, imgs)):
            raise AssertionError(f"{path}: context {tuple(kw['context'].shape)}, {paths}")
        images[path] = imgs
    os.remove(unet_file)
    a, b = images.values()
    if not np.array_equal(a, b) or not a.std() > 0:
        raise AssertionError("arc2face_gen's images differ between the LDM and the diffusers "
                             f"loader: max {int(np.abs(a.astype(int) - b.astype(int)).max())}")
    log(f"phase 17 (e) arc2face_gen: the LDM checkpoint and the diffusers UNet give equal images "
        f"({ARC2FACE_IMAGES} 512x512, DDIM-{ARC2FACE_STEPS}, 21-key contexts), std "
        f"{a.std():.2f}; {card}")

    # (f) demo: warmup (1 and 4 images), then subject, gen, quit
    script = iter([f"subject {photos}", "gen portrait of a z", "quit"])
    stdout, saved_input, saved_gradio = io.StringIO(), builtins.input, sys.modules.get("gradio")
    builtins.input = lambda prompt="": next(script)
    sys.modules["gradio"] = None

    def demo_main(argv):
        with contextlib.redirect_stdout(stdout):
            return demo.main(argv)
    try:
        _, timers, seconds, by_path["cli_demo"] = _run_counted(
            "cli_demo", demo_main,
            ["--ckpt", files["sd"], "--adaface_ckpt", files["adaface"], "--num_steps",
             str(DEMO_STEPS), "--outdir", os.path.join(tmp, "demo")],
            {"load_pipeline": (common, "load_pipeline"),
             "warmup": (AdaFacePipeline, "warmup"),
             "generate": (StableDiffusionPipeline, "generate")}, card, 3 * DEMO_STEPS)
    finally:
        builtins.input = saved_input
        if saved_gradio is None:
            sys.modules.pop("gradio", None)
        else:
            sys.modules["gradio"] = saved_gradio
    text = stdout.getvalue()
    saved = [ln.split("saved: ", 1)[1] for ln in text.splitlines() if "saved: " in ln]
    gens = timers["generate"].calls
    if "gradio not installed — falling back to the REPL demo" not in text or \
            "subject loaded" not in text or len(saved) != 1 or len(gens) != 3 or \
            [c[2].shape[0] for c in gens] != [1, 4, 1] or \
            not np.array_equal(read_png(saved[0]), gens[-1][2][0]):
        raise AssertionError(f"demo: {text[-600:]!r}, generates {[c[2].shape for c in gens]}")
    log(f"phase 17 (f) cli_demo: main(argv) {seconds:.3f} s, warmup {timers['warmup'].seconds:.3f} s "
        f"(generates of 1 and 4 images, DDIM-{DEMO_STEPS}), the REPL's gen {gens[-1][0]:.3f} s, "
        f"printed the REPL fallback line, saved {os.path.basename(saved[0])} equal to its image; "
        f"{card}")
    log(f"phase 17: {time.perf_counter() - t_phase:.1f} s; {card}")
    return by_path


# ---------------------------------------------------------------------------
# Phase 18: the full-UNet recon step, the legacy Ada embedder, the class-delta
# functions and the train CLI's background overlays
# ---------------------------------------------------------------------------

RECON_UNET_STEPS = 3        # make_recon_step at batch 4, 512x512 (64x64 latents), AdamW
RECON_UNET_BATCH = 4
# step 1, bf16 kernels against the same step with every kernel's plain version
# in fp32 (TF32 off), on the same draws: relative error of the loss and of the
# gradient norm
RECON_UNET_LOSS_TOL = 1e-2
RECON_UNET_GNORM_TOL = 5e-2
ADA_TOL = 1e-4              # ada_forward fp32 card (TF32 off) vs fp32 CPU, relative L2
ADA_CFG = dict(num_vectors=9, fg_emb_count=4, bg_emb_count=4, rank=12, num_init_vecs=2)
OVERLAY_STEPS = 2
OVERLAY_BACKGROUNDS = (     # name, (h, w), caption: each accepted at --size 512
    ("lake.png", (560, 600), "a mountain lake at sunset"),
    ("street.jpg", (512, 640), "an empty city street at night"),
    ("beach.png", (640, 560), "a quiet beach with palm trees"),
    ("forest.jpg", (420, 440), "a foggy forest road in autumn"),
)
# a training forward with remat: B1 and B3 at each of the 10 fused-eligible
# layers (64x64 and 32x32 maps) twice (forward and recompute); B4 at each of
# them when the UNet's weights train, at 9 when only the context does (the
# first self-attention then needs no gradient)
UNET_STEP_LAUNCHES = dict(flash_attention_fwd=20, geglu_fwd=20, flash_attention_bwd=10)
CTX_STEP_LAUNCHES = dict(flash_attention_fwd=20, geglu_fwd=20,
                         flash_attention_bwd=FLASH_BWD_PER_PASS)


class _PlainKernels:
    """For the duration of a `with`, the UNet's flash attention and fused
    GEGLU go through their plain versions on any device (the reference
    computation of phase 18 (a), in fp32)."""

    def __enter__(self):
        from adaprompt_tpu_torch.models import unet as unet_mod
        from adaprompt_tpu_torch.ops import attention, geglu
        self.saved = ((attention, "flash_attention", attention.flash_attention),
                      (unet_mod, "geglu", unet_mod.geglu))
        attention.flash_attention = lambda q, k, v, key_bias, scale, variant=None: \
            attention.attention_reference(q, k, v, key_bias, scale)[0]
        unet_mod.geglu = geglu.geglu_reference
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)


def _recon_batch(gen, b):
    """Scaled latents, a [1, B, 77, 768] context, a box fg mask and an aug
    mask that pads ~29 % of the width, at 64x64 latents."""
    import torch
    z0 = torch.randn(b, 64, 64, 4, device="cuda", generator=gen)
    ctx = torch.randn(1, b, 77, 768, device="cuda", generator=gen)
    fg = torch.zeros(b, 64, 64, 1, device="cuda")
    fg[:, 16:48, 20:44] = 1.0
    aug = torch.ones(b, 64, 64, 1, device="cuda")
    aug[:, :, :19] = 0.0
    return {"z0": z0, "context": ctx, "fg_mask": fg, "aug_mask": aug}


def phase_unet_recon(card):
    """Phase 18 (a) and (b): make_recon_step over a seeded full-width SD-1.5
    UNet in fp32 on the card, bf16 activations. (a) the UNet's own weights
    under AdamW (clip 0.5, the trainer's schedule), RECON_UNET_STEPS steps
    at batch 4: before step 1, the same loss and gradient on the same draws
    with the kernels' plain versions in fp32 (no launch); each step's loss
    and gradient norm finite, every weight moved, exact launches a step;
    (b) one context_fn step: a trainable [1, 1, 77, 768] table makes the
    context of the same UNet, frozen. Returns ({path: launches}, the UNet)."""
    import functools
    import torch
    from adaprompt_tpu_torch.models.unet import UNet
    from adaprompt_tpu_torch.ops.layers import randomize_zero_init, reset_parameters
    from adaprompt_tpu_torch.train import steps as steps_mod
    from adaprompt_tpu_torch.train.trainer import TrainerConfig, build_optimizer
    gen = torch.Generator(device="cuda").manual_seed(18)
    t0 = time.perf_counter()
    unet = randomize_zero_init(reset_parameters(UNet(device="cuda", dtype=torch.float32), gen),
                               gen)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in unet.parameters())
    batch = _recon_batch(gen, RECON_UNET_BATCH)
    opt = functools.partial(build_optimizer, TrainerConfig(optimizer_type="AdamW", grad_accum=1,
                                                           max_steps=1000))
    state = steps_mod.create_train_state({"unet": unet}, opt)
    step = steps_mod.make_recon_step(compute_dtype=torch.bfloat16)
    draws = step.draw(gen, batch["z0"])

    # the reference: plain versions in fp32 on the same weights and draws
    plain = steps_mod.make_recon_step(compute_dtype=torch.float32)
    before = read_counts()
    with _PlainKernels():
        ref_loss, _ = plain.loss(state.params, batch, draws)
        ref_loss.backward()
    ref_gnorm = steps_mod.global_norm([p.grad for p in unet.parameters()]).item()
    ref_loss = ref_loss.item()
    state.optimizer.zero_grad()
    if nz(counts_since(before)):
        raise AssertionError(f"the plain reference launched {nz(counts_since(before))}")

    snapshot = [p.detach().clone() for p in unet.parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    rows, per_step = [], []
    for i in range(RECON_UNET_STEPS):
        before = read_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch, gen, draws=draws if i == 0 else None)
        torch.cuda.synchronize()
        rows.append((time.perf_counter() - t0, m["loss_recon"].item(), m["grad_norm"].item()))
        per_step.append(counts_since(before))
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    moved = sum(not torch.equal(p, q) for p, q in zip(unet.parameters(), snapshot))
    del snapshot
    want = {n: 0 for n in launches}
    want.update(UNET_STEP_LAUNCHES)
    for i, c in enumerate(per_step):
        if c != want:
            raise AssertionError(f"unet_recon step {i} launches {nz(c)}, expected {nz(want)}")
    loss_err = abs(rows[0][1] - ref_loss) / abs(ref_loss)
    gnorm_err = abs(rows[0][2] - ref_gnorm) / ref_gnorm
    log(f"phase 18 (a) unet_recon: make_recon_step, SD-1.5 UNet {n_params / 1e6:.1f} M fp32 "
        f"weights (init {init_s:.1f} s) under AdamW, batch {RECON_UNET_BATCH} at 512x512, bf16 "
        f"activations: step s {[round(r[0], 4) for r in rows]}, loss_recon "
        f"{[round(r[1], 6) for r in rows]}, grad_norm {[round(r[2], 6) for r in rows]}; step 1 "
        f"against the plain versions in fp32 on the same draws (loss {ref_loss:.6f}, grad_norm "
        f"{ref_gnorm:.6f}): relative errors {loss_err:.4e} (bound {RECON_UNET_LOSS_TOL:g}), "
        f"{gnorm_err:.4e} (bound {RECON_UNET_GNORM_TOL:g}); {moved} of "
        f"{len(list(unet.parameters()))} weight tensors moved; peak memory {peak:.2f} GiB; "
        f"launches a step {nz(want)}; {card}")
    if not all(math.isfinite(r[1]) and math.isfinite(r[2]) and r[2] > 0 for r in rows):
        raise AssertionError(f"unet_recon: bad metrics {rows}")
    if not (loss_err <= RECON_UNET_LOSS_TOL and gnorm_err <= RECON_UNET_GNORM_TOL):
        raise AssertionError(f"unet_recon step 1 disagrees with the plain versions: loss "
                             f"{loss_err}, grad_norm {gnorm_err}")
    if moved != len(list(unet.parameters())):
        raise AssertionError(f"unet_recon: only {moved} weight tensors moved")
    by_path = {"unet_recon": launches}
    del state
    unet.requires_grad_(False)
    torch.cuda.empty_cache()

    # (b) context_fn: a trainable table makes the context of the frozen UNet
    table = torch.nn.Parameter(0.5 * torch.randn(1, 1, 77, 768, device="cuda", generator=gen))
    table0 = table.detach().clone()
    sums = [p.double().sum().item() for p in unet.parameters()]
    state = steps_mod.create_train_state({"ctx": table}, opt)
    ctx_step = steps_mod.make_recon_step(
        compute_dtype=torch.bfloat16,
        context_fn=lambda p, b: p["ctx"].expand(-1, b["z0"].shape[0], -1, -1))
    ctx_batch = {k: v for k, v in batch.items() if k != "context"}
    zero_counts()
    t0 = time.perf_counter()
    state, m = ctx_step(state, dict(ctx_batch, unet=unet), gen)
    torch.cuda.synchronize()
    ctx_s = time.perf_counter() - t0
    launches = read_counts()
    want = {n: 0 for n in launches}
    want.update(CTX_STEP_LAUNCHES)
    if launches != want:
        raise AssertionError(f"unet_recon_ctx launches {nz(launches)}, expected {nz(want)}")
    loss, gnorm = m["loss_recon"].item(), m["grad_norm"].item()
    if not (math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0
            and not torch.equal(table.detach(), table0)
            and sums == [p.double().sum().item() for p in unet.parameters()]):
        raise AssertionError(f"unet_recon_ctx: loss {loss}, grad_norm {gnorm}, the table or "
                             "the frozen UNet")
    log(f"phase 18 (b) unet_recon_ctx: one context_fn step (a trainable 77x768 table, the UNet "
        f"frozen): {ctx_s:.4f} s (first call), loss_recon {loss:.6f}, grad_norm {gnorm:.6e}; the "
        f"table moved, the UNet did not; launches {nz(want)}; {card}")
    by_path["unet_recon_ctx"] = launches
    del state, table
    return by_path, unet


def phase_ada(unet, tmp, card):
    """Phase 18 (c): ada_forward over the 16 CA layers at the 512x512 shapes,
    batch 4: a seeded AdaEmbedder (K 9: 4 fg, 4 bg, 1 both; r 12 with 2
    init vectors) written in the reference's layout, read by ada_from_torch
    on the card and on the CPU, the CA layers' to_k (and to_q, which makes
    the queries) from the phase's UNet, seeded features, time embedding,
    probes and a 512x512 fg mask; fp32 card (TF32 off) against the CPU
    within ADA_TOL relative L2 per layer, no kernel launched; times the 16
    layers on the card."""
    import os
    import sys
    import torch
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    import reference_layouts as rl
    from adaprompt_tpu_torch.adaface import ada_embedder as ae
    if unet.l2ca != ae.LAYER_IDX2CA:
        raise AssertionError(f"the UNet's CA layers {unet.l2ca} are not the embedder's")
    cfg = ae.AdaEmbedderConfig(**ADA_CFG)
    gen = torch.Generator().manual_seed(19)
    init = torch.randn(ADA_CFG["num_init_vecs"], 768, generator=gen)
    path = os.path.join(tmp, "ada_embedding.pt")
    torch.save(rl.ada_embedding_reference(ae.ada_init(gen, cfg, init)), path)
    sd = torch.load(path)
    ada = {dev: ae.ada_from_torch(sd, cfg, device=dev) for dev in ("cuda", "cpu")}
    b = RECON_UNET_BATCH
    common = {"time": torch.randn(b, 1280, generator=gen), "probe": torch.randn(768, generator=gen),
              "extra": torch.randn(b, 768, generator=gen)}
    mask = torch.zeros(b, 1, 512, 512)
    mask[:, :, 128:384, 160:352] = 1.0
    layers = {}
    for layer_idx, ca in ae.LAYER_IDX2CA.items():
        c = cfg.ca_infeat_dims[ca]
        hw = 8 if ca == 6 else {320: 64, 640: 32, 1280: 16}[c]
        attn2 = unet._block(layer_idx)["attn2"]
        x = torch.randn(b, hw * hw, c, generator=gen)
        layers[layer_idx] = {"x": x, "q": x @ attn2["to_q"].weight.detach().cpu().t(),
                             "to_k_w": attn2["to_k"].weight.detach().cpu(), "infeat_size": (hw, hw)}
    on = {dev: ({li: {k: (v.to(dev) if isinstance(v, torch.Tensor) else v) for k, v in la.items()}
                 for li, la in layers.items()},
                {k: v.to(dev) for k, v in common.items()}, mask.to(dev))
          for dev in ("cuda", "cpu")}

    def run(dev):
        la, com, m = on[dev]
        return {li: ada[dev](li, la[li], com["time"], com["probe"], com["extra"], m) for li in la}

    zero_counts()
    with torch.no_grad():
        card_out = run("cuda")
        torch.cuda.synchronize()
        launches = nz(read_counts())
        t0 = time.perf_counter()
        cpu_out = run("cpu")
        cpu_s = time.perf_counter() - t0
        ms = time_ms(lambda: run("cuda"), 5)
    errs = {}
    for li, (out, pooled) in cpu_out.items():
        got, got_pooled = card_out[li]
        errs[li] = max(((got.cpu() - out).norm() / out.norm()).item(),
                       ((got_pooled["bg_out"].cpu() - pooled["bg_out"]).norm()
                        / pooled["bg_out"].norm()).item())
        if tuple(got.shape) != (b, cfg.num_vectors, 768) or not torch.isfinite(got).all():
            raise AssertionError(f"ada layer {li}: {tuple(got.shape)}")
    log(f"phase 18 (c) ada_forward: 16 CA layers, batch {b}, K {cfg.num_vectors} x r {cfg.rank} "
        f"at 512x512 shapes (features 64x64x320 .. 8x8x1280, a 512x512 mask), the UNet's "
        f"to_k, from the reference layout ({os.path.getsize(path) / 2 ** 20:.1f} MiB); fp32 "
        f"card vs CPU relative L2 max {max(errs.values()):.3e} (bound {ADA_TOL:g}); card "
        f"{ms:.3f} ms for the 16 layers, CPU {1e3 * cpu_s:.1f} ms; launches {launches}; {card}")
    if launches or not max(errs.values()) <= ADA_TOL:
        raise AssertionError(f"ada_forward: errors {errs}, launches {launches}")


def phase_cls_delta(card):
    """Phase 18 (d): merge_cls_token_embeddings (two deltas in one row, M 2
    and 3) and distribute_embedding_to_M_tokens (M 16, each divisor) on the
    card, bit-equal to the CPU."""
    import torch
    from adaprompt_tpu_torch.adaface import cls_delta
    gen = torch.Generator().manual_seed(20)
    emb = torch.randn(8, 77, 768, generator=gen)
    indices = [(4, 5, 2, "a"), (4, 12, 3, "b"), (6, 7, 3, "b")]
    weights = {"a": [0.25, 0.75], "b": [0.2, 0.3, 0.5]}
    zero_counts()
    pairs = [(cls_delta.merge_cls_token_embeddings(emb.cuda(), indices, weights),
              cls_delta.merge_cls_token_embeddings(emb, indices, weights))]
    pos = list(range(5, 21))
    for scheme in ("sqrt_M", "M", "none"):
        pairs.append((cls_delta.distribute_embedding_to_M_tokens(emb.cuda(), pos, scheme),
                      cls_delta.distribute_embedding_to_M_tokens(emb, pos, scheme)))
    launches = nz(read_counts())
    equal = [torch.equal(a.cpu(), b) for a, b in pairs]
    log(f"phase 18 (d) cls_delta: merge (3 deltas, 2 in one row) and distribute (M 16, 3 "
        f"divisors) on [8, 77, 768] fp32, card bit-equal to the CPU: {equal}; launches "
        f"{launches}; {card}")
    if not all(equal) or launches or torch.equal(pairs[0][1], emb):
        raise AssertionError(f"cls_delta on the card: {equal}, launches {launches}")


def _overlay_sources(tmp):
    """OVERLAY_BACKGROUNDS as a folder (PNG through the port's writer, JPEG
    through PIL) with .txt captions, and a .tar of the folder."""
    import os
    import tarfile
    import numpy as np
    from PIL import Image
    from adaprompt_tpu_torch.utils.png import write_png
    rng = np.random.default_rng(18)
    folder = os.path.join(tmp, "backgrounds")
    os.makedirs(folder)
    for name, (h, w), cap in OVERLAY_BACKGROUNDS:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        if name.endswith(".png"):
            write_png(os.path.join(folder, name), img)
        else:
            Image.fromarray(img).save(os.path.join(folder, name), quality=90)
        with open(os.path.join(folder, os.path.splitext(name)[0] + ".txt"), "w") as f:
            f.write(cap)
    tar = os.path.join(tmp, "backgrounds.tar")
    with tarfile.open(tar, "w") as tf:
        for f in sorted(os.listdir(folder)):
            tf.add(os.path.join(folder, f), arcname=f)
    return folder, tar


def _check_composites(path, composites, folder):
    """Each composite against a numpy recompute: the background against
    PIL's decode, BICUBIC resize and centre crop of its source, the pasted
    image and the captions. Returns how many were checked."""
    import os
    import numpy as np
    from PIL import Image
    srcs = {cap: name for name, _, cap in OVERLAY_BACKGROUNDS}
    for ex, bg, cap, cls, out in composites:
        with Image.open(os.path.join(folder, srcs[cap])) as im:
            im = im.convert("RGB")
            w, h = im.size
            scale = 512 / min(w, h)
            im = im.resize((int(round(w * scale)), int(round(h * scale))), Image.BICUBIC)
            left, top = (im.size[0] - 512) // 2, (im.size[1] - 512) // 2
            want_bg = np.asarray(im.crop((left, top, left + 512, top + 512)))
        pasted = np.where(ex["fg_mask"][:, :, None] > 0, ex["image_unnorm"], want_bg)
        extra = ", in front of " + cap.lower()
        ok = (np.array_equal(bg, want_bg)
              and np.array_equal(out["wds_image"], (pasted / 127.5 - 1.0).astype(np.float32))
              and np.array_equal(out["wds_image_bgonly"], (want_bg / 127.5 - 1.0).astype(np.float32))
              and out["wds_caption"] == ex["caption"] + extra
              and out["wds_cls_caption"] == ex["caption"] + " " + cls + extra
              and out["wds_caption_bg"] == ex["caption_bg"] + extra
              and np.array_equal(out["wds_aug_mask"], ex["aug_mask"]) and out["has_wds_comp"])
        if not ok:
            raise AssertionError(f"{path}: the composite over {srcs[cap]} differs from the recompute")
    return len(composites)


def phase_overlay_cli(tmp, root, card):
    """Phase 18 (e): train.main with --overlay_source over a folder of 2 PNG
    and 2 JPEG backgrounds and over a .tar of them, --overlay_prob 0.5,
    OVERLAY_STEPS recon steps at bs 4 on phase 14's subjects (random face
    ids, the student's own UNet as teacher): every composite checked by
    _check_composites, the trained batches' flags counted, launches as the
    rows imply. Returns {path: launches}."""
    import os
    from adaprompt_tpu_torch.data import dataset as tds
    folder, tar = _overlay_sources(tmp)
    by_path = {}
    for path, source in (("cli_train_overlay_dir", folder), ("cli_train_overlay_tar", tar)):
        composites, flags = [], []
        orig_composite, orig_collate = tds.composite_wds_example, tds._collate

        def composite(ex, bg, cap, cls):
            out = orig_composite(ex, bg, cap, cls)
            composites.append((ex, bg, cap, cls, out))
            return out

        def collate(examples, subj_idx):
            batch = orig_collate(examples, subj_idx)
            flags.append(batch["has_wds_comp"])
            return batch
        tds.composite_wds_example, tds._collate = composite, collate
        try:
            rows, _, seconds, launches = _run_train_cli(path, [
                "--data_roots", root, "--synthetic_faces", "--stage", "1", "--bs", "4",
                "--num_steps", str(OVERLAY_STEPS), "--arc2face_distill_iter_prob", "0",
                "--num_workers", "0", "--seed", "18", "--overlay_source", source,
                "--overlay_prob", "0.5", "--out_dir", os.path.join(tmp, path)], card)
        finally:
            tds.composite_wds_example, tds._collate = orig_composite, orig_collate
        _check_train_rows(path, rows, range(OVERLAY_STEPS))
        _check_train_launches(path, launches, _train_cli_want(rows))
        n = _check_composites(path, composites, folder)
        n_flags = sum(sum(f) for f in flags[:OVERLAY_STEPS])
        log(f"phase 18 (e) {path}: {seconds:.3f} s for {OVERLAY_STEPS} recon steps; composited "
            f"examples per trained batch {[sum(f) for f in flags[:OVERLAY_STEPS]]} of 4, "
            f"{n} composites bit-equal to the recompute (PIL's decode, BICUBIC and crop of the "
            f"source; the paste and captions in numpy); {card}")
        if n_flags == 0 or n < n_flags:
            raise AssertionError(f"{path}: {n_flags} composited examples trained, {n} checked")
        by_path[path] = launches
    return by_path


def phase_personalization(tmp, root):
    """Phase 18, after phase 17 in its temporary directory: (a)-(e)."""
    import torch
    card = card_line()
    t_phase = time.perf_counter()
    by_path, unet = phase_unet_recon(card)
    phase_ada(unet, tmp, card)
    del unet
    torch.cuda.empty_cache()
    phase_cls_delta(card)
    by_path.update(phase_overlay_cli(tmp, root, card))
    log(f"phase 18: {time.perf_counter() - t_phase:.1f} s; {card}")
    return by_path


def phase_clis_and_train_cli():
    """Phases 13 to 18 in one temporary directory, removed at the end."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        launches, files = phase_clis(tmp)
        train_launches, root = phase_train_cli(tmp, files)
        launches.update(train_launches)
        launches.update(phase_eval(tmp, files, root))
        launches.update(phase_detect(tmp, files, root))
        launches.update(phase_img2img(tmp, files))
        launches.update(phase_personalization(tmp, root))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


_GEN_TURNS = ("generate_default", "generate_ilv", "generate_nomax", "generate_exp2")
_TRAIN_TURNS = ("train_default", "train_exp2")
_RECON = ("recon", "recon_conv", "recon_bg")       # phase 10
_COMPOS = ("compos_filter", "compos")               # phase 11
_STATE = ("resume", "adamw_ema", "static_recon")    # phase 12's training paths
_CLIS = ("cli_txt2img", "cli_infer")                 # phase 13
_TRAIN_CLI = ("cli_train_s1", "cli_train_resume", "cli_train_s2", "cli_train_static")  # 14
_EVAL_CLIS = ("cli_gen_eval", "cli_txt2img_compare")                                  # 15
_DETECT = ("cli_infer_retinaface", "cli_train_detector")                                # 16
_IMG2IMG = ("cli_translate", "cli_arc2face_gen_ldm", "cli_arc2face_gen_diffusers",
            "cli_demo")                                                                  # 17
_PERSONAL = ("unet_recon", "unet_recon_ctx", "cli_train_overlay_dir",
             "cli_train_overlay_tar")                                                   # 18
KERNELS = {   # wrapper -> (source, TPU kernel it replaces, the paths that launch it)
    "flash_attention_fwd": ("adaprompt_tpu_torch/csrc/flash_attention.cu",
                            "adaprompt_tpu/ops/attention.py:176",
                            ("generate", "train", "serve_int8", "serve_bf16", "personalize",
                             "personalize_unfused", "generate_default", "generate_exp2")
                            + _TRAIN_TURNS + _RECON + _COMPOS + _STATE + ("log_samples",)
                            + _CLIS + _TRAIN_CLI + _EVAL_CLIS + _DETECT + _IMG2IMG + _PERSONAL),
    "flash_attention_bwd": ("adaprompt_tpu_torch/csrc/flash_attention_bwd.cu",
                            "adaprompt_tpu/ops/attention.py:314",
                            ("train",) + _TRAIN_TURNS + _RECON + ("compos",) + _STATE
                            + _TRAIN_CLI + ("cli_train_detector",) + _PERSONAL),
    "fused_cross_attention": ("adaprompt_tpu_torch/csrc/fused_cross_attention.cu",
                              "adaprompt_tpu/ops/attention.py:610",
                              ("generate", "serve_bf16", "personalize", "personalize_unfused")
                              + _GEN_TURNS + ("log_samples",) + _CLIS
                              + ("cli_train_s1", "cli_train_resume") + _EVAL_CLIS
                              + ("cli_infer_retinaface",) + _IMG2IMG),
    "geglu_fwd": ("adaprompt_tpu_torch/csrc/geglu.cu", "adaprompt_tpu/ops/geglu.py:55",
                  ("generate", "train", "serve_bf16", "personalize", "personalize_unfused")
                  + _GEN_TURNS + _TRAIN_TURNS + _RECON + _COMPOS + _STATE + ("log_samples",)
                  + _CLIS + _TRAIN_CLI + _EVAL_CLIS + _DETECT + _IMG2IMG + _PERSONAL),
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
        for extra in ("unfused_ms", "bf16_ms", "stats_ms", "halo_ms", "prepass_ms", "b1_ms",
                      "kv_ms", "kernel_only_ms", "wrapper_ms"):
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
    phase_vision_check()
    launches = phase_generate()
    launches.update(phase_train())
    launches.update(phase_serve())
    launches.update(phase_personalize())
    launches.update(phase_clis_and_train_cli())
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps(kernels_line(results, launches)))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
