"""Builder of configuration sd15_adaface: AdaFace's product path on SD-1.5.

The benchmark makes every weight from the seed (`harness/weights.py`, the
names and inits that `benchmark/reference/` lists) and hands the same values
to both sides: to the program through its modules' `load_state_dict` (the
UNet and the VAE in bfloat16, the towers in float32, as the `infer` CLI
holds them), and to the reference, which makes them again after the
program is gone.

The program is `adaprompt_tpu_torch.adaface.wrapper.AdaFacePipeline` over a
`StableDiffusionPipeline`, as `cli/infer.py` builds it, with the centre-crop
face embedder and the character-level tokenizer. A request is
`generate_adaface_embeddings(images_np=photos)` then `__call__(prompt, ...)`.
For the requests that the check samples, hooks keep what the timed path
produced: the subject vectors it returned, every UNet call's input latents,
timesteps and eps, the context of its first call, the latents that enter the
VAE decoder, and the images.

`check()` runs after the window, with the program freed, and compares (each
reading beside its limit, from the workload file):
  * x_T: the first UNet input against the reference's draw from the
    request's noise seed (exact);
  * subj_rel: the 16 subject vectors (ArcFace, Arc2Face, SubjBasisGenerator);
  * ctx_rel: the context of the UNet (CLIP cond and uncond over the extended
    token table);
  * eps_rel: the UNet's eps at sampled steps, from the program's own latents
    and the reference's own context (teacher forcing);
  * z_rel: the latents entering the decoder against the reference's own
    DDIM-50 chain from x_T (guidance, the DDIM update, every step), for the
    first `free_running` of the sampled requests;
  * img_mad: the images against the reference's decode of the program's
    decoder input, in mean absolute levels;
  * off_config: how many of the UNet's paths the program reports otherwise
    than the configuration states them (`quant`: none, the bfloat16 the
    configuration serves in; `fused_conv`: as `unet_options` has it), read
    from the pipeline once the window has closed. The int8 path reads
    inside every numeric limit (its error is the bfloat16 program's), so
    this reading is what holds the cell to its precision.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import core, flops, traffic, weights
from benchmark.reference import adaface as ref_adaface
from benchmark.reference import clip as ref_clip
from benchmark.reference import ddim as ref_ddim
from benchmark.reference import nn as ref_nn
from benchmark.reference import unet as ref_unet
from benchmark.reference import vae as ref_vae
from benchmark.reference import arcface as ref_arcface
from benchmark.reference.tokenizer import Tokenizer

MODELS = ("unet", "vae", "text", "arc2face", "sbg", "arcface")
DEFAULT_NEGATIVE_PROMPT = (
    "flaws in the eyes, flaws in the face, lowres, non-HDRi, low quality, "
    "worst quality, artifacts, noise, text, watermark, glitch, mutated, ugly, "
    "disfigured, hands, partially rendered objects, partially rendered eyes, "
    "deformed eyeballs, cross-eyed, blurry, mutation, duplicate, out of frame, "
    "cropped, mutilated, bad anatomy, deformed, bad proportions, nude, naked, "
    "nsfw, topless, bare breasts")


def param_shapes(cfg: dict) -> dict:
    text = cfg["text"]
    sbg = ref_adaface.sbg_param_shapes(text, cfg["prompt2token_proj_kv_mult"])
    return {"unet": ref_unet.param_shapes(cfg["unet"]), "vae": ref_vae.param_shapes(cfg["vae"]),
            "text": ref_clip.param_shapes(text), "arc2face": ref_clip.param_shapes(text),
            "sbg": sbg, "arcface": ref_arcface.param_shapes(cfg["arcface"])}


def make_weights(cfg: dict, seed: int, device, as_float32: bool = False) -> dict:
    """{model: {name: tensor}} in each model's served dtype (or all upcast to
    float32 for the reference, the same values)."""
    shapes = param_shapes(cfg)
    out = {}
    for i, m in enumerate(MODELS):
        w = weights.make(shapes[m], weights.seed_for(seed, 7, i), device, weights.DTYPES[cfg["dtype"][m]])
        out[m] = {k: v.float() for k, v in w.items()} if as_float32 else w
    return out


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def build_program(cfg: dict, w: dict, device, quant=None):
    """The port's AdaFacePipeline holding the weights `w` (copied in)."""
    from adaprompt_tpu_torch.adaface import subj_basis_generator as sbg_mod
    from adaprompt_tpu_torch.adaface.wrapper import AdaFacePipeline
    from adaprompt_tpu_torch.eval.face_eval import FaceSimilarityEvaluator, center_crop_detector
    from adaprompt_tpu_torch.models.arcface import ArcFace, IResNetConfig
    from adaprompt_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from adaprompt_tpu_torch.models.unet import UNet, UNetConfig
    from adaprompt_tpu_torch.models.vae import VAE, VAEConfig
    from adaprompt_tpu_torch.pipeline import StableDiffusionPipeline
    from adaprompt_tpu_torch.utils.tokenizer import CLIPTokenizer

    dt = lambda m: weights.DTYPES[cfg["dtype"][m]]

    def load(module, state):
        module.load_state_dict(state, strict=True)
        return module

    ucfg = UNetConfig(**_tuples(cfg["unet"]), **cfg["unet_options"])
    unet = load(UNet(ucfg, device=device, dtype=dt("unet")), w["unet"])
    vae = load(VAE(VAEConfig(**_tuples(cfg["vae"])), device=device, dtype=dt("vae")), w["vae"])
    tcfg = CLIPTextConfig(**cfg["text"])
    text = load(CLIPTextModel(tcfg, device=device, dtype=dt("text")), w["text"])
    a2f = load(CLIPTextModel(tcfg, device=device, dtype=dt("arc2face")), w["arc2face"])
    scfg = sbg_mod.SubjBasisConfig(output_dim=tcfg.hidden_size, text_cfg=tcfg)
    sbg = sbg_mod.from_state(w["sbg"], scfg, device=device, dtype=dt("sbg"))
    acfg = IResNetConfig(**_tuples(cfg["arcface"]))
    face = load(ArcFace(acfg, device=device, dtype=dt("arcface")), w["arcface"]).eval()
    size = acfg.input_size
    embedder = FaceSimilarityEvaluator(face, detector=lambda im: center_crop_detector(im, size))
    sd = StableDiffusionPipeline(unet, vae, text, CLIPTokenizer.fallback(), quant=quant)
    return AdaFacePipeline(sd, sbg, scfg, a2f, tcfg, face_embedder=embedder,
                           subject_string=cfg["subject_string"], num_vectors=cfg["num_vectors"])


class Cell:
    """One run of a cell of this configuration: set-up, the window's
    requests, the check."""


    def __init__(self, cfg: dict, mix: dict, wl: dict, seed: int, device, control: str | None = None):
        self.cfg, self.mix, self.wl, self.seed, self.device = cfg, mix, wl, seed, device
        self.control = control            # None, "int8" (the program's int8 path) or "lower"
        self.items = {}
        self.captures = {}
        self._active = None
        self._flops = {}
        chk = wl["check"]
        rng = np.random.default_rng(weights.seed_for(seed, 202))
        self.check_indices = sorted(rng.choice(chk["among_first"], chk["requests"], replace=False).tolist())
        self.spans = None

    @property
    def check_items(self) -> int:
        """The window's items that the check needs."""
        return max(self.check_indices) + 1

    # -- set-up ---------------------------------------------------------------

    def setup(self, spans, stream):
        """Weights, the program, and one warm-up request at the cell's shapes
        with `warmup_steps` sampler steps (from a stream of its own: the
        window's `stream` starts at its first request)."""
        self.spans = spans
        t0 = core.synced_clock(self.device)
        w = make_weights(self.cfg, self.seed, self.device)
        t1 = core.synced_clock(self.device)
        if self.control == "lower":
            self.pipe = _LowerPrecisionProgram(self.cfg, {m: {k: v.float() for k, v in d.items()} for m, d in w.items()},
                                               self.device, self)
        else:
            self.pipe = build_program(self.cfg, w, self.device, quant="int8" if self.control == "int8" else None)
            self.pipe.pipe.unet.register_forward_hook(self._unet_hook)
            self.pipe.pipe.vae.post_quant_conv.register_forward_pre_hook(self._vae_hook)
            encode = self.pipe.encode_prompt

            def encode_prompt(*a, **kw):
                out = encode(*a, **kw)
                self.spans.switch("generate")
                return out
            self.pipe.encode_prompt = encode_prompt
        del w
        t2 = core.synced_clock(self.device)
        warm = dict(next(traffic.items(self.mix, weights.seed_for(self.seed, 303))),
                    index=-1, num_steps=self.wl["warmup_steps"])
        self.run(self.prepare(warm))
        self.setup_parts = {"weights_s": t1 - t0, "build_s": t2 - t1, "warmup_s": core.synced_clock(self.device) - t2}

    def _unet_hook(self, module, args, out):
        cap = self._active
        if cap is not None:
            cap["x"].append(args[0])
            cap["t"].append(args[1])
            cap["eps"].append(out)
            cap.setdefault("ctx", args[2])

    def _vae_hook(self, module, args):
        if self._active is not None:
            self._active["z"] = args[0]

    # -- the window ---------------------------------------------------------

    def prepare(self, item: dict) -> dict:
        """Host inputs of a request, made before its clock starts."""
        self.items[item["index"]] = item
        return {"item": item, "photos": traffic.photos(item)}

    def run(self, req: dict) -> int:
        """One request, photos in, uint8 images out; returns the image count."""
        item = req["item"]
        cap = None
        if item["index"] in self.check_indices and self.items.get(item["index"]) is item:
            cap = self.captures[item["index"]] = {"x": [], "t": [], "eps": []}
        self._active = cap
        self.spans.enter("personalize")
        subj = self.pipe.generate_adaface_embeddings(images_np=req["photos"])
        if subj is None:
            raise RuntimeError("no face found in a request's photos")
        images = self.pipe(item["prompt"], out_image_count=item["out_image_count"],
                           num_steps=item["num_steps"], guidance_scale=item["guidance_scale"],
                           seed=item["noise_seed"], height=item["height"], width=item["width"],
                           sampler=item["sampler"])
        self.spans.leave()
        self._active = None
        if cap is not None:
            cap["subj"], cap["images"] = subj, images
        return int(images.shape[0])

    # -- work counts ------------------------------------------------------------

    def item_flops(self, index: int) -> int:
        """Operations of request `index` (2 per multiply-add), from the reference on
        the meta device: the personalization chain, both contexts, num_steps
        UNet passes at the (cond, uncond) batch, the decode."""
        item = self.items[index]
        key = (item["prompt"], item["photos"], item["out_image_count"], item["num_steps"], item["height"],
               item["width"])
        if key not in self._flops:
            self._flops[key] = self._item_flops(item)
        return self._flops[key]

    def _item_flops(self, item: dict) -> int:
        cfg, meta = self.cfg, torch.device("meta")
        shapes = param_shapes(cfg)
        w = {m: {k: torch.empty(s, device=meta) for k, s, _ in shapes[m]} for m in MODELS}
        tok = Tokenizer(cfg["subject_string"], cfg["num_vectors"])
        n, h, wd = item["out_image_count"], item["height"] // 8, item["width"] // 8
        size = cfg["arcface"]["input_size"]

        def personalize():
            x = torch.empty(item["photos"], size, size, 3, device=meta)
            face = ref_arcface.forward(w["arcface"], cfg["arcface"], x)[:1]
            subj = ref_adaface.subject_vectors(w["arc2face"], w["sbg"], cfg["text"], tok, face)
            ref_adaface.contexts(w["text"], cfg["text"], tok, subj, item["prompt"], DEFAULT_NEGATIVE_PROMPT)

        unet = flops.count_flops(ref_unet.forward, w["unet"], cfg["unet"], torch.empty(2 * n, h, wd, 4, device=meta),
                                 torch.empty(2 * n, device=meta), torch.empty(2 * n, 77, cfg["unet"]["context_dim"], device=meta))
        vae = flops.count_flops(ref_vae.decode, w["vae"], cfg["vae"], torch.empty(n, h, wd, 4, device=meta))
        return flops.count_flops(personalize) + item["num_steps"] * unet + vae

    def item_kernel_work(self, index: int) -> dict:
        """{kernel function: [(ops, bytes, launches)]} of request `index`: each
        self-attention layer of at least 512 tokens (those the port's flash
        forward serves) at the (cond, uncond) batch, once a sampler step."""
        item = self.items[index]
        c = self.cfg["unet"]
        b, side = 2 * item["out_image_count"], item["height"] // 8
        work = []
        for ds, ch in ref_unet.self_attention_layers(c):
            s = (side // ds) ** 2
            if s >= 512:
                work.append(flops.attention(b, c["num_heads"], s, s, ch // c["num_heads"]) + (item["num_steps"],))
        return {"attn_fwd": work}

    # -- the check -----------------------------------------------------------

    def check(self) -> dict:
        """{reading: value} over the sampled requests (the worst of them);
        a sampled request that did not finish reads inf."""
        cfg, dev = self.cfg, self.device
        off = off_config(cfg, getattr(getattr(self.pipe, "pipe", None), "unet_cfg", None))
        self.pipe = None
        flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            return dict(self._check(cfg, dev), off_config=off)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags

    def _check(self, cfg, dev) -> dict:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        w = make_weights(cfg, self.seed, dev, as_float32=True)
        tok = Tokenizer(cfg["subject_string"], cfg["num_vectors"])
        read = {k: 0.0 for k in ("x_T", "subj_rel", "ctx_rel", "eps_rel", "z_rel", "img_mad")}
        for j, idx in enumerate(self.check_indices):
            cap = self.captures.get(idx)
            if cap is None or "images" not in cap:
                return {k: float("inf") for k in read}
            with torch.inference_mode():
                got = _check_request(cfg, w, tok, self.items[idx], cap, dev, self.wl["check"], self.seed,
                                     free_running=j < self.wl["check"]["free_running"])
            read = {k: max(read[k], got[k]) for k in read}
        return read



def off_config(cfg: dict, unet_cfg) -> float:
    """The UNet paths that the program's `unet_cfg` reports otherwise than
    the configuration states (0 for the reference in the program's place,
    which has none)."""
    if unet_cfg is None:
        return 0.0
    return float((getattr(unet_cfg, "quant", None) is not None)
                 + (bool(getattr(unet_cfg, "fused_conv", False)) != bool(cfg["unet_options"]["fused_conv"])))


def _check_request(cfg, w, tok, item, cap, dev, chk, seed, free_running: bool) -> dict:
    n, num_steps = item["out_image_count"], item["num_steps"]
    photos = traffic.photos(item)
    face = ref_adaface.faceid(w["arcface"], cfg["arcface"], photos, dev)
    subj = ref_adaface.subject_vectors(w["arc2face"], w["sbg"], cfg["text"], tok, face)
    cond, uncond = ref_adaface.contexts(w["text"], cfg["text"], tok, subj, item["prompt"], DEFAULT_NEGATIVE_PROMPT)
    ctx = torch.cat([cond.expand(n, -1, -1), uncond.expand(n, -1, -1)])
    coef = ref_ddim.coefficients(num_steps, item["guidance_scale"])
    gen = torch.Generator(device=dev).manual_seed(item["noise_seed"])
    x_T = torch.randn((n, item["height"] // 8, item["width"] // 8, 4), generator=gen, device=dev)
    got = {"subj_rel": ref_nn.rel_l2(cap["subj"].float(), subj),
           "ctx_rel": ref_nn.rel_l2(cap["ctx"].reshape(ctx.shape).float(), ctx),
           "x_T": float((cap["x"][0][:n].float() - x_T.to(cap["x"][0].dtype).float()).abs().max())}
    if len(cap["x"]) != num_steps:
        got["eps_rel"] = float("inf")
    else:
        rng = np.random.default_rng(weights.seed_for(seed, 404, item["index"]))
        inner = max(0, min(chk["teacher_forced_steps"], num_steps) - 2)
        steps = {0, num_steps - 1} | set((1 + rng.choice(max(num_steps - 2, 0), inner, replace=False)).tolist())
        worst = 0.0
        for i in sorted(steps):
            x = cap["x"][i].float()
            t = torch.full((2 * n,), int(coef[0][i]), device=dev)
            worst = max(worst, ref_nn.rel_l2(cap["eps"][i].float(), ref_unet.forward(w["unet"], cfg["unet"], x, t, ctx)))
        got["eps_rel"] = worst
    z = cap["z"].float()
    got["z_rel"] = 0.0
    if free_running:
        x = x_T
        for i in range(num_steps):
            t = torch.full((2 * n,), int(coef[0][i]), device=dev)
            x = ref_ddim.step(x, ref_unet.forward(w["unet"], cfg["unet"], torch.cat([x, x]), t, ctx), i, coef)
        got["z_rel"] = ref_nn.rel_l2(z, x / ref_vae.SD_SCALE_FACTOR)
    img = ref_vae.to_uint8(ref_vae.decode(w["vae"], cfg["vae"], z)).cpu().numpy()
    got["img_mad"] = float(np.abs(img.astype(np.int32) - np.asarray(cap["images"]).astype(np.int32)).mean())
    return got


class _LowerPrecisionProgram:
    """The correctness control in the program's place: the reference one
    precision below the configuration's (the float32 towers and CLIP in
    bfloat16, the bfloat16 UNet and VAE with float8 e4m3 matmul operands),
    run as the program runs a request, its outputs captured as the hooks
    capture the program's."""

    def __init__(self, cfg, w32, dev, cell):
        self.cfg, self.dev, self.cell = cfg, dev, cell
        self.w = w32
        self.wb = {m: {k: v.to(torch.bfloat16) for k, v in w32[m].items()} for m in ("text", "arc2face", "sbg", "arcface")}
        self.tok = Tokenizer(cfg["subject_string"], cfg["num_vectors"])

    @torch.inference_mode()
    def generate_adaface_embeddings(self, images_np):
        face = ref_adaface.faceid(self.wb["arcface"], self.cfg["arcface"], images_np, self.dev, torch.bfloat16)
        self.subj = ref_adaface.subject_vectors(self.wb["arc2face"], self.wb["sbg"], self.cfg["text"], self.tok, face)
        return self.subj

    @torch.inference_mode()
    def __call__(self, prompt, *, out_image_count, num_steps, guidance_scale, seed, height, width, sampler):
        cfg, dev, n = self.cfg, self.dev, out_image_count
        cond, uncond = ref_adaface.contexts(self.wb["text"], cfg["text"], self.tok, self.subj, prompt,
                                            DEFAULT_NEGATIVE_PROMPT)
        ctx = torch.cat([cond.expand(n, -1, -1), uncond.expand(n, -1, -1)]).to(torch.bfloat16)
        cap = self.cell._active
        coef = ref_ddim.coefficients(num_steps, guidance_scale)
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn((n, height // 8, width // 8, 4), generator=gen, device=dev)
        with ref_nn.lower_precision("fp8"):
            for i in range(num_steps):
                xin = torch.cat([x, x]).to(torch.bfloat16)
                t = torch.full((2 * n,), int(coef[0][i]), device=dev)
                eps = ref_unet.forward(self.w["unet"], cfg["unet"], xin.float(), t, ctx.float())
                if cap is not None:
                    cap["x"].append(xin)
                    cap["eps"].append(eps.to(torch.bfloat16))
                    cap.setdefault("ctx", ctx[None])
                x = ref_ddim.step(x, eps, i, coef)
            z = (x / ref_vae.SD_SCALE_FACTOR).to(torch.bfloat16)
            if cap is not None:
                cap["z"] = z
            img = ref_vae.decode(self.w["vae"], cfg["vae"], z.float())
        return ref_vae.to_uint8(img).cpu().numpy()
