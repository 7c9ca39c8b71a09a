"""Builder of configuration sd15_adaface_stage1: AdaFace's Stage-1 training.

The benchmark makes every weight from the seed (`harness/weights.py`, the
names and inits that `benchmark/reference/` lists: a student and a separate
teacher SD-1.5 UNet, the VAE, SD's and Arc2Face's CLIP-L text encoders and
the SubjBasisGenerator) and hands the same values to both sides: to the
program through its modules' `load_state_dict` (the UNets and the VAE in
bfloat16, the towers in float32, as the train CLI holds them), and to the
reference, which makes them again after the program is gone.

The program is `adaprompt_tpu_torch.train.trainer.AdaPromptTrainer` with the
configuration's `TrainerConfig`; its batch iterator yields the batch that
`prepare` made before the step's clock started, and its face embedder
returns the batch's seeded face vectors (no ArcFace on noise images). An
item is one `train_step`.

Set-up builds that one trainer and drives it through the cell's first
`warmup_steps` steps of the traffic (ND 1, 3 and 5: every shape the window
runs, and the first optimizer update). The window goes on with the same
trainer and the same stream. `check()` compares two stretches of steps:
  * the set-up's steps, which the reference follows from the seeded
    weights: each step's loss, the norm of each leaf's gradient as the
    optimizer holds it after step 1 (its accumulator), and the norm of each
    leaf's change after the last of them;
  * a pair of the window's steps, k (which starts an accumulation) and
    k + 1 (which updates), k drawn from the seed among the
    `check.pair_among_first` steps that follow the first `trace_items` after
    set-up (which a traced run serves under the profiler, where the copy
    below would show): the same three, from the program's
    state before step k (its leaves and its optimizer's state, copied to
    the host before the step's clock starts), which the reference takes up
    and steps on from; the gradient is step k's, the change that of both.
The reference redraws every random number itself, from the trainer's seed.

`check()` runs after the window, with the program freed, and gives (each
beside its limit from the workload file, the worse of the two stretches):
  * loss_rel: the worst step's |loss - reference| / reference;
  * grad_gap: over the leaves whose reference gradient is at least a
    thousandth of the median leaf's (a key bias's, under softmax, is
    round-off), the worst |norm - reference norm| over the larger of that
    leaf's reference norm and the median leaf's (read, and not compared
    where the workload file gives it no limit);
  * delta_gap: the same of each leaf's change over the stretch;
  * off_config: how many of the UNets' paths the program reports otherwise
    than the configuration states them (`quant` none, `fused_conv` as
    `unet_options` has it).
"""

from __future__ import annotations

import collections
import contextlib
import tempfile

import numpy as np
import torch

from benchmark.harness import core, flops, traffic, weights
from benchmark.reference import adaface as ref_adaface
from benchmark.reference import clip as ref_clip
from benchmark.reference import nn as ref_nn
from benchmark.reference import train as ref_train
from benchmark.reference import unet as ref_unet
from benchmark.reference import vae as ref_vae
from benchmark.reference.tokenizer import Tokenizer

MODELS = ("unet", "teacher", "vae", "text", "arc2face", "sbg")
LATENT = 8              # the VAE's downsampling


def param_shapes(cfg: dict) -> dict:
    text = cfg["text"]
    sbg = ref_adaface.sbg_param_shapes(text, cfg["prompt2token_proj_kv_mult"])
    u = ref_unet.param_shapes(cfg["unet"])
    return {"unet": u, "teacher": u, "vae": ref_vae.param_shapes(cfg["vae"]),
            "text": ref_clip.param_shapes(text), "arc2face": ref_clip.param_shapes(text), "sbg": sbg}


def make_weights(cfg: dict, seed: int, device, as_float32: bool = False) -> dict:
    """{model: {name: tensor}} in each model's served dtype (or all in float32)."""
    shapes = param_shapes(cfg)
    out = {}
    for i, m in enumerate(MODELS):
        dt = torch.float32 if as_float32 else weights.DTYPES[cfg["dtype"][m]]
        out[m] = weights.make(shapes[m], weights.seed_for(seed, 8, i), device, dt)
    return out


def trainer_config(cfg: dict, out_dir: str):
    from adaprompt_tpu_torch.train.trainer import TrainerConfig
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["trainer"].items()}
    return TrainerConfig(**kw, out_dir=out_dir)


class FaceIds:
    """The trainer's face embedder: the batch's seeded face vectors, one an
    image in order."""

    def __init__(self):
        self.pending = collections.deque()

    def embed_image(self, image):
        return self.pending.popleft()[None]


def build_program(cfg: dict, w: dict, device, batches, faces: FaceIds, out_dir: str):
    """The port's AdaPromptTrainer holding the weights `w` (copied in)."""
    from adaprompt_tpu_torch.adaface import subj_basis_generator as sbg_mod
    from adaprompt_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from adaprompt_tpu_torch.models.unet import UNet, UNetConfig
    from adaprompt_tpu_torch.models.vae import VAE, VAEConfig
    from adaprompt_tpu_torch.train import steps as steps_mod
    from adaprompt_tpu_torch.train.trainer import AdaPromptTrainer
    from adaprompt_tpu_torch.utils.tokenizer import CLIPTokenizer

    tup = lambda d: {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
    dt = lambda m: weights.DTYPES[cfg["dtype"][m]]

    def load(module, state):
        module.load_state_dict(state, strict=True)
        return module

    ucfg = UNetConfig(**tup(cfg["unet"]), **cfg["unet_options"])
    unet = load(UNet(ucfg, device=device, dtype=dt("unet")), w["unet"])
    teacher = load(UNet(ucfg, device=device, dtype=dt("teacher")), w["teacher"])
    vae = load(VAE(VAEConfig(**tup(cfg["vae"])), device=device, dtype=dt("vae")), w["vae"])
    tcfg = CLIPTextConfig(**cfg["text"])
    text = load(CLIPTextModel(tcfg, device=device, dtype=dt("text")), w["text"])
    a2f = load(CLIPTextModel(tcfg, device=device, dtype=dt("arc2face")), w["arc2face"])
    scfg = sbg_mod.SubjBasisConfig(placeholder_is_bg=False, output_dim=tcfg.hidden_size, text_cfg=tcfg)
    sbg = sbg_mod.from_state(w["sbg"], scfg, device=device, dtype=dt("sbg"))
    frozen = steps_mod.FrozenSD(unet=unet, text=text, arc2face_text=a2f, teacher_unet=teacher)
    return AdaPromptTrainer(frozen, vae, CLIPTokenizer.fallback(), scfg, sbg, batches,
                            trainer_config(cfg, out_dir), face_embedder=faces)


def student_rows(cfg: dict, nd: int) -> int:
    """The rows a step of ND keeps: ceil(B / ND) for ND > 1."""
    b = cfg["batch_size"]
    return b if nd == 1 else -(-b // nd)


def loss_stages(b: int, nd: int) -> int:
    """The student passes of a step: the last max(7 // B, 1) of its ND stages."""
    return nd - max(0, nd - max(7 // b, 1))


class Cell:
    """One run of a cell of this configuration: set-up, the window's steps,
    the check."""

    def __init__(self, cfg: dict, mix: dict, wl: dict, seed: int, device, control: str | None = None):
        self.cfg, self.mix, self.wl, self.seed, self.device = cfg, mix, wl, seed, device
        self.control = control      # None, "lower" (the reference one precision below) or "half_batch"
        self.items = {}
        self.captured = {}
        self.pair = {}
        self.nds = []
        self._flops = {}
        self.spans = None
        self._tmp = None
        self._out = None
        first, every = wl["warmup_steps"] + wl["trace_items"], cfg["trainer"]["grad_accum"]
        starts = [j for j in range(first, first + wl["check"]["pair_among_first"] - 1) if j % every == 0]
        self.pair_start = int(np.random.default_rng(weights.seed_for(seed, 202)).choice(starts))

    @property
    def check_items(self) -> int:
        """The items after set-up that the check needs."""
        return self.pair_start + 2 - self.wl["warmup_steps"]

    # -- set-up ---------------------------------------------------------------

    def setup(self, spans, stream):
        """Weights, the trainer, and its first `warmup_steps` steps from the
        run's stream, captured for the check."""
        self.spans = spans
        self.faces = FaceIds()
        self.pending = collections.deque()
        t0 = core.synced_clock(self.device)
        w = make_weights(self.cfg, self.seed, self.device)
        t1 = core.synced_clock(self.device)
        if self.control is None:
            self._tmp = tempfile.TemporaryDirectory(prefix="bench_stage1_")
            self.trainer = build_program(self.cfg, w, self.device, self._batches(), self.faces, self._tmp.name)
            self._wrap_optimizer(self.trainer.state.optimizer)
        else:
            self.trainer = _ReferenceTrainer(self.cfg, w, self.device, self._batches(), self.faces,
                                             self.control)
        del w
        t2 = core.synced_clock(self.device)
        start = self._leaves()
        init = {k: v.detach().float().clone() for k, v in start.items()}
        losses = []
        for i in range(self.wl["warmup_steps"]):
            out = self._step(self.prepare(next(stream)), i)
            losses.append(float(out["loss_arc2face_distill"]))
            if i == 0:
                self.captured["grad"] = {k: _norm(a) for k, a in self._accumulated().items()}
        self.captured["loss"] = losses
        self.captured["delta"] = {k: _norm(v.detach().float() - init[k]) for k, v in start.items()}
        del init, start
        self.step_idx = self.wl["warmup_steps"]
        self.setup_parts = {"weights_s": t1 - t0, "build_s": t2 - t1, "warmup_s": core.synced_clock(self.device) - t2}

    def _leaves(self) -> dict:
        """{program leaf name: the trainable tensor}."""
        if self.control is not None:
            return self.trainer.leaves()
        from adaprompt_tpu_torch.train import steps as steps_mod
        return dict(steps_mod.named_trainable(self.trainer.state.params))

    def _accumulated(self) -> dict:
        """{program leaf name: the optimizer's accumulated gradient}."""
        if self.control is not None:
            return self.trainer.accumulated()
        names = list(self._leaves())
        return dict(zip(names, self.trainer.state.optimizer.acc))

    def _snapshot(self) -> dict:
        """The trainable leaves and the optimizer's state, on the host:
        {"params", "m", "v", "s", "p0", "acc": {program leaf name: tensor},
        "n": the accumulation's position, "count": Prodigy's updates, "d",
        "d_max", "d_num": its scalars}."""
        host = lambda d: {k: v.detach().to("cpu", torch.float32, copy=True) for k, v in d.items()}
        if self.control is not None:
            return self.trainer.snapshot(host)
        opt = self.trainer.state.optimizer
        inner = opt.inner
        names = list(self._leaves())
        slot = lambda key: host({n: inner.state[p][key] for n, p in zip(names, opt.params)})
        return {"params": host(dict(zip(names, opt.params))), "m": slot("exp_avg"), "v": slot("exp_avg_sq"),
                "s": slot("s"), "p0": slot("p0"), "acc": host(dict(zip(names, opt.acc))), "n": opt.mini_step,
                "count": inner.count, "d": float(inner.d), "d_max": float(inner.d_max),
                "d_num": float(inner.d_numerator)}

    def _batches(self):
        while True:
            yield self.pending.popleft()

    def _wrap_optimizer(self, opt):
        """The benchmark's span around the gradient pipeline's call:
        'optimizer' where it clips and steps Prodigy, 'accumulate' where it
        only folds the gradient in."""
        orig = opt.step

        def step():
            self.spans.switch("optimizer" if opt.mini_step == opt.every_k - 1 else "accumulate")
            moved = orig()
            self.spans.switch("train_step")
            return moved
        opt.step = step

    def _step(self, req, i):
        self.spans.enter("train_step")
        out = self.trainer.train_step(i)
        self.spans.leave()
        return out

    # -- the window ---------------------------------------------------------

    def prepare(self, item: dict) -> dict:
        """The step's host batch, made before its clock starts, queued for
        the trainer's iterator and its face embedder; before the checked
        pair, the program's state."""
        self.items[item["index"]] = item
        raw = traffic.training_batch(item)
        self.pending.append(raw)
        self.faces.pending.extend(raw["faceid"])
        if item["index"] == self.pair_start:
            self.pair["start"] = self._snapshot()
        return {"item": item}

    def run(self, req: dict) -> int:
        self._out = self._step(req, self.step_idx)
        self.step_idx += 1
        return 1

    def after(self, req: dict):
        """Outside the step's clock: the checked pair's losses, step k's
        accumulated gradient and the pair's change."""
        k = req["item"]["index"] - self.pair_start
        if k not in (0, 1) or "start" not in self.pair:
            return
        self.pair.setdefault("loss", []).append(float(self._out["loss_arc2face_distill"]))
        if k == 0:
            self.pair["grad"] = {n: _norm(a) for n, a in self._accumulated().items()}
        else:
            p0 = self.pair["start"]["params"]
            self.pair["delta"] = {n: _norm(v.detach().float().cpu() - p0[n]) for n, v in self._leaves().items()}

    # -- work counts ------------------------------------------------------------

    def _nd(self, index: int) -> int:
        if len(self.nds) <= index:
            self.nds = ref_train.host_draws(self.cfg["trainer"], 2 * index + 16)
        return self.nds[index]

    def item_flops(self, index: int) -> int:
        """Operations of step `index` (2 per multiply-add), from the reference
        on the meta device: the VAE encode of the batch, Arc2Face, the
        teacher's ND passes, the generator and SD's text encoder forward and
        backward, the student's passes forward and backward (input
        gradients only through the frozen models)."""
        nd = self._nd(index)
        if nd not in self._flops:
            self._flops[nd] = flops.count_flops(self._meta_step, nd)
        return self._flops[nd]

    def _meta_step(self, nd):
        cfg, meta = self.cfg, torch.device("meta")
        shapes = param_shapes(cfg)
        w = {m: {k: torch.empty(s, device=meta) for k, s, _ in shapes[m]} for m in MODELS}
        for v in w["sbg"].values():
            v.requires_grad_(True)
        size = self.mix["image_size"]
        lat = (size // LATENT, size // LATENT, 4)
        z0 = ref_train.latents(w["vae"], cfg["vae"], torch.empty(cfg["batch_size"], size, size, 3, device=meta))
        b = student_rows(cfg, nd)
        batch = {"z0": z0[:b], "faceid": torch.empty(b, 512, device=meta),
                 "fg_mask": torch.empty(b, *lat[:2], 1, device=meta),
                 "aug_mask": torch.empty(b, *lat[:2], 1, device=meta)}
        draws = {"t": torch.empty(b, dtype=torch.long, device=meta), "noise": torch.empty(b, *lat, device=meta),
                 "rels": torch.empty(nd - 1, b, device=meta), "next_noises": torch.empty(nd - 1, b, *lat, device=meta)}
        with torch.enable_grad():
            ref_train.distill_step(w, cfg, Tokenizer(cfg["subject_string"], cfg["num_vectors"]),
                                   ref_train.schedule(meta), batch, draws, nd)

    def item_kernel_work(self, index: int) -> dict:
        """{kernel function: [(ops, bytes, launches)]} of step `index`: the
        flash backward of every self-attention layer of at least 512 tokens
        whose input depends on the context (all but the first transformer
        block's), in each of the student's passes."""
        nd = self._nd(index)
        b = student_rows(self.cfg, nd)
        c = self.cfg["unet"]
        side = self.mix["image_size"] // LATENT
        work = []
        for ds, ch in ref_unet.self_attention_layers(c)[1:]:
            s = (side // ds) ** 2
            if s >= 512:
                work.append(flops.attention_bwd(b, c["num_heads"], s, s, ch // c["num_heads"])
                            + (loss_stages(b, nd),))
        return {"attn_bwd": work}

    # -- the check -----------------------------------------------------------

    def check(self) -> dict:
        """{reading: value} of the set-up's steps and the window's pair
        against the reference; a pair that did not run reads inf."""
        off = 0.0
        if self.control is None:
            fp = self.trainer._fp         # the frozen models the trainer steps with
            off = max(off_config(self.cfg, fp[m].cfg) for m in ("unet", "teacher_unet"))
        self.trainer = self._out = None
        if self._tmp is not None:
            self._tmp.cleanup()
        pair = self.pair
        if "delta" not in pair:
            return {"loss_rel": float("inf"), "grad_gap": float("inf"), "delta_gap": float("inf"),
                    "off_config": off}
        flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
            ref = reference_steps(self.cfg, self.seed, self.device,
                                  [self.items[i] for i in range(self.wl["warmup_steps"])])
            first = compare(self.captured, ref)
            del ref
            k = self.pair_start
            ref = reference_steps(self.cfg, self.seed, self.device, [self.items[k], self.items[k + 1]],
                                  start=k, state=pair["start"])
            second = compare(pair, ref)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        return dict({k: max(first[k], second[k]) for k in first}, off_config=off)



def off_config(cfg: dict, unet_cfg) -> float:
    """The UNet paths that the program's `unet_cfg` reports otherwise than
    the configuration states."""
    return float((getattr(unet_cfg, "quant", None) is not None)
                 + (bool(getattr(unet_cfg, "fused_conv", False)) != bool(cfg["unet_options"]["fused_conv"])))


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.norm(t.detach().double().flatten()))


def reference_batch(raw: dict, device) -> dict:
    """A step's batch as the reference takes it from the host batch `raw`:
    the images, the face vectors normalized, the masks at latent size."""
    f = np.asarray(raw["faceid"], np.float32)
    f = f / np.linalg.norm(f, axis=-1, keepdims=True)
    lat = raw["image"].shape[1] // LATENT
    mask = lambda m: ref_unet.resize_mask(torch.as_tensor(np.asarray(m, np.float32), device=device)[..., None],
                                          lat, lat)
    return {"images": torch.as_tensor(raw["image"], device=device), "faceid": torch.as_tensor(f, device=device),
            "fg_mask": mask(raw["fg_mask"]), "aug_mask": mask(raw["aug_mask"])}


def _cut(batch: dict, b: int) -> dict:
    return {k: v[:b] for k, v in batch.items()}


class _Stepper:
    """The reference's training state: the weights, the generator's leaves
    (and the unused global scales), the optimizer and the draws."""

    def __init__(self, cfg, w, device, towers=torch.float32, fp8=False, half_batch=False):
        self.cfg, self.device, self.fp8, self.half = cfg, device, fp8, half_batch
        self.towers = towers
        self.w = {m: {k: v.to(towers if m in ("text", "arc2face", "sbg") else torch.float32) for k, v in d.items()}
                  for m, d in w.items()}
        self.params = dict(self.w["sbg"])
        self.params["emb_scales"] = torch.zeros(2, device=device, dtype=towers)
        for v in self.params.values():
            v.requires_grad_(True)
        self.opt = ref_train.Optimizer(self.params, cfg["trainer"])
        self.gen = torch.Generator(device=device).manual_seed(cfg["trainer"]["seed"])
        self.tok = Tokenizer(cfg["subject_string"], cfg["num_vectors"])
        self.sch = ref_train.schedule(device)
        self.last_grads = None

    def take_up(self, state: dict, steps: int, latent: tuple):
        """Step on from a snapshot (`Cell._snapshot`) taken before step
        `steps`: its leaves and optimizer state, and the device draws of the
        steps before it made again from the trainer's seed."""
        name = lambda k: k if k == "emb_scales" else k.removeprefix("subj_basis.")
        dev = lambda d: {name(k): v.to(self.device) for k, v in d.items()}
        with torch.no_grad():
            for k, v in dev(state["params"]).items():
                self.params[k].copy_(v)
        o = self.opt
        o.m, o.v, o.s, o.p0, o.acc = (dev(state[k]) for k in ("m", "v", "s", "p0", "acc"))
        o.n, o.count, o.d, o.d_max, o.d_num = state["n"], state["count"], state["d"], state["d_max"], state["d_num"]
        for nd in ref_train.host_draws(self.cfg["trainer"], steps):
            ref_train.device_draws(self.gen, student_rows(self.cfg, nd), nd, latent, self.device)

    def snapshot(self, host) -> dict:
        """The state as `Cell._snapshot` gives the program's."""
        pre = lambda d: {("subj_basis." + k if k != "emb_scales" else k): v for k, v in d.items()}
        o = self.opt
        out = {k: host(pre(getattr(o, k))) for k in ("m", "v", "s", "p0", "acc")}
        return dict(out, params=host(pre(self.params)), n=o.n, count=o.count, d=o.d, d_max=o.d_max,
                    d_num=o.d_num)

    def mode(self):
        return ref_nn.lower_precision("fp8") if self.fp8 else contextlib.nullcontext()

    def step(self, i: int, batch: dict) -> float:
        nd = ref_train.host_draws(self.cfg["trainer"], i + 1)[i]
        with self.mode():
            z0 = ref_train.latents(self.w["vae"], self.cfg["vae"], batch["images"])
        b = student_rows(self.cfg, nd)
        rows = dict(_cut(batch, b), z0=z0[:b])
        lat = tuple(z0.shape[1:])
        draws = ref_train.device_draws(self.gen, b, nd, lat, self.device)
        if self.half:                 # the fault: half the rows left out, the mean over the rest
            h = max(b // 2, 1)
            rows = _cut(rows, h)
            draws = {"t": draws["t"][:h], "noise": draws["noise"][:h], "rels": draws["rels"][:, :h],
                     "next_noises": draws["next_noises"][:, :h]}
        with self.mode():
            loss, grads = ref_train.distill_step(self.w, self.cfg, self.tok, self.sch, rows, draws, nd,
                                                 dtype=self.towers)
        grads["emb_scales"] = torch.zeros(2, device=self.device)
        self.last_grads = grads
        self.opt.step(self.params, grads)
        return loss


def reference_steps(cfg: dict, seed: int, device, items: list, start: int = 0, state: dict | None = None) -> dict:
    """The reference's losses, leaf gradients after the first step and leaf
    changes over all of them, for the steps of `items`: from the seeded
    weights (`start` 0), or from the program's `state` before step `start`."""
    w = make_weights(cfg, seed, device, as_float32=True)
    st = _Stepper(cfg, w, device)
    del w
    if state is not None:
        side = items[0]["image_size"] // LATENT
        st.take_up(state, start, (side, side, 4))
    before = {k: v.detach().float().clone() for k, v in st.params.items()}
    out = {"loss": []}
    for i, item in enumerate(items):
        out["loss"].append(st.step(start + i, reference_batch(traffic.training_batch(item), device)))
        if i == 0:
            out["grad"] = {k: _norm(v) for k, v in st.last_grads.items()}
    out["delta"] = {k: _norm(v.detach().float() - before[k]) for k, v in st.params.items()}
    return out


def compare(got: dict, ref: dict) -> dict:
    """The readings of the program's captures `got` against `ref` (each with
    'loss' [steps], 'grad' and 'delta' {reference leaf name: norm}; the
    program's leaves are named 'subj_basis.<name>' and 'emb_scales')."""
    name = lambda k: k if k == "emb_scales" else k.removeprefix("subj_basis.")
    g = {name(k): v for k, v in got["grad"].items()}
    d = {name(k): v for k, v in got["delta"].items()}
    if len(got["loss"]) != len(ref["loss"]) or set(g) != set(ref["grad"]):
        return {"loss_rel": float("inf"), "grad_gap": float("inf"), "delta_gap": float("inf")}
    med = float(np.median(list(ref["grad"].values())))
    counted = [k for k, v in ref["grad"].items() if v >= 1e-3 * med]
    med_d = float(np.median([ref["delta"][k] for k in counted]))

    def gap(mine, theirs, k, m):
        return abs(mine[k] - theirs[k]) / max(theirs[k], m)
    return {"loss_rel": max(abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"])),
            "grad_gap": max(gap(g, ref["grad"], k, med) for k in counted),
            "delta_gap": max(gap(d, ref["delta"], k, med_d) for k in counted)}


class _ReferenceTrainer:
    """The correctness control in the program's place: the reference's step
    one precision below the configuration's ("lower": the float32 towers
    and generator in bfloat16, the bfloat16 UNets and VAE with float8 e4m3
    operands), or in float32 with half of each batch left out
    ("half_batch"), fed and captured as the program is."""

    def __init__(self, cfg, w, device, batches, faces, control):
        if control not in ("lower", "half_batch"):
            raise ValueError(f"unknown control {control!r}")
        lower = control == "lower"
        self.cfg, self.device, self.batches, self.faces = cfg, device, batches, faces
        self.st = _Stepper(cfg, {m: {k: v.float() for k, v in d.items()} for m, d in w.items()}, device,
                           towers=torch.bfloat16 if lower else torch.float32, fp8=lower,
                           half_batch=not lower)

    def leaves(self) -> dict:
        return {("subj_basis." + k if k != "emb_scales" else k): v for k, v in self.st.params.items()}

    def accumulated(self) -> dict:
        return {("subj_basis." + k if k != "emb_scales" else k): v for k, v in self.st.opt.acc.items()}

    def snapshot(self, host) -> dict:
        return self.st.snapshot(host)

    def train_step(self, i) -> dict:
        raw = next(self.batches)
        for _ in raw["faceid"]:
            self.faces.pending.popleft()
        return {"loss_arc2face_distill": self.st.step(i, reference_batch(raw, self.device))}
