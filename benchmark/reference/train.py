"""AdaFace Stage 1, plain: the Arc2Face distillation step and its optimizer
(askerlee/adaprompt `configs/stable-diffusion/v1-finetune-ada.yaml`, README
Stage 1; LDM's `ddpm.py` distillation iteration).

One step of a batch (images [B, H, W, 3] in [-1, 1], face vectors [B, 512],
the foreground and padding masks at latent size [B, h, w, 1]):
  * the VAE's posterior mean of every image, times 0.18215;
  * ND > 1 keeps the first ceil(B / ND) rows;
  * the teacher's conditioning: Arc2Face's "photo of a id person" (21 tokens)
    with the face vector over 'id'; its 16 core embeddings from 'id' on;
  * the teacher (a separate SD-1.5 UNet under that context) denoises ND
    times from (z0, t, noise): x_t = q(x, t, noise), eps, x0 = the
    prediction, the next t drawn in [t 0.5^a, t 0.7^a), a = (ND - 1)^-0.3;
  * the student's context: the SubjBasisGenerator's prompt ("photo of a " +
    16 commas with the core embeddings over the commas, its clip-skip
    weights over the last 3 hidden states, their gradient scaled by 5), the
    positions after the 16 vectors and 2 extra-word slots replaced by the
    pad embedding (EOS + position), the gradient scaled by 0.4; then SD's
    text encoder on those embeddings with clip-skip weights (1, 2, 2);
  * for the last max(7 // B, 1) of the ND stages s: the student (the frozen
    SD UNet, padded pixels dropped as self-attention keys) at q(x0 of stage
    s - 1, t_s, noise_s) (stage 0 takes the last stage's x0) against the
    teacher's eps of stage s: the squared error over foreground pixels of
    the padding mask over their count, summed over stages, over sqrt(ND).
The gradient reaches only the SubjBasisGenerator (and nothing reaches the
learnable global scales, which a distillation step does not use).

The optimizer: MultiSteps(2) averages two steps' gradients; then the global
norm is clipped to 0.5 and Prodigy (d0 1e-6, d_coef 1, betas (0.9, 0.999),
beta3 sqrt(0.999), eps 1e-8, bias correction, learning rate 1 during the
warm-up, then a linear decay) updates every leaf.

The random draws are the trainer's protocol, made again here from the
configuration's `trainer.seed`: on the host, a step's iteration coin, the
Dirichlet clip-skip weights, the embedding-noise coin, the scale
perturbation and ND; on the device, a `torch.Generator` seeded alike, the
timesteps, the noise, the chain's uniforms and its further noise.

The backward runs in blocks of rows through the student (its context is a
leaf whose gradient is then pushed through the text encoder and the
generator), so that fp32 activations of 8 rows at 512x512 fit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import adaface, clip, unet, vae
from benchmark.reference.tokenizer import EOS_ID, Tokenizer

SD_SCALE_FACTOR = 0.18215
ROWS = 2                 # rows a block in the reference's UNet and VAE passes


class _GradScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        ctx.alpha = alpha
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.alpha, None


def grad_scale(x: torch.Tensor, alpha: float) -> torch.Tensor:
    return x if alpha == 1.0 else _GradScale.apply(x, alpha)


def schedule(device) -> dict:
    """SD-1.5's forward-process coefficients (1,000 steps, sqrt-linear betas
    0.00085 .. 0.012), computed in float64 and kept in float32."""
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000, dtype=np.float64) ** 2
    acp = np.cumprod(1.0 - betas)
    f = lambda a: torch.as_tensor(a.astype(np.float32), device=device)
    return {"a": f(np.sqrt(acp)), "s": f(np.sqrt(1.0 - acp)), "ra": f(np.sqrt(1.0 / acp)),
            "rm1": f(np.sqrt(1.0 / acp - 1.0))}


def _at(v, t):
    return v[t.long()][:, None, None, None]


def q_sample(sch, x0, t, noise):
    return _at(sch["a"], t) * x0 + _at(sch["s"], t) * noise


def predict_x0(sch, xt, t, eps):
    return _at(sch["ra"], t) * xt - _at(sch["rm1"], t) * eps


def nd_choices(tcfg: dict) -> tuple:
    cand = [s for s in (1, 3, 5, 7) if s <= tcfg["max_num_denoising_steps"]]
    p = np.asarray(tcfg["num_denoising_steps_probs"][:len(cand)], np.float64)
    return cand, p / p.sum()


def host_draws(tcfg: dict, steps: int) -> list:
    """ND of each of the first `steps` distillation steps (every step is one:
    the iteration coin's probability is 1), drawn in the trainer's order."""
    rng = np.random.default_rng(tcfg["seed"])
    cand, p = nd_choices(tcfg)
    out = []
    for _ in range(steps):
        rng.random()                                           # the iteration coin
        rng.dirichlet(np.asarray(tcfg["skip_weights"], np.float64))
        rng.random()                                           # the embedding-noise coin (probability 0)
        rng.uniform(0.8, 1.4, size=(2,))                       # the global-scale perturbation
        out.append(int(rng.choice(cand, p=p)))
    return out


def device_draws(gen: torch.Generator, b: int, nd: int, latent: tuple, device) -> dict:
    """A step's draws from the device generator, in the trainer's order."""
    return {"t": torch.randint(0, 1000, (b,), generator=gen, device=device),
            "noise": torch.randn((b,) + latent, generator=gen, device=device),
            "rels": torch.rand((nd - 1, b), generator=gen, device=device),
            "next_noises": torch.randn((nd - 1, b) + latent, generator=gen, device=device)}


def latents(w_vae: dict, c_vae: dict, images: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """z0 of NHWC images, in blocks of rows."""
    with torch.no_grad():
        return torch.cat([vae.encode(w_vae, c_vae, images[i:i + ROWS].to(dtype)).float()
                          for i in range(0, images.shape[0], ROWS)]) * SD_SCALE_FACTOR


def _unet_rows(w, c, x, t, ctx, img_mask=None):
    return torch.cat([unet.forward(w, c, x[i:i + ROWS], t[i:i + ROWS], ctx[i:i + ROWS],
                                   None if img_mask is None else img_mask[i:i + ROWS]).float()
                      for i in range(0, x.shape[0], ROWS)])


def teacher_chain(w_t: dict, c_unet: dict, sch: dict, z0, noise, t, ctx, rels, next_noises, nd: int):
    """(eps of each stage, x0 of each stage, noise of each stage, t of each stage)."""
    x, ts, noises, eps_all, x0s = z0, [t], [noise], [], []
    with torch.no_grad():
        for i in range(nd):
            xt = q_sample(sch, x, ts[i], noises[i])
            eps = _unet_rows(w_t, c_unet, xt, ts[i], ctx)
            eps_all.append(eps)
            x = predict_x0(sch, xt, ts[i], eps)
            x0s.append(x)
            if i < nd - 1:
                a = float(np.power(nd - 1, -0.3))
                lb = ts[i].float() * float(np.power(0.5, a))
                ub = ts[i].float() * float(np.power(0.7, a))
                ts.append(((ub - lb) * rels[i] + lb).to(torch.int32))
                noises.append(next_noises[i])
    return eps_all, x0s, noises, ts


def student_context(w_sbg: dict, w_text: dict, c_text: dict, tok: Tokenizer, core: torch.Tensor,
                    skip_weights) -> torch.Tensor:
    """The SubjBasisGenerator's training prompt ('full_pad', gradient x0.4)
    through SD's text encoder with the configuration's clip-skip weights."""
    hw = grad_scale(w_sbg["hidden_state_layer_weights"], 5.0)
    prompt, _, start = adaface.inverse_prompt(w_sbg, c_text, tok, core, hw)
    seq = prompt.shape[1]
    after = start + adaface.NUM_VECTORS + 2
    pad = (w_sbg["prompt2token_proj.token_embedding"][EOS_ID]
           + w_sbg["prompt2token_proj.position_embedding"][:seq]).detach()
    keep = ~((torch.arange(seq, device=prompt.device) >= after) & (torch.arange(seq, device=prompt.device) < seq - 1))
    prompt = torch.where(keep[None, :, None], prompt, pad[None].to(prompt.dtype))
    prompt = grad_scale(prompt, 0.4)
    sw = torch.as_tensor(np.asarray(skip_weights, np.float32), device=prompt.device).to(prompt.dtype)
    return clip.encode(w_text, c_text, prompt, skip_weights=sw)


def distill_step(w: dict, cfg: dict, tok: Tokenizer, sch: dict, batch: dict, draws: dict, nd: int,
                 dtype=torch.float32, grads: bool = True) -> tuple:
    """The step's loss (a float) and, with `grads`, the gradient of every
    generator leaf ({name: tensor}, zeros where none flows). `w` holds the
    models' weights: 'vae', 'teacher', 'unet', 'text', 'arc2face', 'sbg'
    (its leaves requiring gradients when `grads`); the towers compute in
    `dtype`."""
    c_unet, c_text = cfg["unet"], cfg["text"]
    z0 = batch["z0"]
    b = z0.shape[0]
    fg, img = batch["fg_mask"].float(), batch["aug_mask"].float()
    with torch.no_grad():
        teacher_ctx, core = adaface.arc2face(w["arc2face"], c_text, tok, batch["faceid"].to(dtype), 21)
    eps_t, x0s, noises, ts = teacher_chain(w["teacher"], c_unet, sch, z0, draws["noise"], draws["t"],
                                           teacher_ctx.float(), draws["rels"], draws["next_noises"], nd)
    ctx = student_context(w["sbg"], w["text"], c_text, tok, core, cfg["trainer"]["skip_weights"])
    leaf = ctx.detach().float().requires_grad_(grads)
    wsum = (fg * img).sum() * z0.shape[-1] + 1e-6
    start = max(0, nd - max(7 // b, 1))
    loss = 0.0
    for s in range(start, nd):
        x_s = q_sample(sch, x0s[s - 1], ts[s], noises[s])
        for i in range(0, b, ROWS):
            r = slice(i, i + ROWS)
            with torch.set_grad_enabled(grads):
                eps = unet.forward(w["unet"], c_unet, x_s[r], ts[s][r], leaf[r], img[r]).float()
                se = ((eps * img[r] - eps_t[s][r] * img[r]) ** 2 * (fg[r] * img[r])).sum()
                part = se / wsum / math.sqrt(nd)
            if grads:
                part.backward()
            loss = loss + part.detach()
    loss = 0.0 if z0.device.type == "meta" else float(loss)
    if not grads:
        return loss, None
    ctx.backward(leaf.grad.to(ctx.dtype))
    out = {}
    for k, v in w["sbg"].items():
        out[k] = v.grad.detach().float().clone() if v.grad is not None else torch.zeros_like(v, dtype=torch.float32)
        v.grad = None
    return loss, out


def lr_schedule(tcfg: dict, count: int) -> float:
    """1 during the warm-up, then 1 - (count - warm-up) / (1.1 (max - warm-up)), clipped to [0, 1]."""
    warm, total = tcfg["warm_up_steps"], tcfg["max_steps"]
    if count < warm:
        return 1.0
    return float(np.clip(1.0 - (count - warm) / (1.1 * (total - warm)), 0.0, 1.0))


class Optimizer:
    """MultiSteps(grad_accum) over clip_by_global_norm(grad_clip) and
    Prodigy, on {name: float32 tensor} leaves, in float32 (float64 sums)."""

    def __init__(self, params: dict, tcfg: dict):
        self.tcfg = tcfg
        self.p0 = {k: v.detach().float().clone() for k, v in params.items()}
        z = lambda: {k: torch.zeros_like(v) for k, v in self.p0.items()}
        self.acc, self.m, self.v, self.s = z(), z(), z(), z()
        self.n = 0
        self.count = 0
        self.d, self.d_max, self.d_num = 1e-6, 1e-6, 0.0

    def step(self, params: dict, grads: dict) -> bool:
        """Fold `grads` in; on every grad_accum-th call update `params` in place."""
        for k, g in grads.items():
            self.acc[k] += (g - self.acc[k]) / (self.n + 1)
        self.n += 1
        if self.n < self.tcfg["grad_accum"]:
            return False
        self.n = 0
        g = dict(self.acc)
        norm = math.sqrt(sum(float((a.double() ** 2).sum()) for a in g.values()))
        if norm >= self.tcfg["grad_clip"]:
            g = {k: a / norm * self.tcfg["grad_clip"] for k, a in g.items()}
        self._prodigy(params, g)
        self.acc = {k: torch.zeros_like(v) for k, v in self.acc.items()}
        return True

    def _prodigy(self, params, g):
        b1, b2 = self.tcfg["prodigy_betas"]
        b3, d0, eps = math.sqrt(b2), 1e-6, 1e-8
        k = self.count
        bc = math.sqrt(1.0 - b2 ** (k + 1)) / (1.0 - b1 ** (k + 1))
        d = self.d
        dlr = d * lr_schedule(self.tcfg, k) * bc
        dot = sum(float((g[n].double() * (self.p0[n] - params[n].detach().float()).double()).sum()) for n in g)
        d_num = self.d_num * b3 + (d / d0) * dlr * dot
        for n in g:
            self.m[n] = self.m[n] * b1 + g[n] * (d * (1 - b1))
            self.v[n] = self.v[n] * b2 + g[n] * g[n] * (d * d * (1 - b2))
            self.s[n] = self.s[n] * b3 + g[n] * ((d / d0) * dlr)
        d_denom = sum(float(self.s[n].double().abs().sum()) for n in g)
        if d_denom <= 0:
            self.count = k + 1
            return
        d_hat = self.tcfg["d_coef"] * d_num / d_denom
        d_new = max(d, d_hat) if d == d0 else d
        self.d_max = max(self.d_max, d_hat)
        d_new = min(self.d_max, d_new * 1e30)
        self.d_num = d_num
        with torch.no_grad():
            for n in g:
                upd = -dlr * self.m[n] / (self.v[n].sqrt() + d_new * eps)
                params[n].add_(upd.to(params[n].dtype))
        self.d = d_new
        self.count = k + 1
