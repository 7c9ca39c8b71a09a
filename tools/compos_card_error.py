"""The compositional phase's error on the card, and what a planted kernel
fault reads against it.

    python3 tools/compos_card_error.py [--seeds 0 1 2 3] [--device cuda]

A small UNet (model_channels 64, 4 heads, 32x32 latents, batch 4) runs
train/compos_step.ComposStep.loss and its backward over one trainable
4-type context: the V/K mixes, activation capture, the mix-prompt,
cross-layer and elastic preservation losses, no img_mask (B1 and B4 without
key bias, B3). Each run is read against fp32 on the CPU: the loss's
relative error, x_recon's relative L2, the context gradient's relative L2
and that of the q, k, v weights' gradients of the self-attentions that run
the flash path (`self_attn_weights`). Every run but the reference takes the
same bf16 weights:

  cpu_bf16          the CPU, where every wrapper runs its plain version
  card, card_again  the card with its kernels, twice
  card_plain        the card with every kernel swapped for its plain version
  card_plain_<k>    the card with kernel k alone swapped
  fault_<k>_<eps>   the card with a planted fault: B1's or B3's output, or
                    one of B4's dq, dk, dv, scaled by 1 + eps

Prints one JSON object {seed: {run: {reading: value}}} on its last line
and writes it to chiprun_out/compos_card_error.json.
`--device cpu` runs the "card" runs on the CPU (a dry run of the script).
"""

import argparse
import contextlib
import functools
import json
import os
import sys

import torch

sys.path.insert(0, os.getcwd())
from adaprompt_tpu_torch.models.unet import UNet, UNetConfig  # noqa: E402
from adaprompt_tpu_torch.ops import attention, geglu as geglu_mod  # noqa: E402
from adaprompt_tpu_torch.ops.layers import randomize_zero_init, reset_parameters  # noqa: E402
from adaprompt_tpu_torch.train.compos_step import ComposStep  # noqa: E402

CFG = UNetConfig(model_channels=64, num_heads=4, context_dim=64)
SUBJ_POS = list(range(5, 21))
FAULTS = (("b4_dq", 0.01), ("b4_dq", 0.03), ("b4_dq", 0.05), ("b4_dk", 0.03), ("b4_dv", 0.03),
          ("b1_out", 0.01), ("b3_out", 0.01))


def compos_case(seed: int):
    """(fp32 UNet on the CPU, the 4-type context [16, 4, 77, 64], the batch)
    made from `seed`: four t, the outfeat LayerNorm on, a box fg mask."""
    gen = torch.Generator().manual_seed(seed)
    unet = randomize_zero_init(reset_parameters(UNet(CFG), gen), gen)
    ctx = torch.randn(16, 4, 77, 64, generator=gen)
    batch = {"x_start": torch.randn(4, 32, 32, 4, generator=gen),
             "noise": torch.randn(4, 32, 32, 4, generator=gen),
             "t": torch.tensor([690, 610, 520, 450]), "training_percent": torch.tensor(0.3),
             "normalize_outfeat": torch.tensor(1.0), "fg_mask": torch.zeros(1, 32, 32, 1)}
    batch["fg_mask"][:, 8:24, 10:22] = 1.0
    return unet, ctx, batch


def bf16_copy(unet: UNet, device) -> UNet:
    """The UNet's weights rounded to bf16, on `device`."""
    out = UNet(CFG, device=device, dtype=torch.bfloat16)
    out.load_state_dict({k: v.to(torch.bfloat16) for k, v in unet.state_dict().items()})
    return out


def self_attn_weights(unet: UNet) -> dict:
    """{"q" | "k" | "v": [the projection weights of every self-attention at
    the full latent size]}. At 32x32 latents only these run the flash path
    (Sq = Sk = 1024; 256 at the next level is under its Sq >= 512), so their
    gradients are x^T dq, x^T dk, x^T dv of B4's outputs."""
    ps = dict(unet.named_parameters())
    return {w: [p for n, p in ps.items() if n.endswith(f".attn1.to_{w}.weight")
                and p.shape[0] == CFG.model_channels] for w in "qkv"}


def run_phase(unet: UNet, ctx, batch, device, dtype, backwards=({},)):
    """ComposStep.loss over the context (a leaf of its own) with the
    self-attentions' q, k, v weights trainable for the run, then one
    backward from that one forward for each entry of `backwards` (the
    wrappers `patched` swaps for it). -> (loss, x_recon, [{"ctx" | "q" | "k"
    | "v": the gradient, flattened}, one per backward] on the CPU, the q
    BatchNorm statistics)."""
    weights = self_attn_weights(unet)
    for p in sum(weights.values(), []):
        p.requires_grad_(True)

    def context_fn(params, mp, b, draws):
        c = params["ctx"]
        return {"ctx4": c, "static_embs": c.transpose(0, 1), "prompt_emb_mask": None,
                "subj_pos": SUBJ_POS, "bg_pos": None}

    c = ctx.clone().to(device).requires_grad_(True)
    b = {k: v.to(device) for k, v in batch.items()}
    loss, _, x_recon, stats = ComposStep(context_fn, (1,), compute_dtype=dtype).loss(
        {"ctx": c}, {"unet": unet}, b, {})
    leaves = {"ctx": [c], **weights}
    grads = []
    for i, swaps in enumerate(backwards):
        with patched(swaps):
            g = torch.autograd.grad(loss, sum(leaves.values(), []),
                                    retain_graph=i + 1 < len(backwards))
        g = iter(g)
        grads.append({n: torch.cat([next(g).float().flatten() for _ in ps]).cpu()
                      for n, ps in leaves.items()})
    for p in sum(weights.values(), []):
        p.requires_grad_(False)
    return loss.item(), x_recon.float().cpu(), grads, stats


def rel(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


def readings(got, ref, i=0, j=0) -> dict:
    """The loss's relative error, x_recon's relative L2, and that of the
    gradients of backward i of `got` against backward j of `ref`."""
    return {"loss": abs(got[0] - ref[0]) / abs(ref[0]), "x_recon": rel(got[1], ref[1]),
            **{f"{n}_grad": rel(g, ref[2][j][n]) for n, g in got[2][i].items()}}


def _plain_fwd(q, k, v, key_bias, scale, variant=attention.FlashVariant()):
    return attention.flash_attention_fwd_reference(q, k, v, key_bias, scale, variant)


def _plain_bwd(q, k, v, key_bias, out, lse, dout, scale, variant=attention.FlashVariant()):
    return attention.flash_attention_bwd_reference(q, k, v, key_bias, out, lse, dout, scale,
                                                   variant.exp2)


def _scaled(x, eps):
    return (x.float() * (1.0 + eps)).to(x.dtype)


def faulty(name: str, eps: float) -> dict:
    """{module attribute: replacement} planting the fault `name`."""
    fwd, bwd, geglu = (attention.flash_attention_fwd, attention.flash_attention_bwd,
                       geglu_mod.geglu_fwd)
    if name == "b1_out":
        def f(*a, **kw):
            out, lse = fwd(*a, **kw)
            return _scaled(out, eps), lse
        return {"flash_attention_fwd": f}
    if name == "b3_out":
        return {"geglu_fwd": lambda *a, **kw: _scaled(geglu(*a, **kw), eps)}
    which = ("b4_dq", "b4_dk", "b4_dv").index(name)

    def b(*a, **kw):
        grads = list(bwd(*a, **kw))
        grads[which] = _scaled(grads[which], eps)
        return tuple(grads)
    return {"flash_attention_bwd": b}


@contextlib.contextmanager
def patched(swaps: dict):
    """Replace the wrappers named in `swaps` (flash_attention_fwd,
    flash_attention_bwd, geglu_fwd) for the duration. A replacement takes
    the wrapper's name and a copy of its counts, since a wrapper it calls
    names its kernel and counts its launch through the module's attribute."""
    mods = {"flash_attention_fwd": attention, "flash_attention_bwd": attention,
            "geglu_fwd": geglu_mod}
    saved = {n: getattr(mods[n], n) for n in swaps}
    try:
        for n, f in swaps.items():
            setattr(mods[n], n, functools.update_wrapper(f, saved[n]))
        yield
    finally:
        for n, f in saved.items():
            setattr(mods[n], n, f)


def _plain_geglu(x, w1, b1, w2, b2):
    return geglu_mod.geglu_reference(x, w1, b1, w2, b2)


PLAIN = {"b1": {"flash_attention_fwd": _plain_fwd}, "b3": {"geglu_fwd": _plain_geglu},
         "b4": {"flash_attention_bwd": _plain_bwd}}


def seed_readings(seed: int, device: str) -> dict:
    """Every run of the module docstring, read against fp32 on the CPU; the
    card's run against the card's plain one (card_vs_card_plain) and against
    the CPU's bf16 one; and, from the card's one forward, its backward with
    B4 against its backward with B4's plain version (b4_vs_plain_same_forward)
    and each planted B4 fault against that plain backward."""
    unet, ctx, batch = compos_case(seed)
    ref = run_phase(unet, ctx, batch, "cpu", torch.float32)
    card = bf16_copy(unet, device)
    runs = {"cpu_bf16": run_phase(bf16_copy(unet, "cpu"), ctx, batch, "cpu", torch.bfloat16)}
    b4_faults = [(n, e) for n, e in FAULTS if n.startswith("b4")]
    one = lambda backwards=({},): run_phase(card, ctx, batch, device, torch.bfloat16, backwards)
    runs["card"] = one([{}, PLAIN["b4"]] + [faulty(n, e) for n, e in b4_faults])
    runs["card_again"] = one()
    with patched({k: f for swap in PLAIN.values() for k, f in swap.items()}):
        runs["card_plain"] = one()
    for k, swap in PLAIN.items():
        with patched(swap):
            runs[f"card_plain_{k}"] = one()
    for name, eps in FAULTS:
        with patched(faulty(name, eps)):
            runs[f"fault_{name}_{eps:g}"] = one()
    out = {name: readings(r, ref) for name, r in runs.items()}
    out.update({f"{name}_vs_card": readings(r, runs["card"]) for name, r in runs.items()
                if name.startswith(("card_plain_", "fault_"))})
    out["card_vs_card_plain"] = readings(runs["card"], runs["card_plain"])
    out["card_vs_cpu_bf16"] = readings(runs["card"], runs["cpu_bf16"])
    out["card_plain_vs_cpu_bf16"] = readings(runs["card_plain"], runs["cpu_bf16"])
    out["b4_vs_plain_same_forward"] = readings(runs["card"], runs["card"], 0, 1)
    for i, (name, eps) in enumerate(b4_faults):
        out[f"fault_{name}_{eps:g}_vs_plain_same_forward"] = readings(runs["card"], runs["card"],
                                                                      2 + i, 1)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("compos_card_error: no CUDA device", file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    result = {}
    for seed in args.seeds:
        result[seed] = seed_readings(seed, args.device)
        for name, r in result[seed].items():
            print(f"seed {seed} {name:40s} " + " ".join(f"{k}={v:.4e}" for k, v in r.items()),
                  flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "compos_card_error.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
