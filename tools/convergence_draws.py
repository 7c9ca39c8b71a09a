#!/usr/bin/env python3
"""How the trainer-loop gate (tests/test_convergence.py::
test_trainer_loop_converges: the last 20 of 150 recon steps below 0.85x the
first 20) depends on the random draw of its tiny models, and whether the
port's trainer learns as the JAX one does on the same models and data.

    python3 tools/convergence_draws.py card [--seeds 0 1 2 3 4]
        on a CUDA card, bf16: the port's gate as
        tests/test_torch_convergence.py runs it (two fixed 64x64 images,
        no augmentation), its tiny models drawn from each seed (0 is the
        test's draw);
    JAX_PLATFORMS=cpu python3 tools/convergence_draws.py cpu [--seeds 0 1]
        on the CPU, fp32, for each seed: the JAX package's gate with its
        tiny models drawn as its test draws them (seed 0 is the test's own:
        PRNGKey(seed) for the UNet and text encoders, seed + 77 to redraw
        the zero leaves, seed + 9 for the VAE, seed + 5 for the generator)
        and its dataset (random scale and shift); then the port's trainer
        on those same weights, first with the same dataset, then with the
        port gate's two unaugmented images; then the port gate's own draw
        of the models (the card test's builder on the CPU in fp32) with the
        JAX dataset.

Each run prints one line: the first and last 20 steps' mean recon loss and
their ratio. The cpu mode imports both packages (a diagnostic beside the
tests, as they do); the card mode imports only the port.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys
import tempfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
STEPS = 150


def _ratio(name, seed, losses):
    first, last = losses[:20].mean(), losses[-20:].mean()
    print(f"{name} seed {seed}: first-20 {first:.6f} last-20 {last:.6f} ratio "
          f"{last / first:.4f} (bound 0.85)", flush=True)


def card(seeds):
    import test_torch_convergence as gate
    for seed in seeds:
        with tempfile.TemporaryDirectory() as tmp:
            losses, _ = gate.trainer_loop_losses(tmp, seed=seed, steps=STEPS)
        _ratio("port bf16 card, port draw, unaugmented", seed, losses)


def _jax_models(seed, tok):
    """tests/test_convergence.py's _tiny_frozen with the keys offset by seed."""
    import jax
    import jax.numpy as jnp
    from adaprompt_tpu.adaface import subj_basis_generator as sbg
    from adaprompt_tpu.models import clip_text, unet as unet_mod, vae as vae_mod
    from adaprompt_tpu.train import steps as steps_mod
    import test_convergence as jgate
    tcfg = clip_text.CLIPTextConfig(vocab_size=50000, hidden_size=jgate.HIDDEN,
                                    intermediate_size=jgate.HIDDEN * 2, num_layers=2, num_heads=8,
                                    eos_token_id=tok.eos_id)
    ucfg = unet_mod.UNetConfig(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                               attention_ds=(1, 2), num_heads=4, context_dim=jgate.HIDDEN,
                               use_checkpoint=False)
    keys = jax.random.split(jax.random.PRNGKey(seed), 4)
    unet = unet_mod.init_params(keys[0], ucfg)
    leaves, treedef = jax.tree.flatten(unet)
    key, out = jax.random.PRNGKey(77 + seed), []
    for leaf in leaves:
        if leaf.ndim >= 2 and not jnp.any(leaf):
            key, k = jax.random.split(key)
            leaf = 0.3 * jax.random.normal(k, leaf.shape, leaf.dtype)
        out.append(leaf)
    frozen = steps_mod.FrozenSD(
        unet=jax.tree.unflatten(treedef, out), text=clip_text.init_params(keys[1], tcfg),
        arc2face_text=clip_text.init_params(keys[2], tcfg),
        teacher_unet=unet_mod.init_params(keys[3], ucfg), unet_cfg=ucfg, text_cfg=tcfg,
        arc2face_text_cfg=tcfg)
    vcfg = vae_mod.VAEConfig(ch=32, ch_mult=(1, 2, 4), num_res_blocks=1)
    vae = vae_mod.init_params(jax.random.PRNGKey(9 + seed), vcfg)
    scfg = sbg.SubjBasisConfig(placeholder_is_bg=False, output_dim=jgate.HIDDEN, text_cfg=tcfg)
    return frozen, vcfg, vae, scfg, sbg.init_params(jax.random.PRNGKey(5 + seed), scfg)


def cpu(seeds):
    import jax
    from PIL import Image
    from adaface_fixtures import build_word_vocab
    from adaprompt_tpu.data import dataset as ds
    from adaprompt_tpu.train import trainer as jtrainer
    from adaprompt_tpu_torch import convert
    from adaprompt_tpu_torch.adaface import subj_basis_generator as tsbg
    from adaprompt_tpu_torch.models import clip_text as tclip, unet as tunet, vae as tvae
    from adaprompt_tpu_torch.ops.layers import reset_parameters
    from adaprompt_tpu_torch.train import steps as tsteps, trainer as ttrainer
    from adaprompt_tpu_torch.utils.tokenizer import CLIPTokenizer
    import test_torch_convergence as gate
    gate.DEV, gate.DT = "cpu", torch.float32
    size = gate.LAT * 8

    def port(module, tree):
        module.load_state_dict(convert.from_jax_params(jax.tree.map(np.asarray, tree)),
                               strict=True)
        return module

    for seed in seeds:
        tmp = pathlib.Path(tempfile.mkdtemp())
        rng = np.random.default_rng(0)
        d = tmp / "subjects" / "alice"
        d.mkdir(parents=True)
        for i in range(2):
            Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)).save(
                d / f"i{i}.jpg")
            m = np.zeros((size, size), np.uint8)
            m[8:size - 8, 8:size - 8] = 255
            Image.fromarray(m).save(d / f"i{i}_mask.png")
        tok = build_word_vocab(tmp)
        ttok = CLIPTokenizer.from_files(str(tmp / "vocab.json"), str(tmp / "merges.txt"))

        def data():
            subjects = ds.scan_subject_folders(str(tmp / "subjects"))
            dset = ds.PersonalizedDataset(subjects, size=size, seed=0,
                                          num_vectors_per_subj_token=16)
            return ds.make_batch_iterator(dset, ds.SubjectSampler(subjects, seed=0), batch_size=2)

        kw = dict(max_steps=200, grad_accum=2, warm_up_steps=10, arc2face_distill_iter_prob=0.0,
                  fgbg_reg=False, ckpt_every=10 ** 9, metrics_flush_every=1,
                  out_dir=str(tmp / "run"), compute_dtype="float32", seed=0)
        frozen, vcfg, vae, scfg, sparams = _jax_models(seed, tok)
        jtr = jtrainer.AdaPromptTrainer(frozen, vae, vcfg, tok, scfg, sparams, data(),
                                        jtrainer.TrainerConfig(**kw), synthetic_faces=True)
        _ratio("jax fp32 cpu, jax draw, dataset", seed,
               np.asarray([float(jtr.train_step(i)["loss_recon"]) for i in range(STEPS)]))

        def port_trainer(models, batches):
            tf, tv, tscfg, s = models
            tr = ttrainer.AdaPromptTrainer(tf, tv, ttok, tscfg, s, batches,
                                           ttrainer.TrainerConfig(**kw), synthetic_faces=True)
            return np.asarray([tr.train_step(i)["loss_recon"] for i in range(STEPS)])

        def jax_weights():
            tcfg = tclip.CLIPTextConfig(vocab_size=50000, hidden_size=gate.HIDDEN,
                                        intermediate_size=2 * gate.HIDDEN, num_layers=2,
                                        num_heads=8, eos_token_id=tok.eos_id)
            ucfg = tunet.UNetConfig(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                                    attention_ds=(1, 2), num_heads=4, context_dim=gate.HIDDEN)
            tscfg = tsbg.SubjBasisConfig(placeholder_is_bg=False, output_dim=gate.HIDDEN,
                                         text_cfg=tcfg)
            tf = tsteps.FrozenSD(port(tunet.UNet(ucfg), frozen.unet),
                                 port(tclip.CLIPTextModel(tcfg), frozen.text),
                                 port(tclip.CLIPTextModel(tcfg), frozen.arc2face_text), None)
            tv = port(tvae.VAE(tvae.VAEConfig(ch=32, ch_mult=(1, 2, 4), num_res_blocks=1)), vae)
            return tf, tv, tscfg, port(tsbg.SubjBasisGenerator(tscfg), sparams).train()

        _ratio("port fp32 cpu, jax draw, dataset", seed, port_trainer(jax_weights(), data()))
        _ratio("port fp32 cpu, jax draw, unaugmented", seed,
               port_trainer(jax_weights(), gate._two_images(size, "a photo of a z person")))
        tf, tcfg = gate._tiny_frozen(ttok, seed)
        tv = reset_parameters(tvae.VAE(tvae.VAEConfig(ch=32, ch_mult=(1, 2, 4), num_res_blocks=1)),
                              torch.Generator().manual_seed(9 + seed))
        tscfg = tsbg.SubjBasisConfig(placeholder_is_bg=False, output_dim=gate.HIDDEN,
                                     text_cfg=tcfg)
        s = reset_parameters(tsbg.SubjBasisGenerator(tscfg),
                             torch.Generator().manual_seed(5 + seed)).train()
        _ratio("port fp32 cpu, port draw, dataset", seed, port_trainer((tf, tv, tscfg, s), data()))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("card", "cpu"))
    ap.add_argument("--seeds", type=int, nargs="+", default=None)
    args = ap.parse_args()
    if args.mode == "card":
        if not torch.cuda.is_available():
            sys.exit("card mode needs a CUDA card")
        card(args.seeds or [0, 1, 2, 3, 4])
    else:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        cpu(args.seeds or [0, 1])


if __name__ == "__main__":
    main()
