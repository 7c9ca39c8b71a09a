"""Checkpoint surgery tools.

Port of `adaprompt_tpu/cli/ckpt_tools.py` (the reference's repl_vae.py,
repl_textencoder.py, avg_models.py and chk_ckpt_weights.py):

  replace-vae        splice another VAE (e.g. the 840k-MSE VAE) into an SD ckpt
  replace-text       splice another text encoder (e.g. DreamShaper) into one
  average            SWA-average several AdaFace .npz checkpoints
  inspect            print per-tensor shapes and norms of an .npz, .ckpt or .pt

Usage: python -m adaprompt_tpu_torch.cli.ckpt_tools <subcommand> ...
"""

from __future__ import annotations

import argparse

import numpy as np


def replace_component(base_path: str, donor_path: str, out_path: str, prefix: str):
    """Copy the donor's `prefix*` tensors over the base SD state dict's of
    the same name and shape, and save the result as .npz. A donor without
    the prefix is taken as the component alone."""
    from adaprompt_tpu_torch.utils.torch_port import load_state_dict
    base = load_state_dict(base_path)
    donor = load_state_dict(donor_path)
    donor_keys = {k: v for k, v in donor.items() if k.startswith(prefix)}
    if not donor_keys:
        donor_keys = {prefix + k: v for k, v in donor.items()}
    replaced = 0
    for k, v in donor_keys.items():
        if k in base and np.shape(base[k]) == np.shape(v):
            base[k] = v
            replaced += 1
    print(f"replaced {replaced} tensors under '{prefix}'")
    np.savez(out_path, **{k: np.asarray(v) for k, v in base.items() if hasattr(v, "shape")})
    print(f"wrote {out_path}")


def _mean_tree(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _mean_tree([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [_mean_tree([t[i] for t in trees]) for i in range(len(first))]
    return sum(trees) / len(trees)


def average_checkpoints(paths, out_path):
    """SWA-average native .npz AdaFace checkpoints, leaf by leaf."""
    from adaprompt_tpu_torch.adaface import checkpoint as ckpt_mod
    trees, meta = [], {}
    for p in paths:
        t, meta = ckpt_mod.load_checkpoint(p)
        trees.append(t)
    ckpt_mod.save_checkpoint(out_path, _mean_tree(trees),
                             meta={**meta, "averaged_from": list(paths)})
    print(f"averaged {len(paths)} ckpts -> {out_path}")


def inspect_checkpoint(path):
    """Print the count, and the shape and norm of the first 200 tensors by name."""
    if path.endswith(".npz"):
        data = np.load(path, allow_pickle=False)
        sd = {k: data[k] for k in data.files if k != "__meta__"}
    else:
        from adaprompt_tpu_torch.utils.torch_port import load_state_dict
        sd = {k: v for k, v in load_state_dict(path).items() if hasattr(v, "shape")}
    print(f"{len(sd)} tensors")
    for k in sorted(sd)[:200]:
        v = sd[k]
        print(f"  {k:70s} {str(tuple(v.shape)):20s} norm={np.linalg.norm(v):.4f}")


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("replace-vae", "replace-text"):
        pr = sub.add_parser(name)
        pr.add_argument("--base", required=True)
        pr.add_argument("--donor", required=True)
        pr.add_argument("--out", required=True)
    pa = sub.add_parser("average")
    pa.add_argument("ckpts", nargs="+")
    pa.add_argument("--out", required=True)
    pi = sub.add_parser("inspect")
    pi.add_argument("ckpt")

    args = p.parse_args(argv)
    if args.cmd == "replace-vae":
        replace_component(args.base, args.donor, args.out, "first_stage_model.")
    elif args.cmd == "replace-text":
        replace_component(args.base, args.donor, args.out, "cond_stage_model.")
    elif args.cmd == "average":
        average_checkpoints(args.ckpts, args.out)
    elif args.cmd == "inspect":
        inspect_checkpoint(args.ckpt)


if __name__ == "__main__":
    main()
