"""Face-dataset curation tools: the roles of the reference's
scripts-private/{comparefaces.py, filter_faces.py, knn-faces.py}.

Port of `adaprompt_tpu/cli/face_tools.py`: pairwise folder identity
comparison, outlier filtering against a folder's mean ArcFace embedding, and
nearest-neighbour queries. Faces are found by `make_detector(None)`'s
detector (RetinaFace when $ADAPROMPT_RETINAFACE_CKPT points at weights,
BiSeNet when $ADAPROMPT_BISENET_CKPT does, else the centre crop) and
embedded by the IResNet-100 trunk, both on `--device`; without
`--arcface_ckpt` the trunk has random weights from seed 2, as in the JAX
CLI. Photos are read by `utils/png.read_image` (PNG and `.npy` without PIL).

    python -m adaprompt_tpu_torch.cli.face_tools [--arcface_ckpt r100.pth] \\
        <compare src dst | filter folder | knn query folder> ...
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np


def _evaluator(arcface_ckpt, device):
    from adaprompt_tpu_torch.cli.common import load_arcface
    from adaprompt_tpu_torch.eval.face_eval import FaceSimilarityEvaluator
    return FaceSimilarityEvaluator(load_arcface(arcface_ckpt, device))


def cmd_compare(args):
    """-> (avg similarity, photos scored, photos without a face)."""
    from adaprompt_tpu_torch.eval.face_eval import compare_face_folders
    ev = _evaluator(args.arcface_ckpt, args.device)
    avg, n_ok, n_nf = compare_face_folders(ev, args.src, args.dst)
    print(f"avg face sim: {avg:.3f}  ({n_ok} scored, {n_nf} faceless)")
    return avg, n_ok, n_nf


def cmd_filter(args):
    """-> [(path moved to the reject folder, its similarity)]."""
    from adaprompt_tpu_torch.eval.face_eval import list_images
    ev = _evaluator(args.arcface_ckpt, args.device)
    paths = list_images(args.folder)
    embs = ev.embed_folder(paths)
    valid = [(p, e[0]) for p, e in zip(paths, embs) if len(e)]
    if not valid:
        print("no faces found")
        return []
    mat = np.stack([e for _, e in valid])
    mean = mat.mean(axis=0)
    mean /= np.linalg.norm(mean)
    sims = mat @ mean
    os.makedirs(args.reject_dir, exist_ok=True)
    rejected = []
    for (p, _), s in zip(valid, sims):
        if s < args.threshold:
            shutil.move(p, os.path.join(args.reject_dir, os.path.basename(p)))
            rejected.append((p, float(s)))
            print(f"rejected {os.path.basename(p)} (sim {s:.3f})")
    print(f"{len(rejected)}/{len(valid)} images below threshold {args.threshold}")
    return rejected


def cmd_knn(args):
    """-> [(similarity, path)], the k nearest, most similar first."""
    from adaprompt_tpu_torch.eval.face_eval import list_images
    ev = _evaluator(args.arcface_ckpt, args.device)
    q = ev.embed_folder([args.query])[0]
    if len(q) == 0:
        print("no face in query")
        return []
    paths = list_images(args.folder)
    embs = ev.embed_folder(paths)
    scored = [(float(q[0] @ e[0]), p) for p, e in zip(paths, embs) if len(e)]
    nearest = sorted(scored, reverse=True)[: args.k]
    for s, p in nearest:
        print(f"{s:.3f}  {p}")
    return nearest


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arcface_ckpt", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="the models' device; 'cpu' runs on the host")
    sub = p.add_subparsers(dest="cmd", required=True)
    pc = sub.add_parser("compare")
    pc.add_argument("src")
    pc.add_argument("dst")
    pf = sub.add_parser("filter")
    pf.add_argument("folder")
    pf.add_argument("--threshold", type=float, default=0.5)
    pf.add_argument("--reject_dir", type=str, default="rejected")
    pk = sub.add_parser("knn")
    pk.add_argument("query")
    pk.add_argument("folder")
    pk.add_argument("--k", type=int, default=5)
    args = p.parse_args(argv)
    return {"compare": cmd_compare, "filter": cmd_filter, "knn": cmd_knn}[args.cmd](args)


if __name__ == "__main__":
    main()
