"""Training-data face-mask generation: the role of the reference's
scripts-private/gen_face_masks.py.

Port of `adaprompt_tpu/cli/gen_face_masks.py`. BiSeNet 19-class face
parsing (`models/bisenet.py`, weights from the public face-parsing.PyTorch
`79999_iter.pth`) runs on the card over subject folders at 512x512, in
batches of `--batch_size`; each kept photo is written resized to 512x512
beside a binary `<stem>_mask.png` (parsing != 0 -> 255, an 8-bit grey PNG),
and the reference's curation rules apply: photos with <= 9 distinct parts go
to `<src>_trash/`, photos with >= 18 to `<src>_inspect/` (copied, or moved
with `--move_bad`). Each photo is resized as PIL does it in the JAX CLI, in
its own mode before the conversion to RGB (`utils/resize.pil_bilinear_rgb`,
bit for bit). PNG photos and outputs need no PIL; a `.jpg`, `.jpeg` or
`.webp` name needs PIL, to read the photo and to write its resized copy.

    python -m adaprompt_tpu_torch.cli.gen_face_masks --bisenet_ckpt 79999_iter.pth \\
        --src /data/VGGface2_HQ --out /data/VGGface2_HQ_masks [--flat]
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np

from adaprompt_tpu_torch.utils.png import read_image_mode, write_png
from adaprompt_tpu_torch.utils.resize import pil_bilinear_rgb

PARSE_SIZE = 512


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--bisenet_ckpt", type=str, required=True,
                   help="face-parsing.PyTorch checkpoint (79999_iter.pth)")
    p.add_argument("--src", type=str, required=True,
                   help="root of per-subject folders (or a flat image dir "
                        "with --flat, the FFHQ case)")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--flat", action="store_true",
                   help="src is a flat folder of images, no subject subdirs")
    p.add_argument("--max_imgs_per_person", type=int, default=-1)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--trash_min_parts", type=int, default=9,
                   help="<= this many parts -> move to trash")
    p.add_argument("--inspect_max_parts", type=int, default=18,
                   help=">= this many parts -> move to inspect")
    p.add_argument("--move_bad", action="store_true",
                   help="actually MOVE bad source images (reference "
                        "behavior); default copies them instead")
    p.add_argument("--device", type=str, default="cuda",
                   help="BiSeNet's device; 'cpu' runs on the host")
    return p.parse_args(argv)


def _list_images(d):
    return sorted(f for f in os.listdir(d)
                  if f.lower().endswith((".jpg", ".jpeg", ".png", ".webp"))
                  and not f.endswith("_mask.png"))


def _save(path: str, img: np.ndarray):
    """uint8 [H, W, 3] or [H, W] -> `path`, PNG without PIL, other formats
    through PIL (by the name's extension, PIL's default settings)."""
    if path.lower().endswith(".png"):
        write_png(path, img)
        return
    from PIL import Image
    Image.fromarray(img).save(path)


def main(argv=None):
    """Returns {'written': image + mask pairs written, 'parts': {distinct
    parts: photos}, 'trash': [...], 'inspect': [...]} (paths under the
    curation folders)."""
    args = parse_args(argv)
    from adaprompt_tpu_torch.models import bisenet

    model = bisenet.load(args.bisenet_ckpt, device=args.device)

    src = args.src.rstrip("/\\")
    trash = src + "_trash"
    inspect = src + "_inspect"
    subj_dirs = [""] if args.flat else sorted(
        d for d in os.listdir(src) if os.path.isdir(os.path.join(src, d)))

    parts_stats: dict = {}
    moved = {"trash": [], "inspect": []}
    n_done = 0
    for subj in subj_dirs:
        sdir = os.path.join(src, subj) if subj else src
        names = _list_images(sdir)
        if args.max_imgs_per_person > 0:
            names = names[: args.max_imgs_per_person]
        for i in range(0, len(names), args.batch_size):
            chunk = names[i:i + args.batch_size]
            imgs = []
            for name in chunk:
                mode, px, palette = read_image_mode(os.path.join(sdir, name))
                imgs.append(pil_bilinear_rgb(mode, px, PARSE_SIZE, PARSE_SIZE, palette))
            parsing = bisenet.parse_faces(model, imgs)    # [b, 512, 512]
            for name, img, par in zip(chunk, imgs, parsing):
                n_parts = len(np.unique(par))
                parts_stats[n_parts] = parts_stats.get(n_parts, 0) + 1
                if n_parts <= args.trash_min_parts:
                    kind, dst = "trash", os.path.join(trash, subj)
                elif n_parts >= args.inspect_max_parts:
                    kind, dst = "inspect", os.path.join(inspect, subj)
                else:
                    kind = dst = None
                if dst is not None:
                    os.makedirs(dst, exist_ok=True)
                    op = shutil.move if args.move_bad else shutil.copy
                    op(os.path.join(sdir, name), os.path.join(dst, name))
                    moved[kind].append(os.path.join(dst, name))
                    continue
                odir = os.path.join(args.out, subj)
                os.makedirs(odir, exist_ok=True)
                _save(os.path.join(odir, name), img)
                mask = ((par != 0) * 255).astype(np.uint8)
                stem = os.path.splitext(name)[0]
                write_png(os.path.join(odir, stem + "_mask.png"), mask)
                n_done += 1
            if n_done and n_done % 100 < args.batch_size:
                print(f"{n_done} done; parts histogram: "
                      f"{dict(sorted(parts_stats.items()))}")
    print(f"wrote {n_done} image+mask pairs to {args.out}; "
          f"parts histogram: {dict(sorted(parts_stats.items()))}")
    return {"written": n_done, "parts": dict(sorted(parts_stats.items())), **moved}


if __name__ == "__main__":
    main()
