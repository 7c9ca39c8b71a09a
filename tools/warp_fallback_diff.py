#!/usr/bin/env python3
"""How far the JAX package's two alignment warps lie apart, and where the
port's warp stands.

`adaprompt_tpu/eval/face_detect.warp_affine` calls OpenCV's `warpAffine`
(INTER_LINEAR, border 0) when cv2 imports and falls back to
`warp_affine_np` when it does not; the port's `eval/face_detect.warp_affine`
redoes OpenCV 5.0's arithmetic on numpy. For seeded noise photos and
similarity fits onto the ArcFace template whose 112x112 crop stays inside
the photo or leaves it, this prints for each case the values (of 112 x 112 x
3) where the numpy fallback and the port differ from cv2, their largest
difference in levels, and the pixels cv2 fills with 0.

    python3 tools/warp_fallback_diff.py [--cases 4]

It needs cv2; it imports the JAX package's numpy-only module (no jax).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def case(seed, leaves, h=200, w=180):
    """The photo and the forward matrix of the tests' `_warp_case`."""
    from adaprompt_tpu.eval import face_detect as jfd
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    src = rng.uniform([40, 40], [w - 40, h - 40], (5, 2))
    if leaves:
        src = (src - src.mean(0)) * 0.4 + rng.uniform([-10, -10], [w + 10, h + 10])
    else:
        src = (src - src.mean(0)) * 0.25 + [w / 2, h / 2]
    return img, jfd.umeyama_similarity(src.astype(np.float32), jfd.ARCFACE_TEMPLATE)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cases", type=int, default=4)
    args = p.parse_args(argv)
    import cv2
    from adaprompt_tpu.eval import face_detect as jfd
    from adaprompt_tpu_torch.eval import face_detect as tfd
    print(f"cv2 {cv2.__version__}")
    for leaves in (False, True):
        for seed in range(args.cases):
            img, M = case(seed, leaves)
            ref = cv2.warpAffine(img, M.astype(np.float32), (112, 112),
                                 flags=cv2.INTER_LINEAR).astype(int)
            fallback = np.abs(jfd.warp_affine_np(img, M, 112).astype(int) - ref)
            port = np.abs(tfd.warp_affine(img, M, 112).astype(int) - ref)
            print(f"{'leaves' if leaves else 'inside'} seed {seed}: numpy fallback differs at "
                  f"{int((fallback > 0).sum())} of {ref.size} values (max {int(fallback.max())}"
                  f" levels), the port at {int((port > 0).sum())}; cv2 fills "
                  f"{int((ref == 0).all(axis=-1).sum())} pixels with 0")


if __name__ == "__main__":
    main()
