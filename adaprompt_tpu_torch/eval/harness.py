"""Folder-level evaluation: CLIP image and text similarity, DINO similarity
and ArcFace identity similarity between a folder of reference photos and a
folder of generated samples.

Port of `adaprompt_tpu/eval/harness.py` (the reference's compare_folders,
evaluation/eval_utils.py, and the scoring loop of
scripts/gen_subjects_and_eval.py). The loaders read each image through
`utils/png.read_image` as RGB (alpha dropped, grey repeated: PIL's
`convert("RGB")`) and resize it with PIL's bicubic redone on numpy
(`utils/resize.pil_bicubic`), so their arrays equal the JAX package's PIL
loaders' bit for bit; PIL is not imported.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from adaprompt_tpu_torch.eval.face_eval import (FaceSimilarityEvaluator,
                                                calc_faces_mean_similarity, list_images)
from adaprompt_tpu_torch.utils.png import read_image
from adaprompt_tpu_torch.utils.resize import pil_bicubic


@dataclasses.dataclass
class FolderScores:
    sim_img: float
    sim_text: float
    sim_dino: float
    sim_face: float | None = None


def load_images_uint8(paths, size: int = 256) -> list[np.ndarray]:
    """Each image as uint8 [size, size, 3]."""
    return [pil_bicubic(read_image(p), size, size) for p in paths]


def load_images_pm1(paths, size: int = 256) -> np.ndarray:
    """The images as [-1, 1] float32 [N, size, size, 3] (the training
    images' scaling)."""
    return np.stack([np.asarray(img, np.float32) / 127.5 - 1.0
                     for img in load_images_uint8(paths, size)])


def compare_folders(clip_scorer, dino_evaluator, gt_dir: str, samples_dir: str,
                    prompt: str, num_samples: int = -1,
                    face_evaluator: FaceSimilarityEvaluator | None = None) -> FolderScores:
    """The scores of the samples of `samples_dir` (the last `num_samples`
    when positive) against the photos of `gt_dir` (its `*_mask.png` files
    left out); `sim_face` only with a face evaluator."""
    gt_paths = [p for p in list_images(gt_dir) if not p.endswith("_mask.png")]
    sample_paths = list_images(samples_dir, num_samples)

    sim_img, sim_text = clip_scorer.evaluate(load_images_pm1(sample_paths),
                                             load_images_pm1(gt_paths), prompt)
    sim_dino = float(dino_evaluator.image_pairwise_similarity(
        load_images_uint8(gt_paths), load_images_uint8(sample_paths)))
    sim_face = None
    if face_evaluator is not None:
        sim_face, _, _ = calc_faces_mean_similarity(face_evaluator.embed_folder(gt_paths),
                                                    face_evaluator.embed_folder(sample_paths))
    return FolderScores(sim_img, sim_text, sim_dino, sim_face)
