"""ArcFace identity embeddings and similarity.

Port of the embedder part of `adaprompt_tpu/eval/face_eval.py`:
`FaceSimilarityEvaluator` (face crops through the ArcFace trunk on the
device, L2-normalized; it is also the face embedder of `AdaFacePipeline`),
the centre-crop stand-in detector, `list_images` and
`calc_faces_mean_similarity`. Face detection is a host-side callable
image -> list of crops; the RetinaFace, BiSeNet and OpenCV-cascade
detectors of the JAX package are not ported yet (`make_detector` raises
NotImplementedError for them). The folder-against-folder comparison is
`eval/harness.py`. Photos on disk are read by `utils/png.read_image`: PNG
and `.npy` need no other package, other formats need PIL.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from adaprompt_tpu_torch.models import arcface as af
from adaprompt_tpu_torch.utils.png import read_image

IMG_EXTENSIONS = ("jpg", "jpeg", "png", "bmp")


def list_images(path: str, num_samples: int = -1) -> list[str]:
    """The photos of a folder (by IMG_EXTENSIONS, either case), sorted; the
    last `num_samples` when it is positive. A file path is its own list."""
    if os.path.isfile(path):
        return [path]
    paths = []
    for ext in IMG_EXTENSIONS:
        paths += glob.glob(os.path.join(path, "*" + ext))
        paths += glob.glob(os.path.join(path, "*" + ext.upper()))
    paths = sorted(set(paths))
    if num_samples > 0:
        paths = paths[-num_samples:]
    return paths


def center_crop_detector(image_np: np.ndarray, size: int = 112) -> list[np.ndarray]:
    """Stand-in 'detector': the centre square, resized to `size` by nearest
    index sampling (for hosts without a face detector; fine for photos that
    are already cropped to the face)."""
    h, w = image_np.shape[:2]
    s = min(h, w)
    y0, x0 = (h - s) // 2, (w - s) // 2
    crop = image_np[y0:y0 + s, x0:x0 + s]
    idx = (np.arange(size) * (s / size)).astype(np.int64)
    return [crop[idx][:, idx]]


def make_detector(spec: str | None, size: int = 112):
    """Detector factory, by the JAX package's specs: 'center_crop' -> the
    centre crop; None -> 'retinaface:<path>' when $ADAPROMPT_RETINAFACE_CKPT
    points at weights, else 'bisenet:<path>' when $ADAPROMPT_BISENET_CKPT
    does, else the centre crop. 'retinaface:', 'bisenet:' and 'cascade:'
    detectors are not ported yet and raise NotImplementedError."""
    if spec is None:
        rf_env = os.environ.get("ADAPROMPT_RETINAFACE_CKPT")
        bi_env = os.environ.get("ADAPROMPT_BISENET_CKPT")
        if rf_env and os.path.exists(rf_env):
            spec = f"retinaface:{rf_env}"
        elif bi_env and os.path.exists(bi_env):
            spec = f"bisenet:{bi_env}"
        else:
            spec = "center_crop"
    if spec == "center_crop":
        return lambda image_np: center_crop_detector(image_np, size)
    if spec.split(":", 1)[0] in ("retinaface", "bisenet", "cascade"):
        raise NotImplementedError(f"the {spec.split(':', 1)[0]} face detector is not ported yet")
    raise ValueError(f"unknown detector spec {spec!r}; use 'center_crop', "
                     "'retinaface:<pth|onnx>', 'bisenet:<pth_path>' or 'cascade:<xml_path>'")


class FaceSimilarityEvaluator:
    """Embeds face crops with the ArcFace trunk, on the trunk's device."""

    def __init__(self, arcface: af.ArcFace, detector=None):
        self.arcface = arcface.eval()
        self.cfg = arcface.cfg
        self.detector = detector or make_detector(None, self.cfg.input_size)

    @torch.no_grad()
    def embed_image(self, image_np: np.ndarray) -> np.ndarray:
        """-> [num_faces, F] L2-normalized float32 (possibly empty)."""
        crops = self.detector(image_np)
        if not crops:
            return np.zeros((0, self.cfg.num_features), np.float32)
        p = self.arcface.fc.weight
        x = torch.from_numpy(af.preprocess(np.stack(crops))).to(device=p.device, dtype=p.dtype)
        emb = self.arcface(x).float().cpu().numpy()
        return emb / np.linalg.norm(emb, axis=-1, keepdims=True)

    def embed_folder(self, paths) -> list[np.ndarray]:
        return [self.embed_image(read_image(p)) for p in paths]

    def __call__(self, images_np=None, image_paths=None) -> np.ndarray | None:
        """The face-embedder protocol of AdaFacePipeline: embeddings [N, F]
        over the given photos (at most one face a photo), None when no photo
        shows a face."""
        if image_paths is not None:
            embs = self.embed_folder(image_paths)
        else:
            embs = [self.embed_image(im) for im in images_np]
        embs = [e[0] for e in embs if len(e)]
        return np.stack(embs) if embs else None


def calc_faces_mean_similarity(src_list_embeds, dst_list_embeds):
    """Mean over all (src image, dst image) pairs of the largest face-pair
    cosine; images without a face are skipped. Returns
    (avg_sim, src_no_face, dst_no_face)."""
    src_no_face = sum(1 for e in src_list_embeds if len(e) == 0)
    dst_no_face = sum(1 for e in dst_list_embeds if len(e) == 0)
    sims = []
    for se in src_list_embeds:
        if len(se) == 0:
            continue
        for de in dst_list_embeds:
            if len(de) == 0:
                continue
            sims.append(float((se @ de.T).max()))   # embeddings are normalized
    avg = float(np.mean(sims)) if sims else 0.0
    return avg, src_no_face, dst_no_face
