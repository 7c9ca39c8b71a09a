"""ArcFace identity embeddings and similarity.

Port of `adaprompt_tpu/eval/face_eval.py`: `FaceSimilarityEvaluator`
(face crops through the ArcFace trunk on the device, L2-normalized; it is
also the face embedder of `AdaFacePipeline` and of every CLI), the
detectors behind `make_detector` (RetinaFace and BiSeNet parsing on the
device, `eval/face_detect.py`; an OpenCV cascade, which needs cv2; the
centre crop), `list_images`, `calc_faces_mean_similarity` and
`compare_face_folders`. A detector is a callable image -> list of aligned
crops. Photos on disk are read by `utils/png.read_image`: PNG and `.npy`
need no other package, other formats need PIL.
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


def make_cascade_detector(cascade_xml_path: str, size: int = 112, margin: float = 0.25):
    """Face detection by an OpenCV Haar/LBP cascade file (cv2, imported
    here: a host without it raises ModuleNotFoundError, a cv2 without
    CascadeClassifier, as OpenCV 5's main package, RuntimeError). Returns a detector
    yielding the margined face boxes resized to `size` by cv2, largest face
    first; an empty list when no face is found."""
    import cv2
    if not hasattr(cv2, "CascadeClassifier"):
        raise RuntimeError(f"cv2 {cv2.__version__} has no CascadeClassifier (OpenCV 5 moved the "
                           "cascade detector to opencv-contrib); use 'retinaface:' or 'bisenet:'")
    cascade = cv2.CascadeClassifier(cascade_xml_path)
    if cascade.empty():
        raise ValueError(f"could not load cascade from {cascade_xml_path}")

    def detect(image_np: np.ndarray) -> list[np.ndarray]:
        gray = cv2.cvtColor(np.asarray(image_np), cv2.COLOR_RGB2GRAY)
        faces = cascade.detectMultiScale(gray, scaleFactor=1.1, minNeighbors=4)
        crops = []
        h, w = image_np.shape[:2]
        for (x, y, fw, fh) in sorted(faces, key=lambda f: -f[2] * f[3]):
            m = int(max(fw, fh) * margin)
            x0, y0 = max(x - m, 0), max(y - m, 0)
            x1, y1 = min(x + fw + m, w), min(y + fh + m, h)
            crops.append(cv2.resize(image_np[y0:y1, x0:x1], (size, size),
                                    interpolation=cv2.INTER_LINEAR))
        return crops

    return detect


def make_detector(spec: str | None, size: int = 112, device=None):
    """Detector factory, by the JAX package's specs:
      * 'retinaface:<Resnet50_Final.pth|.onnx>' -> RetinaFace's five
        landmarks aligned onto the ArcFace template (the reference's
        detection, `face_detect.make_retinaface_detector`);
      * 'bisenet:<79999_iter.pth>' -> BiSeNet parsing, landmarks from the
        parts' centroids (`face_detect.make_bisenet_detector`);
      * 'cascade:<xml_path>' -> an OpenCV cascade (needs cv2);
      * 'center_crop' -> the centre crop;
      * None -> 'retinaface:<path>' when $ADAPROMPT_RETINAFACE_CKPT points
        at weights, else 'bisenet:<path>' when $ADAPROMPT_BISENET_CKPT
        does, else the centre crop.
    The RetinaFace and BiSeNet models load onto `device` (CUDA unless told
    otherwise; raises when CUDA is asked for and absent)."""
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
    kind, _, path = spec.partition(":")
    if kind == "retinaface":
        from adaprompt_tpu_torch.eval.face_detect import make_retinaface_detector
        from adaprompt_tpu_torch.models import retinaface
        return make_retinaface_detector(retinaface.load(path, device=device), size=size)
    if kind == "bisenet":
        from adaprompt_tpu_torch.eval.face_detect import make_bisenet_detector
        from adaprompt_tpu_torch.models import bisenet
        return make_bisenet_detector(bisenet.load(path, device=device), size=size)
    if kind == "cascade":
        return make_cascade_detector(path, size=size)
    raise ValueError(f"unknown detector spec {spec!r}; use 'center_crop', "
                     "'retinaface:<pth|onnx>', 'bisenet:<pth_path>' or 'cascade:<xml_path>'")


class FaceSimilarityEvaluator:
    """Embeds face crops with the ArcFace trunk, on the trunk's device."""

    def __init__(self, arcface: af.ArcFace, detector=None):
        """`detector` None: `make_detector(None)`, its models on the
        trunk's device."""
        self.arcface = arcface.eval()
        self.cfg = arcface.cfg
        self.detector = detector or make_detector(None, self.cfg.input_size,
                                                  device=arcface.fc.weight.device)

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


def compare_face_folders(evaluator: FaceSimilarityEvaluator, src_path: str, dst_path: str,
                         src_num_samples: int = -1, dst_num_samples: int = -1):
    """The reference's compare_face_folders_fast: the mean identity
    similarity of the photos of `dst_path` against those of `src_path`.
    Returns (avg_similarity, dst photos with a face, dst photos without)."""
    src_paths = list_images(src_path, src_num_samples)
    dst_paths = list_images(dst_path, dst_num_samples)
    src_embeds = evaluator.embed_folder(src_paths)
    dst_embeds = evaluator.embed_folder(dst_paths)
    avg, _, dst_no_face = calc_faces_mean_similarity(src_embeds, dst_embeds)
    return avg, len(dst_paths) - dst_no_face, dst_no_face
