"""Face detection and alignment: the geometry behind the RetinaFace and
BiSeNet detectors.

Port of `adaprompt_tpu/eval/face_detect.py`, on numpy (no `scipy.ndimage`,
no `cv2`):

  * a parsing detector: 19-class labels at 512x512 -> face regions (classes
    1..13) as 4-connected components, largest bounding box first, speckle
    dropped -> landmarks from the parts' centroids (eyes, nose, mouth) ->
    a least-squares similarity onto insightface's 112x112 ArcFace template
    -> the warped crop; a margined square crop where the parts are hidden;
  * a RetinaFace detector: the model's own five regressed landmarks -> the
    same similarity and warp (insightface's `norm_crop`).

`warp_affine` is `cv2.warpAffine(image, M.astype(float32), (size, size),
flags=INTER_LINEAR)` of OpenCV 5.0 redone on numpy, bit for bit on the
cases tested: M inverted in float64, each output pixel mapped in float32
(in OpenCV's blocks of 16 pixels, each row's term y*M[1] + M[2] rounded to
float32, then one fused multiply-add with x*M[0]; past the last block,
fma(x, M[0], y*M[1]) + M[2]), a bilinear blend in float32 by fused
multiply-adds, every neighbour outside the image read as 0, the result
rounded half to even. The JAX package calls cv2 where it is installed and
falls back to a numpy warp that truncates and clamps to the edge; the port
has only this one.
"""

from __future__ import annotations

import numpy as np

# zllrunning face-parsing.PyTorch class ids
CLS_SKIN, CLS_L_BROW, CLS_R_BROW = 1, 2, 3
CLS_L_EYE, CLS_R_EYE, CLS_GLASSES = 4, 5, 6
CLS_L_EAR, CLS_R_EAR, CLS_EAR_RING = 7, 8, 9
CLS_NOSE, CLS_MOUTH, CLS_U_LIP, CLS_L_LIP = 10, 11, 12, 13
FACE_CLASSES = tuple(range(1, 14))          # everything that is "a face"
MOUTH_CLASSES = (CLS_MOUTH, CLS_U_LIP, CLS_L_LIP)

# insightface arcface_dst template (112x112, norm_crop)
ARCFACE_TEMPLATE = np.array(
    [[38.2946, 51.6963], [73.5318, 51.5014], [56.0252, 71.7366],
     [41.5493, 92.3655], [70.7299, 92.2041]], np.float32)   # (x, y)


def _runs(mask: np.ndarray):
    """The horizontal runs of True in `mask` [H, W], in raster order:
    (row, start, stop) int64 arrays."""
    h, w = mask.shape
    padded = np.zeros((h, w + 2), np.int8)
    padded[:, 1:-1] = mask
    edges = np.diff(padded, axis=1)               # +1 where a run starts, -1 past its end
    rs, cs = np.nonzero(edges == 1)
    re, ce = np.nonzero(edges == -1)
    return rs, cs, ce


def _run_components(rows, starts, stops, width):
    """Component of each run under 4-connectivity: runs of adjacent rows
    join where their columns overlap. Returns each run's root, the smallest
    run index of its component (so roots follow raster order)."""
    n = len(rows)
    parent = np.arange(n)
    if n == 0:
        return parent
    key_start = rows * (width + 1) + starts
    key_stop = rows * (width + 1) + stops
    # the runs of row r - 1 that overlap run b = [s, e) of row r: stop > s and start < e
    lo = np.searchsorted(key_stop, (rows - 1) * (width + 1) + starts, side="right")
    hi = np.searchsorted(key_start, (rows - 1) * (width + 1) + stops, side="left")
    counts = np.maximum(hi - lo, 0)
    b = np.repeat(np.arange(n), counts)
    a = np.repeat(lo, counts) + (np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts,
                                                                      counts))
    while True:                                   # hook each edge's larger root onto its smaller
        ra, rb = parent[a], parent[b]
        lo, hi = np.minimum(ra, rb), np.maximum(ra, rb)
        joined = lo != hi
        if not joined.any():
            return parent
        np.minimum.at(parent, hi[joined], lo[joined])
        while True:                               # then jump every run to its root
            up = parent[parent]
            if np.array_equal(up, parent):
                break
            parent = up


def face_components(parsing: np.ndarray, min_area_frac: float = 0.002):
    """Per-face bboxes from a parsing map.

    parsing: [H, W] int labels. Returns a list of (y0, x0, y1, x1)
    (exclusive upper bounds), largest box area first (ties in raster order
    of the components' first pixels, as `scipy.ndimage.label` numbers
    them); components whose box is below `min_area_frac` of the image are
    dropped (parsing speckle)."""
    mask = np.isin(parsing, FACE_CLASSES)
    h, w = parsing.shape
    rows, starts, stops = _runs(mask)
    roots = _run_components(rows, starts, stops, w)
    order = np.argsort(roots, kind="stable")      # components by root: raster order
    first = np.flatnonzero(np.diff(roots[order], prepend=-1))
    boxes = np.stack([np.minimum.reduceat(rows[order], first),
                      np.minimum.reduceat(starts[order], first),
                      np.maximum.reduceat(rows[order], first) + 1,
                      np.maximum.reduceat(stops[order], first)], axis=1) if len(order) else []
    out = []
    for y0, x0, y1, x1 in (tuple(int(v) for v in bb) for bb in boxes):
        if (y1 - y0) * (x1 - x0) < min_area_frac * h * w:
            continue
        out.append((y0, x0, y1, x1))
    out.sort(key=lambda bb: -(bb[2] - bb[0]) * (bb[3] - bb[1]))
    return out


def _centroid(parsing, classes, bbox):
    y0, x0, y1, x1 = bbox
    sub = parsing[y0:y1, x0:x1]
    ys, xs = np.nonzero(np.isin(sub, classes))
    if len(ys) < 4:                  # too few pixels to trust
        return None
    return np.array([x0 + xs.mean(), y0 + ys.mean()], np.float32)  # (x, y)


def landmarks_from_parsing(parsing: np.ndarray, bbox):
    """Landmarks (x, y) from part centroids: [l_eye, r_eye, nose, mouth,
    mouth] (the mouth corners collapsed to the mouth centroid). None when
    the eyes (or glasses) or the mouth are not visible. The eyes are ordered
    by image x, so the parser's left/right convention cannot flip the
    alignment; glasses hiding both eyes are split at their centroid."""
    e1 = _centroid(parsing, (CLS_L_EYE,), bbox)
    e2 = _centroid(parsing, (CLS_R_EYE,), bbox)
    if e1 is None or e2 is None:
        g = _centroid(parsing, (CLS_GLASSES,), bbox)
        if g is None:
            return None
        y0, x0, y1, x1 = bbox
        sub = parsing[y0:y1, x0:x1]
        ys, xs = np.nonzero(sub == CLS_GLASSES)
        left = xs + x0 <= g[0]
        if left.sum() < 4 or (~left).sum() < 4:
            return None
        e1 = np.array([(xs[left] + x0).mean(), (ys[left] + y0).mean()], np.float32)
        e2 = np.array([(xs[~left] + x0).mean(), (ys[~left] + y0).mean()], np.float32)
    if e1[0] > e2[0]:
        e1, e2 = e2, e1
    nose = _centroid(parsing, (CLS_NOSE,), bbox)
    mouth = _centroid(parsing, MOUTH_CLASSES, bbox)
    if mouth is None:
        return None
    if nose is None:
        nose = (e1 + e2) / 2 * 0.5 + mouth * 0.5
    return np.stack([e1, e2, nose, mouth, mouth])


def umeyama_similarity(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares similarity transform (scale+rot+shift) src -> dst, in
    float64. src/dst: [N, 2]. Returns a 2x3 affine matrix."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    ms, md = src.mean(0), dst.mean(0)
    s0, d0 = src - ms, dst - md
    cov = d0.T @ s0 / len(src)
    u, s, vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(u) * np.linalg.det(vt))
    diag = np.diag([1.0, d])
    var_s = (s0 ** 2).sum() / len(src)
    scale = np.trace(np.diag(s) @ diag) / (var_s + 1e-12)
    R = u @ diag @ vt
    M = np.zeros((2, 3))
    M[:, :2] = scale * R
    M[:, 2] = md - scale * R @ ms
    return M


def _fma32(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once (the product of two float32 values is
    exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def warp_affine(image: np.ndarray, M: np.ndarray, size: int) -> np.ndarray:
    """Bilinear warp of uint8 `image` [H, W] or [H, W, C] by the 2x3 forward
    matrix M onto (size, size): OpenCV 5.0's `warpAffine(image,
    M.astype(float32), (size, size), flags=INTER_LINEAR)` (border 0)."""
    m = np.asarray(M, np.float32).astype(np.float64).reshape(6)
    det = m[0] * m[4] - m[1] * m[3]            # invertAffineTransform, in float64
    det = 1.0 / det if det != 0 else 0.0
    a11, a22 = m[4] * det, m[0] * det
    m[0], m[1], m[3], m[4] = a11, -m[1] * det, -m[3] * det, a22
    m[2], m[5] = -m[0] * m[2] - m[1] * m[5], -m[3] * m[2] - m[4] * m[5]
    f = m.astype(np.float32)
    grid = np.arange(size, dtype=np.float32)
    ys, xs = grid[:, None], grid[None, :]
    # OpenCV maps blocks of 16 pixels of a row as fma(M[0], x, y*M[1] + M[2])
    # and the row's last size % 16 pixels as fma(x, M[0], y*M[1]) + M[2]
    sx = _fma32(f[0], xs, ys * f[1] + f[2])     # [size, size]
    sy = _fma32(f[3], xs, ys * f[4] + f[5])
    tail = (size // 16) * 16
    sx[:, tail:] = _fma32(xs[:, tail:], f[0], ys * f[1]) + f[2]
    sy[:, tail:] = _fma32(xs[:, tail:], f[3], ys * f[4]) + f[5]
    ix, iy = np.floor(sx), np.floor(sy)
    alpha, beta = sx - ix, sy - iy
    ix, iy = ix.astype(np.int64), iy.astype(np.int64)
    h, w = image.shape[:2]
    img = np.asarray(image).reshape(h, w, -1).astype(np.float32)

    def pixel(yy, xx):
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        return np.where(inside[..., None], v, np.float32(0))

    p00, p01 = pixel(iy, ix), pixel(iy, ix + 1)
    p10, p11 = pixel(iy + 1, ix), pixel(iy + 1, ix + 1)
    alpha, beta = alpha[..., None], beta[..., None]
    top = _fma32(alpha, p01 - p00, p00)
    bottom = _fma32(alpha, p11 - p10, p10)
    out = np.clip(np.rint(_fma32(beta, bottom - top, top)), 0, 255).astype(np.uint8)
    return out.reshape((size, size) + image.shape[2:])


def crop_square(image: np.ndarray, bbox, size: int, margin: float = 0.3):
    """Margined square bbox crop resized to (size, size) by nearest index
    sampling: the alignment fallback."""
    h, w = image.shape[:2]
    y0, x0, y1, x1 = bbox
    cy, cx = (y0 + y1) / 2, (x0 + x1) / 2
    half = max(y1 - y0, x1 - x0) * (1 + 2 * margin) / 2
    yy0, yy1 = int(max(cy - half, 0)), int(min(cy + half, h))
    xx0, xx1 = int(max(cx - half, 0)), int(min(cx + half, w))
    crop = image[yy0:yy1, xx0:xx1]
    if crop.size == 0:
        return None
    idy = np.clip((np.arange(size) * (crop.shape[0] / size)), 0,
                  crop.shape[0] - 1).astype(np.int64)
    idx = np.clip((np.arange(size) * (crop.shape[1] / size)), 0,
                  crop.shape[1] - 1).astype(np.int64)
    return crop[idy][:, idx]


def make_parsing_detector(parse_fn, size: int = 112, parse_size: int = 512,
                          max_faces: int = 4):
    """A detector from a parsing callable.

    parse_fn: uint8 [B, parse_size, parse_size, 3] -> labels
    [B, parse_size, parse_size] (e.g. `bisenet.parse_faces` bound to a
    model). Returns detect(image_np) -> a list of aligned [size, size, 3]
    uint8 crops, largest face first (the detector protocol of
    `eval.face_eval.FaceSimilarityEvaluator`)."""
    def detect(image_np: np.ndarray):
        image_np = np.asarray(image_np)
        h, w = image_np.shape[:2]
        # nearest resize to the parser's resolution
        idy = (np.arange(parse_size) * (h / parse_size)).astype(np.int64)
        idx = (np.arange(parse_size) * (w / parse_size)).astype(np.int64)
        small = image_np[idy][:, idx]
        parsing = np.asarray(parse_fn(small[None]))[0]
        sy, sx = h / parse_size, w / parse_size

        crops = []
        for bbox in face_components(parsing)[:max_faces]:
            pts = landmarks_from_parsing(parsing, bbox)
            if pts is not None:
                pts_img = pts * np.array([[sx, sy]], np.float32)     # parse space -> image
                M = umeyama_similarity(pts_img, ARCFACE_TEMPLATE)
                crops.append(warp_affine(image_np, M, size))
            else:
                y0, x0, y1, x1 = bbox
                bb = (int(y0 * sy), int(x0 * sx), int(y1 * sy), int(x1 * sx))
                crop = crop_square(image_np, bb, size)
                if crop is not None:
                    crops.append(crop)
        return crops

    return detect


def make_bisenet_detector(model, size: int = 112):
    """A parsing detector over the port's BiSeNet (`models/bisenet.py`),
    which parses on its own device."""
    from adaprompt_tpu_torch.models import bisenet
    return make_parsing_detector(lambda batch: bisenet.parse_faces(model, batch), size=size)


def make_retinaface_detector(model, size: int = 112, score_thresh: float = 0.5,
                             max_faces: int = 4):
    """A detector over the port's RetinaFace (`models/retinaface.py`): the
    model's five regressed landmarks of each face, highest score first,
    aligned onto the ArcFace template (insightface's `norm_crop`)."""
    from adaprompt_tpu_torch.models import retinaface as rf

    def detect(image_np: np.ndarray):
        image_np = np.asarray(image_np)
        boxes, scores, landms = rf.detect_faces(model, image_np, score_thresh=score_thresh)
        crops = []
        for i in range(min(len(scores), max_faces)):
            M = umeyama_similarity(landms[i].astype(np.float32), ARCFACE_TEMPLATE)
            crops.append(warp_affine(image_np, M, size))
        return crops

    return detect
