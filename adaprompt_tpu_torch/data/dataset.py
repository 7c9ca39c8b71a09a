"""The training dataset: subject folders with fg masks, mask-aware
augmentation, per-sample prompt sets, and subject-pinned batch sampling.

Port of `adaprompt_tpu/data/dataset.py` on numpy, with no PIL:
  * folder scan: one folder per subject; `*_mask.png` files are foreground
    masks of the same-stem image;
  * `sample`: image + mask stacked to 4 channels, nearest resize to `size`,
    random horizontal flip, a random downscale (0.7-1.0) with probability
    `scale_p` pasted on a black canvas giving an `aug_mask`, then a random
    shift within the empty margins (margin 12 px);
  * the 4-type prompt set (`data/prompts.py`);
  * `SubjectSampler`: every batch is drawn from ONE subject, subjects sampled
    in proportion to their image counts, non-face subjects skippable;
  * background overlays: with an `overlay_provider` (`data/overlays.py`),
    an example is composited over a background with probability
    `overlay_prob` (its `wds_*` fields); the coin is drawn only when a
    provider is set, as in JAX.

The collate stacks each key that every example has as JAX's does; a key
that only some examples have (the composites' under 0 < overlay_prob < 1)
becomes a list with None where an example lacks it (`has_wds_comp` says
which), where JAX's collate, which reads the first example's keys, drops it
or raises a KeyError. With `num_workers > 0` the provider's draws interleave
across the loader's threads, in JAX as here; batches equal JAX's bit for bit
at `num_workers=0`.

Photos are read through `utils/png.read_image` (PNG and `.npy` on numpy and
zlib; other formats through PIL, where it is installed). The batches are
equal bit for bit to the JAX package's, whose pipeline runs on PIL: the
mask is PIL's `convert("L")` in its integer fixed point (`png.to_grey`) and
the resize picks PIL's source pixels (`_nearest_resize`). Host-side only:
the trainer moves the batches to the device.
"""

from __future__ import annotations

import dataclasses
import os
import random

import numpy as np

from adaprompt_tpu_torch.data.overlays import composite_wds_example
from adaprompt_tpu_torch.data.prompts import generate_prompt_set
from adaprompt_tpu_torch.utils.png import read_image, to_grey

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


@dataclasses.dataclass
class SubjectInfo:
    name: str
    image_paths: list
    fg_mask_paths: list
    is_face: bool = True
    cls_delta_string: str = "person"
    broad_class: int = 1


def scan_subject_folders(data_roots, default_cls_delta_string: str = "person",
                         subject_names: list | None = None) -> list[SubjectInfo]:
    """Each immediate subfolder of each root is one subject; a root that
    itself contains images is a single subject."""
    if isinstance(data_roots, str):
        data_roots = [data_roots]
    subjects = []
    for root in data_roots:
        entries = sorted(os.listdir(root))
        subdirs = [e for e in entries if os.path.isdir(os.path.join(root, e))]
        folders = [(e, os.path.join(root, e)) for e in subdirs] or \
                  [(os.path.basename(os.path.normpath(root)), root)]
        for name, folder in folders:
            if subject_names is not None and name not in subject_names:
                continue
            imgs, masks = [], []
            for f in sorted(os.listdir(folder)):
                p = os.path.join(folder, f)
                stem, ext = os.path.splitext(f)
                if ext.lower() not in IMG_EXTENSIONS or stem.endswith("_mask"):
                    continue
                imgs.append(p)
                mask_p = os.path.join(folder, stem + "_mask.png")
                masks.append(mask_p if os.path.exists(mask_p) else None)
            if imgs:
                subjects.append(SubjectInfo(name, imgs, masks,
                                            cls_delta_string=default_cls_delta_string))
    return subjects


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """The source index of each of n_out pixels under PIL's nearest resize:
    the centre of pixel i at 0.5*r + i*r (r = n_in / n_out), summed in
    float64 one step at a time as PIL's ImagingScaleAffine does, then
    truncated."""
    r = float(n_in) / n_out
    centres = np.add.accumulate(np.concatenate([[r * 0.5], np.full(n_out - 1, r)]))
    return centres.astype(np.int64)


def _nearest_resize(img: np.ndarray, size: int) -> np.ndarray:
    """[H, W, C] -> [size, size, C], the pixels PIL's Image.NEAREST picks."""
    return img[_nearest_index(img.shape[0], size)][:, _nearest_index(img.shape[1], size)]


def _load_image_and_mask(image_path, mask_path, size, rng: random.Random,
                         flip_p: float = 0.5):
    image = read_image(image_path)
    if mask_path is not None:
        fg = to_grey(read_image(mask_path))
        has_fg_mask = True
    else:
        fg = np.full(image.shape[:2], 255, np.uint8)
        has_fg_mask = False
    stacked = np.concatenate([image, fg[..., None]], axis=-1)
    # the nearest resize keeps the mask binary
    stacked = _nearest_resize(stacked, size)
    if rng.random() < flip_p:
        stacked = stacked[:, ::-1]
    return stacked, has_fg_mask


def _random_scale_shift(stacked, rng: random.Random, scale_range=(0.7, 1.0),
                        margin: int = 12):
    """Random downscale pasted on a black canvas + shift within the empty
    margins; returns (stacked, aug_mask)."""
    size = stacked.shape[0]
    s = rng.uniform(*scale_range)
    new = max(8, int(round(size * s)))
    small = _nearest_resize(stacked, new)
    canvas = np.zeros_like(stacked)
    aug = np.zeros(stacked.shape[:2], np.uint8)
    off = (size - new) // 2
    canvas[off:off + new, off:off + new] = small
    aug[off:off + new, off:off + new] = 1

    top0 = bottom0 = left0 = right0 = off
    dy = dx = 0
    if top0 + bottom0 > 2 * margin:
        dy = rng.randint(0, top0 + bottom0 - 2 * margin)
        if dy > bottom0 - margin:
            dy = -(dy - bottom0 + margin)
    if left0 + right0 > 2 * margin:
        dx = rng.randint(0, left0 + right0 - 2 * margin)
        if dx > right0 - margin:
            dx = -(dx - right0 + margin)
    canvas = np.roll(canvas, (dy, dx), axis=(0, 1))
    aug = np.roll(aug, (dy, dx), axis=(0, 1))
    return canvas, aug


class PersonalizedDataset:
    def __init__(self, subjects: list[SubjectInfo], size: int = 512,
                 flip_p: float = 0.5, scale_p: float = 0.5,
                 subject_string: str = "z", background_string: str | None = "y",
                 num_vectors_per_subj_token: int = 16,
                 num_vectors_per_bg_token: int = 4,
                 num_compositions_per_image: int = 1,
                 seed: int | None = None,
                 overlay_provider=None, overlay_prob: float = 0.0):
        assert subjects, "no subjects found"
        self.overlay_provider = overlay_provider
        self.overlay_prob = overlay_prob
        self.subjects = subjects
        self.size = size
        self.flip_p = flip_p
        self.scale_p = scale_p
        self.subject_string = subject_string
        self.background_string = background_string
        self.num_vectors_per_subj_token = num_vectors_per_subj_token
        self.num_vectors_per_bg_token = num_vectors_per_bg_token
        self.num_compositions_per_image = num_compositions_per_image
        self.rng = random.Random(seed)

    @property
    def num_images(self):
        return sum(len(s.image_paths) for s in self.subjects)

    def sample(self, subject_idx: int, rng: random.Random | None = None) -> dict:
        """One example of subject `subject_idx`; `rng` overrides the
        dataset's stream (each loader batch passes its own)."""
        rng = rng or self.rng
        subj = self.subjects[subject_idx]
        i = rng.randrange(len(subj.image_paths))
        stacked, has_fg_mask = _load_image_and_mask(
            subj.image_paths[i], subj.fg_mask_paths[i], self.size, rng,
            self.flip_p)
        if rng.random() < self.scale_p:
            stacked, aug_mask = _random_scale_shift(stacked, rng)
        else:
            aug_mask = np.ones(stacked.shape[:2], np.uint8)

        image = stacked[..., :3]
        fg_mask = (stacked[..., 3] / 255.0 > 0.5).astype(np.uint8)

        ex = {
            "image": image.astype(np.float32) / 127.5 - 1.0,   # [-1, 1]
            "image_unnorm": image,
            "fg_mask": fg_mask,
            "aug_mask": aug_mask,
            "has_fg_mask": has_fg_mask,
            "image_path": subj.image_paths[i],
            "subject_name": subj.name,
            "is_face": subj.is_face,
        }
        ex.update(generate_prompt_set(
            self.subject_string, subj.cls_delta_string,
            background_string=self.background_string,
            cls_bg_delta_string="background" if self.background_string else None,
            num_vectors_per_subj_token=self.num_vectors_per_subj_token,
            num_vectors_per_bg_token=self.num_vectors_per_bg_token,
            broad_class=subj.broad_class, is_animal=True,
            num_compositions_per_image=self.num_compositions_per_image,
            rng=rng))

        # the background-overlay fields, composited with overlay_prob
        ex["has_wds_comp"] = False
        ex["wds_caption"] = ex["caption"]
        ex["wds_caption_bg"] = ex["caption_bg"]
        ex["wds_comp_extra"] = ""
        if (self.overlay_provider is not None
                and rng.random() < self.overlay_prob):
            bg = self.overlay_provider.sample()
            if bg is not None:
                ex = composite_wds_example(ex, bg[0], bg[1], subj.cls_delta_string)
        return ex


class SubjectSampler:
    """Subject indices for batches; each batch is one subject, sampled
    proportionally to image count; non-face subjects skipped by default."""

    def __init__(self, subjects: list[SubjectInfo], skip_non_faces: bool = True,
                 seed: int | None = None):
        self.subjects = subjects
        self.skip_non_faces = skip_non_faces
        counts = np.array([len(s.image_paths) for s in subjects], np.float64)
        self.weights = counts / counts.sum()
        self.rng = np.random.default_rng(seed)

    def next_subject(self) -> int:
        while True:
            idx = int(self.rng.choice(len(self.subjects), p=self.weights))
            if not self.skip_non_faces or self.subjects[idx].is_face:
                return idx


def _collate(examples: list, subj_idx: int) -> dict:
    """Every example's keys, in the order they first appear: stacked (strings
    and flags as lists) where all examples have the key, else a list with
    None for the examples without it."""
    batch = {}
    for k in dict.fromkeys(k for e in examples for k in e):
        if not all(k in e for e in examples):
            batch[k] = [e.get(k) for e in examples]
            continue
        vals = [e[k] for e in examples]
        batch[k] = vals if isinstance(vals[0], (str, bool)) else np.stack(vals)
    batch["subject_idx"] = subj_idx
    return batch


def make_batch_iterator(dataset: PersonalizedDataset, sampler: SubjectSampler,
                        batch_size: int, num_workers: int = 0,
                        prefetch: int = 4):
    """Yields collated numpy batches; one subject per batch (the
    SubjectSampler contract).

    num_workers > 0 runs the decode/augment pipeline in a thread pool with
    a bounded prefetch queue, so that the device does not wait on image IO
    (zlib and numpy release the GIL for the heavy work). Each batch takes a
    random.Random of its own, seeded from the dataset's stream plus its
    index, so batch order and contents are the same for any num_workers > 0
    (subject indices are drawn on the producer side, in order)."""
    if num_workers <= 0:
        while True:
            subj_idx = sampler.next_subject()
            yield _collate([dataset.sample(subj_idx)
                            for _ in range(batch_size)], subj_idx)
        return

    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    pool_sem = threading.Semaphore(num_workers)
    stop = threading.Event()

    def make_batch(subj_idx, seed):
        try:
            rng = random.Random(seed)  # per-batch rng: no cross-thread races
            return _collate([dataset.sample(subj_idx, rng=rng)
                             for _ in range(batch_size)], subj_idx)
        finally:
            pool_sem.release()

    def producer():
        import concurrent.futures as cf
        base_seed = dataset.rng.randrange(2 ** 31)
        counter = 0
        with cf.ThreadPoolExecutor(max_workers=num_workers) as ex:
            while not stop.is_set():
                pool_sem.acquire()
                if stop.is_set():
                    break
                subj_idx = sampler.next_subject()
                fut = ex.submit(make_batch, subj_idx, base_seed + counter)
                counter += 1
                q.put(fut)  # futures queued in order -> deterministic order

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            yield q.get().result()
    finally:
        stop.set()
        pool_sem.release()
        while not q.empty():  # drain so the producer can exit
            try:
                q.get_nowait()
            except queue.Empty:
                break
