"""Background-overlay composition ("wds" overlays).

Port of `adaprompt_tpu/data/overlays.py`, the role of the reference
dataset's webdataset overlay path: a stream of (background image, caption)
pairs is filtered (caption long enough, no humans or animals, no special
tokens, acceptable aspect ratio and size), centre-fit to the training
resolution, and the subject's foreground is pasted over the background; the
prompts gain an ", in front of <bg caption>" suffix.

The source is a folder of images with sidecar .txt captions, or a .tar
archive of {key}.jpg / {key}.txt pairs, read with the stdlib tarfile (no
webdataset). PNG files and bytes are decoded by `utils/png`, other formats
by PIL, imported only for them; the shorter edge is scaled by
`utils/resize.pil_bicubic`, equal to PIL's BICUBIC. So the backgrounds, the
draws of `np.random.default_rng(seed)` and the composites are those of the
JAX package, bit for bit. Host-side only.
"""

from __future__ import annotations

import io
import os
import re
import tarfile

import numpy as np

from adaprompt_tpu_torch.utils.png import decode_png
from adaprompt_tpu_torch.utils.resize import pil_bicubic

HUMAN_ANIMAL_PAT = re.compile(
    r"\b(man|men|woman|women|person|people|human|boy|girl|child|children|kid|"
    r"baby|face|portrait|dog|cat|bird|horse|animal)\b")
IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".webp")
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _decode(data: bytes, name: str) -> np.ndarray:
    """Image bytes -> uint8 [H, W, 3], as PIL's convert("RGB"): a PNG
    through `png.decode_png`, any other format through PIL (imported only
    here; without PIL such an image raises)."""
    if data[:8] == _PNG_SIGNATURE:
        return decode_png(data, name)
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"{name}: decoding this background needs PIL, which is not "
                           "installed here; convert the backgrounds to .png") from None
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


class BackgroundOverlayProvider:
    """Iterates filtered (bg_image [size, size, 3] uint8, caption) pairs."""

    def __init__(self, source: str, size: int = 512, seed: int | None = None,
                 special_strings=("z", "y")):
        self.source = source
        self.size = size
        self.special_pat = re.compile(
            r"\b(" + "|".join(re.escape(s) for s in special_strings) + r")\b")
        self.rng = np.random.default_rng(seed)
        self._items = None

    def _load_items(self):
        """(image bytes or path, caption) of every image, in name order."""
        items = []
        if self.source.endswith(".tar"):
            with tarfile.open(self.source) as tf:
                members = {m.name: m for m in tf.getmembers() if m.isfile()}
                for name in sorted(members):
                    stem, ext = os.path.splitext(name)
                    if ext.lower() in IMAGE_EXTENSIONS:
                        cap = ""
                        if stem + ".txt" in members:
                            cap = tf.extractfile(members[stem + ".txt"]).read().decode().strip()
                        items.append((tf.extractfile(members[name]).read(), cap))
        else:
            for f in sorted(os.listdir(self.source)):
                stem, ext = os.path.splitext(f)
                if ext.lower() in IMAGE_EXTENSIONS:
                    cap_path = os.path.join(self.source, stem + ".txt")
                    cap = ""
                    if os.path.exists(cap_path):
                        with open(cap_path) as fh:
                            cap = fh.read().strip()
                    items.append((os.path.join(self.source, f), cap))
        self._items = items

    def _accept(self, caption: str, w: int, h: int) -> bool:
        caption = caption.lower()
        if len(caption.strip()) < 5:
            return False
        if self.special_pat.search(caption) or HUMAN_ANIMAL_PAT.search(caption):
            return False
        ratio = w / h
        if not (0.75 <= ratio < 1.34):
            return False
        if max(self.size / h, self.size / w) >= 1.3:
            return False
        return True

    def sample(self, max_tries: int = 50):
        """-> (bg_image [size, size, 3] uint8, caption) or None: up to
        `max_tries` draws of an item, the first accepted one centre-fit
        (the shorter edge scaled to `size` by PIL's bicubic, then the
        centre crop)."""
        if self._items is None:
            self._load_items()
        if not self._items:
            return None
        for _ in range(max_tries):
            src, cap = self._items[int(self.rng.integers(len(self._items)))]
            if isinstance(src, bytes):
                img = _decode(src, self.source)
            else:
                with open(src, "rb") as fh:
                    img = _decode(fh.read(), src)
            h, w = img.shape[:2]
            if not self._accept(cap, w, h):
                continue
            scale = self.size / min(w, h)
            img = pil_bicubic(img, int(round(h * scale)), int(round(w * scale)))
            h2, w2 = img.shape[:2]
            left, top = (w2 - self.size) // 2, (h2 - self.size) // 2
            return np.ascontiguousarray(img[top:top + self.size, left:left + self.size]), cap
        return None


def composite_wds_example(example: dict, bg_image: np.ndarray, bg_caption: str,
                          cls_delta_string: str) -> dict:
    """Fill the wds_* example fields: the subject's foreground pasted over
    the background, and the prompts extended."""
    image_uint8 = example["image_unnorm"]
    fg_mask = example["fg_mask"]
    wds_image = np.where(fg_mask[:, :, None] > 0, image_uint8, bg_image)
    extra = ", in front of " + bg_caption.lower()
    cls_extra = " " + cls_delta_string + extra
    example = dict(example)
    example.update({
        "wds_comp_extra": extra,
        "wds_cls_comp_extra": cls_extra,
        "wds_caption": example["caption"] + extra,
        "wds_cls_caption": example["caption"] + cls_extra,
        "wds_caption_bg": example["caption_bg"] + extra,
        "wds_cls_caption_bg": example["caption_bg"] + cls_extra,
        "wds_image": (wds_image / 127.5 - 1.0).astype(np.float32),
        "wds_image_bgonly": (bg_image / 127.5 - 1.0).astype(np.float32),
        "wds_aug_mask": example["aug_mask"],
        "has_wds_comp": True,
    })
    return example
