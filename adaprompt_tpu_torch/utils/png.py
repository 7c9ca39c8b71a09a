"""PNG files on zlib alone (the card's machine has no PIL), and an image
reader for the formats that need no other package.

The writer makes 8-bit RGB or grey, every scanline with filter 0, one
IDAT chunk, CRCs from zlib.crc32. The decoder reads any non-interlaced
8-bit PNG (grey, grey + alpha, RGB, RGBA, palette; scanline filters 0-4)
and 1-, 2- and 4-bit grey and palette ones and checks every chunk's CRC.
`decode_png_mode` returns the pixels in the mode PIL opens the file in
('1', 'L', 'LA', 'RGB', 'RGBA', 'P' with its palette; a sub-byte grey level
scaled to 0..255); `decode_png` returns uint8 [H, W, 3]: alpha is dropped,
grey is repeated over the three channels and a palette is looked up, as
PIL's `convert("RGB")` does. `read_image` takes `.png` through the decoder,
`.npy` through numpy, and any other format through PIL where PIL is
installed. `to_grey` is PIL's `convert("L")` of such an image.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel (0 grey, 2 RGB, 3 palette, 4 grey + alpha, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W, 3] (RGB) or [H, W] (grey, PIL's mode 'L') -> the bytes
    of a PNG file."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"expected uint8 [H, W, 3] or [H, W], got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else 3
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * ch)], axis=1)
    color = 0 if ch == 1 else 2
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)    # 8-bit, no interlace
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes())) + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> str:
    with open(path, "wb") as f:
        f.write(encode_png(img))
    return path


def _chunks(data: bytes, name: str):
    """(tag, body) of every chunk up to IEND, each CRC checked."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise ValueError(f"{name}: chunk {tag!r} is cut short")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{name}: bad CRC in chunk {tag!r}")
        yield tag, body
        if tag == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{name}: no IEND chunk")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int, name: str) -> np.ndarray:
    """Undo the scanline filters: [H, stride] uint8 samples."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"{name}: {rows.size} bytes of image data, expected {h * (stride + 1)}")
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:       # Sub: a running sum over the pixels, per sample, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:       # Up
            cur = line + prev
        elif ftype in (3, 4):  # Average, Paeth: each byte needs the one bpp before it
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    cur[i] = (cur[i] + ((a + up[i]) >> 1)) & 0xFF
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    cur[i] = (cur[i] + _paeth(a, up[i], c)) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"{name}: unknown scanline filter {ftype} in row {y}")
        out[y] = cur
        prev = out[y]
    return out


def decode_png_mode(data: bytes, name: str = "PNG"):
    """The bytes of a PNG -> (PIL's mode of it, uint8 pixels, palette):
    '1' and 'L' [H, W] (0/255 and grey levels), 'LA' [H, W, 2], 'RGB'
    [H, W, 3], 'RGBA' [H, W, 4], or 'P' [H, W] indices into the palette
    [n, 3] (None for every other mode)."""
    hdr, palette, idat = None, None, []
    for tag, body in _chunks(data, name):
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
    if hdr is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = hdr
    if color not in _CHANNELS or not (depth == 8 or (depth in (1, 2, 4) and color in (0, 3))):
        raise ValueError(f"{name}: bit depth {depth}, colour type {color}; only 8-bit grey, "
                         "grey + alpha, RGB, RGBA and palette images and 1-, 2- and 4-bit "
                         "grey and palette ones are read")
    if interlace:
        raise ValueError(f"{name}: interlaced PNGs are not read")
    ch = _CHANNELS[color]
    raw = zlib.decompress(b"".join(idat))
    if depth < 8:
        # one sample a pixel, packed from the high bits, each row padded to a byte
        rows = _unfilter(raw, h, (w * depth + 7) // 8, 1, name)
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        px = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)[:, :w, None]
        if color == 0:
            px = px * np.uint8(255 // ((1 << depth) - 1))
    else:
        px = _unfilter(raw, h, w * ch, ch, name).reshape(h, w, ch)
    if color == 3:
        if palette is None:
            raise ValueError(f"{name}: a palette image without a PLTE chunk")
        return "P", px[..., 0], palette
    mode = {0: "1" if depth == 1 else "L", 2: "RGB", 4: "LA", 6: "RGBA"}[color]
    return mode, (px[..., 0] if ch == 1 else px), None


def to_rgb(mode: str, px: np.ndarray, palette=None) -> np.ndarray:
    """Pixels of `mode` (as `decode_png_mode` gives them) -> uint8
    [H, W, 3], as PIL's convert("RGB")."""
    if mode == "P":
        return palette[px]
    if mode in ("1", "L", "LA"):
        grey = px if px.ndim == 2 else px[..., 0]
        return np.repeat(grey[..., None], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def decode_png(data: bytes, name: str = "PNG") -> np.ndarray:
    """The bytes of an 8-bit, non-interlaced PNG -> uint8 [H, W, 3]."""
    return to_rgb(*decode_png_mode(data, name))


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def read_png_mode(path: str):
    with open(path, "rb") as f:
        return decode_png_mode(f.read(), path)


def read_image(path: str) -> np.ndarray:
    """An RGB photo as uint8 [H, W, 3]: `.png` through `decode_png`, `.npy`
    through numpy (a uint8 [H, W, 3] array), any other format through PIL,
    which is imported only here; without PIL such a file raises."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        return read_png(path)
    if ext == ".npy":
        img = np.load(path, allow_pickle=False)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"{path}: expected uint8 [H, W, 3], got {img.dtype} {img.shape}")
        return img
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"{path}: reading {ext or 'extension-less'} images needs PIL, which "
                           "is not installed here; convert the photos to .png or .npy") from None
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def read_image_mode(path: str):
    """A photo in the mode PIL opens it in, as `decode_png_mode` returns it:
    `.png` through the decoder, any other format through PIL (imported
    only here; without PIL such a file raises ModuleNotFoundError). Modes
    other than '1', 'L', 'LA', 'RGB', 'RGBA' and 'P' (a CMYK JPEG, 16-bit
    or float images) come back converted to 'RGB'."""
    if os.path.splitext(path)[1].lower() == ".png":
        return read_png_mode(path)
    from PIL import Image
    with Image.open(path) as im:
        if im.mode not in ("1", "L", "LA", "RGB", "RGBA", "P"):
            im = im.convert("RGB")
        px = np.asarray(im)
        if im.mode == "1":
            return "1", px.astype(np.uint8) * np.uint8(255), None
        if im.mode == "P":
            return "P", px, np.asarray(im.getpalette("RGB"), np.uint8).reshape(-1, 3)
        return im.mode, px, None


def to_grey(img: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] -> uint8 [H, W]: PIL's convert("L") in its integer
    fixed point, (R*19595 + G*38470 + B*7471 + 0x8000) >> 16 (a grey image
    read as three equal channels comes back unchanged)."""
    x = np.asarray(img, np.uint32)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471 + 0x8000) >> 16).astype(
        np.uint8)
