"""Image decoding, encoding and resizing without PIL.

The JAX package reads and resizes every image with PIL
(`Image.open(path).resize((w, h))`). This module replaces both, with stdlib
`zlib` and numpy only, so the port runs where PIL is not installed:

  - `read_png` / `write_png`: 8-bit gray, gray+alpha, RGB and RGBA,
    non-interlaced, all five scanline filters. Anything else raises.
  - `resize`: a numpy copy of Pillow's `Image.resize(size)` with its default
    BICUBIC filter (a = −0.5; libImaging/Resample.c): for downscaling the
    support widens by the scale factor; each output's weights are
    normalised, then converted to 22-bit fixed point; the horizontal pass
    runs first and its result is rounded and clipped to uint8, then the
    vertical pass. RGBA (and LA) is resized premultiplied, as Pillow's
    "RGBa" detour does (libImaging/Convert.c), and un-premultiplied after.
    The result is bit-identical to Pillow's.
  - `read_image`: PNG through `read_png`; any other format through PIL
    where PIL can be imported (JPEG in COLMAP scenes), else an error that
    names the missing decoder.
"""
from __future__ import annotations

import math
import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
# PNG colour type → channels (8-bit only): gray, RGB, gray+alpha, RGBA.
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}


def is_png(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == _SIG


def _chunks(data: bytes):
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return


def _unfilter(raw: np.ndarray, ftypes: np.ndarray, ch: int) -> np.ndarray:
    """Undo the per-row PNG filters of raw (H, W, ch) uint8. Pixel (r, c)
    depends on (r, c−1), (r−1, c) and (r−1, c−1) only, so every pixel of an
    anti-diagonal r + c = d is reconstructed at once (H + W − 1 steps)."""
    H, W = raw.shape[:2]
    if (ftypes == 0).all():
        return raw
    if ((ftypes == 0) | (ftypes == 1)).all():
        # Sub only: a running byte sum along each row.
        sub = ftypes == 1
        out = raw.copy()
        out[sub] = np.cumsum(raw[sub].astype(np.int64), axis=1) % 256
        return out
    rec = np.zeros((H + 1, W + 1, ch), np.int32)   # row 0 / col 0: zeros
    x = raw.astype(np.int32)
    ft = ftypes.astype(np.int32)
    for d in range(H + W - 1):
        r = np.arange(max(0, d - W + 1), min(H, d + 1))
        c = d - r
        a = rec[r + 1, c]                 # left
        b = rec[r, c + 1]                 # up
        cc = rec[r, c]                    # up-left
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, cc))
        f = ft[r][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        rec[r + 1, c + 1] = (x[r, c] + pred) & 255
    return rec[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit non-interlaced gray / gray+alpha / RGB / RGBA PNG to
    uint8 (H, W) for gray, else (H, W, C), as np.asarray(PIL image) gives."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG file")
    hdr, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    W, H, depth, ctype, _comp, _filt, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type "
            f"{ctype}, interlace {interlace}); msgs_torch reads 8-bit "
            f"non-interlaced gray, gray+alpha, RGB and RGBA")
    ch = _CHANNELS[ctype]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows[:H * (1 + W * ch)].reshape(H, 1 + W * ch)
    ftypes = rows[:, 0]
    if (ftypes > 4).any():
        raise ValueError(f"{path}: invalid PNG filter type")
    img = _unfilter(rows[:, 1:].reshape(H, W, ch), ftypes, ch)
    return img[..., 0] if ch == 1 else img


def write_png(path: str, img: np.ndarray, filters=(1,), level: int = 6):
    """Encode uint8 (H, W) or (H, W, C), C in 1..4, as a PNG. Row r uses
    filter filters[r % len(filters)] (default Sub for every row)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError("write_png: uint8 image expected")
    if img.ndim == 2:
        img = img[..., None]
    H, W, ch = img.shape
    if ch not in _COLOR_TYPE:
        raise ValueError(f"write_png: {ch} channels")
    x = img.astype(np.int32)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = [np.zeros_like(x), a, b, (a + b) >> 1, paeth]
    ft = np.array([filters[r % len(filters)] for r in range(H)], np.uint8)
    out = np.empty((H, 1 + W * ch), np.uint8)
    out[:, 0] = ft
    for f in np.unique(ft):
        rows = ft == f
        out[rows, 1:] = ((x[rows] - preds[f][rows]) & 255).reshape(
            int(rows.sum()), W * ch)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", W, H, 8, _COLOR_TYPE[ch], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIG + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(out.tobytes(), level))
                + chunk(b"IEND", b""))


def image_size(path: str):
    """(width, height) of an image file, as PIL's `Image.open(p).size`."""
    if is_png(path):
        with open(path, "rb") as f:
            head = f.read(24)
        return struct.unpack(">II", head[16:24])
    return _pil().open(path).size


def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            "msgs_torch reads PNG itself; other image formats (JPEG) need "
            "PIL, which is not installed") from e
    return Image


def read_image(path: str) -> np.ndarray:
    """uint8 pixels of an image file, shaped as np.asarray(PIL image)."""
    if is_png(path):
        return read_png(path)
    Image = _pil()
    with Image.open(path) as im:
        return np.asarray(im)


# --- Pillow's Image.resize (BICUBIC) -----------------------------------------

_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _coeffs(in_size: int, out_size: int):
    """Resample.c precompute_coeffs + normalize_coeffs_8bpc for the box
    (0, in_size): per output index, the first input index and the int
    fixed-point weights, (out_size,), (out_size, ksize)."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    xmins = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = _bicubic((np.arange(xmax) + xmin - center + 0.5) * ss)
        ww = 0.0
        for v in w:               # sequential, as the C loop sums
            ww += float(v)
        if ww != 0.0:
            w = w / ww
        fixed = w * (1 << _PRECISION_BITS)
        kk[xx, :xmax] = np.where(w < 0, (-0.5 + fixed).astype(np.int64),
                                 (0.5 + fixed).astype(np.int64))
        xmins[xx] = xmin
    return xmins, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit pass along `axis` of uint8 (H, W, C)."""
    in_size = img.shape[axis]
    xmins, kk = _coeffs(in_size, out_size)
    idx = np.minimum(xmins[:, None] + np.arange(kk.shape[1])[None, :],
                     in_size - 1)                      # (out, ksize)
    src = np.moveaxis(img, axis, 0).astype(np.int64)   # (in, other, C)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int64)
    for j in range(kk.shape[1]):
        acc += src[idx[:, j]] * kk[:, j].reshape((-1,) + (1,) * (src.ndim - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize(img: np.ndarray, size) -> np.ndarray:
    """Pillow's `Image.fromarray(img).resize(size)` for uint8 (H, W) gray,
    (H, W, 2) gray+alpha, (H, W, 3) RGB or (H, W, 4) RGBA; size is
    (width, height)."""
    w, h = int(size[0]), int(size[1])
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError("resize: uint8 image expected")
    if (img.shape[1], img.shape[0]) == (w, h):
        return img.copy()
    gray = img.ndim == 2
    x = img[..., None] if gray else img
    alpha = x.shape[-1] in (2, 4)
    if alpha:
        # RGBA → RGBa: MULDIV255(v, a) = ((t >> 8) + t) >> 8, t = v·a + 128.
        a = x[..., -1:].astype(np.uint32)
        t = x[..., :-1].astype(np.uint32) * a + 128
        x = np.concatenate([(((t >> 8) + t) >> 8).astype(np.uint8),
                            x[..., -1:]], axis=-1)
    if w != x.shape[1]:
        x = _resample_axis(x, w, 1)
    if h != x.shape[0]:
        x = _resample_axis(x, h, 0)
    if alpha:
        # RGBa → RGBA: v·255 / a (integer division, clipped), except where
        # a is 0 or 255.
        a = x[..., -1:].astype(np.int64)
        v = x[..., :-1].astype(np.int64)
        un = np.clip((255 * v) // np.maximum(a, 1), 0, 255)
        keep = (a == 0) | (a == 255)
        x = np.concatenate([np.where(keep, v, un).astype(np.uint8),
                            x[..., -1:]], axis=-1)
    return x[..., 0] if gray else x
