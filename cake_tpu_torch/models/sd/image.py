"""PNG files and Lanczos resampling in numpy, without PIL.

The JAX package writes its images with `PIL.Image` and reads img2img
inputs with it, resized with `Image.LANCZOS` (`cake_tpu/models/sd/sd.py`
`_decode_to_pngs`, `_image_preprocess`). The port does both itself, so
it runs where PIL is not installed:

  * `encode_png`: an 8-bit RGB (or gray) PNG, one zlib stream, filter 0
    on every row;
  * `decode_png`: a non-interlaced 8-bit PNG of any colour type (gray,
    RGB, palette, gray + alpha, RGBA) as RGB, alpha dropped, as PIL's
    `convert("RGB")` gives it; any other file (another format, Adam7
    interlacing, another bit depth) raises ValueError naming what it is;
  * `resize_lanczos`: PIL's `Image.resize(size, Image.LANCZOS)` on an
    8-bit image: the same separable Lanczos-3 taps (support scaled by
    the downscale factor), the same 22-bit fixed-point coefficients and
    rounding, the horizontal pass first into an 8-bit intermediate.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_png(img: np.ndarray) -> bytes:
    """PNG bytes of a uint8 image [H, W, 3] (RGB) or [H, W] (gray)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        color, channels = 0, 1
    elif img.ndim == 3 and img.shape[2] == 3:
        color, channels = 2, 3
    else:
        raise ValueError(f"encode_png takes [H, W, 3] or [H, W], got "
                         f"{img.shape}")
    H, W = img.shape[:2]
    rows = img.reshape(H, W * channels)
    raw = np.zeros((H, W * channels + 1), dtype=np.uint8)
    raw[:, 1:] = rows                      # filter type 0 on every row
    ihdr = struct.pack(">IIBBBBB", W, H, 8, color, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(data: bytes, H: int, stride: int, bpp: int) -> np.ndarray:
    """The scanlines of a non-interlaced image, each filter undone."""
    out = np.zeros((H, stride), dtype=np.uint8)
    buf = np.frombuffer(data, dtype=np.uint8)
    if buf.size < H * (stride + 1):
        raise ValueError("PNG: truncated image data")
    prev = np.zeros(stride, dtype=np.int32)
    for y in range(H):
        ftype = int(buf[y * (stride + 1)])
        line = buf[y * (stride + 1) + 1:(y + 1) * (stride + 1)].astype(
            np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype in (1, 3, 4):
            cur = line.copy()
            for x in range(stride):
                a = int(cur[x - bpp]) if x >= bpp else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + int(prev[x])) >> 1
                else:
                    c = int(prev[x - bpp]) if x >= bpp else 0
                    pred = _paeth(a, int(prev[x]), c)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"PNG: unknown filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """A PNG file's pixels as uint8 RGB [H, W, 3] (see the module
    docstring for what is read)."""
    if data[:8] != PNG_SIGNATURE:
        kind = ("JPEG" if data[:3] == b"\xff\xd8\xff" else
                "GIF" if data[:4] == b"GIF8" else
                "WebP" if data[:4] == b"RIFF" and data[8:12] == b"WEBP" else
                "BMP" if data[:2] == b"BM" else "not a PNG")
        raise ValueError(
            f"img2img input is {kind}: the port reads PNG files only "
            "(convert the image to PNG)")
    pos, ihdr, idat, plte = 8, None, [], None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, dtype=np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG: no IHDR chunk")
    W, H, depth, color, _comp, _filt, interlace = ihdr
    if color not in _CHANNELS:
        raise ValueError(f"PNG: unknown colour type {color}")
    if depth != 8:
        raise ValueError(f"PNG: bit depth {depth} is not supported "
                         "(8-bit PNGs only)")
    if interlace:
        raise ValueError("PNG: Adam7 interlacing is not supported")
    ch = _CHANNELS[color]
    px = _unfilter(zlib.decompress(b"".join(idat)), H, W * ch, ch)
    px = px.reshape(H, W, ch)
    if color == 0:
        return np.repeat(px, 3, axis=2)
    if color == 4:
        return np.repeat(px[:, :, :1], 3, axis=2)
    if color == 3:
        if plte is None:
            raise ValueError("PNG: a palette image without PLTE")
        return plte[np.minimum(px[:, :, 0], len(plte) - 1)]
    return np.ascontiguousarray(px[:, :, :3])


# -- Lanczos ---------------------------------------------------------------------

_PRECISION_BITS = 32 - 8 - 2
_LANCZOS_SUPPORT = 3.0


def _sinc(x: np.ndarray) -> np.ndarray:
    x = x * np.pi
    with np.errstate(invalid="ignore", divide="ignore"):
        out = np.sin(x) / x
    return np.where(x == 0.0, 1.0, out)


def _lanczos(x: np.ndarray) -> np.ndarray:
    return np.where((x > -3.0) & (x < 3.0), _sinc(x) * _sinc(x / 3.0), 0.0)


def _coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray,
                                                   np.ndarray]:
    """PIL's `precompute_coeffs` and `normalize_coeffs_8bpc`: for each
    output pixel the first input index, the tap count and the fixed-point
    taps [out, ksize] (int64)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _LANCZOS_SUPPORT * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    xmins = np.zeros(out_size, dtype=np.int64)
    counts = np.zeros(out_size, dtype=np.int64)
    taps = np.zeros((out_size, ksize), dtype=np.int64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        x = np.arange(xmax, dtype=np.float64)
        w = _lanczos((x + xmin - center + 0.5) * ss)
        ww = w.sum()
        if ww != 0.0:
            w = w / ww
        fixed = w * (1 << _PRECISION_BITS)
        taps[xx, :xmax] = np.where(fixed < 0, np.trunc(fixed - 0.5),
                                   np.trunc(fixed + 0.5)).astype(np.int64)
        xmins[xx], counts[xx] = xmin, xmax
    return xmins, counts, taps


def _pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit resampling pass along `axis` (1 = horizontal)."""
    src = np.moveaxis(img.astype(np.int64), axis, 0)
    xmins, counts, taps = _coeffs(src.shape[0], out_size)
    out = np.empty((out_size,) + src.shape[1:], dtype=np.uint8)
    half = 1 << (_PRECISION_BITS - 1)
    for xx in range(out_size):
        lo, n = xmins[xx], counts[xx]
        acc = np.tensordot(taps[xx, :n], src[lo:lo + n], axes=(0, 0)) + half
        out[xx] = np.clip(acc >> _PRECISION_BITS, 0, 255)
    return np.moveaxis(out, 0, axis)


def resize_lanczos(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 [H, W, C] -> [height, width, C], as PIL's
    `Image.resize((width, height), Image.LANCZOS)`."""
    H, W = img.shape[:2]
    if (W, H) == (width, height):
        return img.copy()
    out = img
    if width != W:
        out = _pass(out, width, axis=1)
    if height != H:
        out = _pass(out, height, axis=0)
    return out
