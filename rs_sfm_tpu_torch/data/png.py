"""8-bit PNG reading and writing on the standard library (`zlib`, `struct`)
and numpy: the port's image codec, in place of the `imageio` calls of the
JAX package's dataset and artifact writers.

`read` takes non-interlaced 8-bit PNGs of colour type grey (0), RGB (2),
palette (3, expanded to RGB), grey + alpha (4) and RGBA (6), with any of
the five row filters; it returns what `imageio.v3.imread` returns for them:
uint8 arrays (H, W) for grey, (H, W, C) otherwise.  `write` stores a
uint8 (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) array, every row with one
filter (by default "up").
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Colour type: channels per pixel.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_TYPE_OF_CHANNELS = {1: 0, 2: 4, 3: 2, 4: 6}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _predictor(rows, c: int, row_filter: int) -> np.ndarray:
    """Each byte's prediction under `row_filter` (0-4), from int16 rows."""
    zero = np.zeros_like(rows)
    up = np.concatenate([zero[:1], rows[:-1]])
    left = np.concatenate([zero[:, :c], rows[:, :-c]], axis=1)
    ul = np.concatenate([zero[:, :c], up[:, :-c]], axis=1)
    if row_filter == 4:
        pa, pb, pc = np.abs(up - ul), np.abs(left - ul), np.abs(
            left + up - 2 * ul)
        return np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, ul))
    return [zero, left, up, (left + up) >> 1][row_filter]


def encode(image, level: int = 6, row_filter: int = 2) -> bytes:
    """The PNG file of a uint8 image (see the module docstring); every row
    with `row_filter`: 0 none, 1 sub, 2 up, 3 average, 4 Paeth."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise TypeError(f"PNG images are uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _TYPE_OF_CHANNELS:
        raise ValueError(f"cannot store an image of shape {img.shape}")
    h, w, c = img.shape
    if row_filter not in range(5):
        raise ValueError(f"unknown PNG row filter {row_filter}")
    rows = np.ascontiguousarray(img).reshape(h, w * c).astype(np.int16)
    diff = ((rows - _predictor(rows, c, row_filter)) & 0xFF).astype(np.uint8)
    raw = np.concatenate([np.full((h, 1), row_filter, np.uint8), diff],
                         axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _TYPE_OF_CHANNELS[c], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def write(path: str, image) -> None:
    """Write a uint8 image as a PNG file."""
    with open(path, "wb") as f:
        f.write(encode(image))


def _unfilter_rows(types, lines, bpp):
    """Undo rows of the None, Sub and Up filters, one row at a time."""
    h, stride = lines.shape
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        line = lines[y]
        if types[y] == 1:
            # Sub: a running sum along the row, per byte of a pixel.
            line = (np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint64)
                    % 256).astype(np.uint8).reshape(-1)
        elif types[y] == 2:
            line = line + prior
        out[y] = line
        prior = out[y]
    return out


def _unfilter_diagonals(types, lines, bpp):
    """Undo rows of any filter.  Pixel (i, j) depends on its left, upper
    and upper-left neighbours only, so the pixels of one anti-diagonal
    i + j = d are independent: the loop runs over the h + w - 1
    diagonals, each step on all of its pixels at once.  The images are held
    skewed, `sk[d + 2, i + 1]` = pixel (i, d - i), so that a diagonal and
    its neighbours' diagonals are slices; index 0 of either axis holds the
    zeros beyond the image's top and left edges."""
    h, stride = lines.shape
    w = stride // bpp
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    x = np.zeros((h + w - 1, h, bpp), np.int16)
    x[ii + jj, ii] = lines.reshape(h, w, bpp)
    t = types.astype(np.int16)[:, None]
    sk = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    for d in range(h + w - 1):
        lo, hi = max(0, d - w + 1), min(h - 1, d)
        a = sk[d + 1, lo + 1:hi + 2]    # left: (i, j - 1)
        b = sk[d + 1, lo:hi + 1]        # up: (i - 1, j)
        c = sk[d, lo:hi + 1]            # upper left: (i - 1, j - 1)
        ti = t[lo:hi + 1]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(ti == 4, paeth, np.where(
            ti == 3, (a + b) >> 1, np.where(
                ti == 2, b, np.where(ti == 1, a, 0))))
        sk[d + 2, lo + 1:hi + 2] = (x[d, lo:hi + 1] + pred) & 0xFF
    return sk[ii + jj + 2, ii + 1].astype(np.uint8).reshape(h, stride)


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: (h, stride) uint8 scanlines."""
    rows = np.frombuffer(data, np.uint8, h * (stride + 1)).reshape(
        h, stride + 1)
    types, lines = rows[:, 0], rows[:, 1:]
    if int(types.max(initial=0)) > 4:
        raise ValueError(f"unknown PNG row filter {int(types.max())}")
    if np.isin(types, (3, 4)).any():
        return _unfilter_diagonals(types, lines, bpp)
    return _unfilter_rows(types, lines, bpp)


def decode(blob: bytes) -> np.ndarray:
    """The uint8 image of a PNG file's bytes."""
    if blob[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    idat = []
    palette = None
    header = None
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        kind = blob[pos + 4:pos + 8]
        data = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG file without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace} (8-bit, "
                         f"non-interlaced grey/RGB/palette/RGBA only)")
    chans = _CHANNELS[ctype]
    raw = zlib.decompress(b"".join(idat))
    img = _unfilter(raw, h, w * chans, chans).reshape(h, w, chans)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        return palette[img[..., 0]]
    return img[..., 0] if chans == 1 else img


def read(path: str) -> np.ndarray:
    """Read a PNG file (see the module docstring)."""
    with open(path, "rb") as f:
        return decode(f.read())
