"""PNG reading and writing in numpy, zlib and a C++ scanline unfilter, for
the CLIs and the training data on a machine without OpenCV or PIL.

`read_png(path)` returns what `cv2.imread(path, cv2.IMREAD_COLOR)[:, :,
::-1]` returns, and `decode_png(data)` what `cv2.imdecode` returns of the
file's bytes, channels reversed: RGB uint8 (H, W, 3). It reads every
non-interlaced PNG of the standard: gray (1, 2, 4, 8, 16 bits), gray with
alpha, RGB, RGBA (8, 16 bits) and palette (1, 2, 4, 8 bits), each
scanline under any of the five filters. As OpenCV reads them, gray is
repeated into the three channels, gray of 1, 2 or 4 bits is scaled to
0..255, a palette index takes its PLTE colour, 16-bit samples keep their
high byte, and alpha and tRNS are dropped without compositing. An
interlaced PNG, a file that is not a PNG, and a damaged one raise a
ValueError. The scanlines' filters are undone in C++
(`gsasr_torch/native/png.cpp`, built with g++ at first use; reading raises
a RuntimeError where it cannot be built): Average and Paeth, which most
files on disk carry, are a serial loop along each row.

`encode_png(rgb)` gives, and `write_png(path, rgb)` writes, RGB uint8 as
an 8-bit PNG, which OpenCV reads back bit for bit: each scanline under the
Sub filter, as `cv2.imwrite` writes by default, or with `adaptive=True`
under the filter that libpng's heuristic picks (the least sum of absolute
bytes), as `cv2.imwrite` writes at `IMWRITE_PNG_COMPRESSION` 3, the level
at which BasicSR's `extract_subimages` writes DIV2K's training sub-images.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from gsasr_torch.native import png_unfilter

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}


def _chunks(data: bytes, path):
    """(type, payload) of each chunk up to IEND; CRCs of the critical
    chunks checked."""
    pos = len(SIGNATURE)
    while pos + 12 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            break
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if kind[0:1].isupper() and zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: damaged PNG ({kind.decode()} CRC)")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: truncated PNG (no IEND)")


def read_png(path) -> np.ndarray:
    """RGB uint8 (H, W, 3) of the PNG at `path`, as OpenCV's
    `imread(path, IMREAD_COLOR)` reads it, channels reversed."""
    with open(path, "rb") as f:
        return _decode(f.read(), path)


def decode_png(data: bytes) -> np.ndarray:
    """RGB uint8 (H, W, 3) of the PNG file in `data`, as OpenCV's
    `imdecode(data, IMREAD_COLOR)` decodes it, channels reversed."""
    return _decode(data, "PNG data")


def _decode(data: bytes, path) -> np.ndarray:
    """The PNG file in `data`; its errors name `path`."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file (only PNG is read)")
    header = palette = None
    idat = []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    width, height, depth, ctype, comp, fmethod, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced PNG (Adam7) is not read")
    if (ctype not in _CHANNELS or depth not in _DEPTHS[ctype] or comp
            or fmethod or not width or not height):
        raise ValueError(f"{path}: unsupported PNG header {header}")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without PLTE")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: damaged PNG image data ({e})") from None
    ch = _CHANNELS[ctype]
    bits = ch * depth
    stride = (width * bits + 7) // 8
    if len(raw) != height * (stride + 1):
        raise ValueError(f"{path}: image data of {len(raw)} bytes, "
                         f"{height * (stride + 1)} expected")
    try:
        rows = png_unfilter(raw, height, stride, max(1, bits // 8))
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    if depth < 8:
        # samples packed from the high bits of each byte, rows padded
        per = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        v = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
        px = v.reshape(height, stride * per)[:, :width]
        if ctype == 0:
            px = px * (255 // ((1 << depth) - 1))
        px = px[:, :, None]
    elif depth == 16:
        px = rows.reshape(height, width, ch, 2)[..., 0]
    else:
        px = rows.reshape(height, width, ch)
    if ctype == 3:
        if int(px.max()) >= len(palette):
            raise ValueError(f"{path}: palette index out of range")
        return palette[px[:, :, 0]]
    if ctype in (0, 4):
        return np.repeat(px[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(px[:, :, :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _filtered(rows: np.ndarray, bpp: int) -> np.ndarray:
    """(5, H, stride) uint8: the scanlines `rows` under each of the five
    filters (None, Sub, Up, Average, Paeth)."""
    x = rows.astype(np.int16)
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    pred = np.stack([np.zeros_like(x), left, up, (left + up) >> 1, paeth])
    return ((x - pred) & 0xFF).astype(np.uint8)


def write_png(path, rgb, *, adaptive: bool = False, level: int = 6) -> None:
    """Write `encode_png(rgb, adaptive=adaptive, level=level)` to `path`."""
    data = encode_png(rgb, adaptive=adaptive, level=level)
    with open(path, "wb") as f:
        f.write(data)


def encode_png(rgb, *, adaptive: bool = False, level: int = 6) -> bytes:
    """RGB uint8 (H, W, 3) as an 8-bit PNG file, zlib at `level`: each
    scanline under the Sub filter, or with `adaptive` under the filter of
    the least sum of min(b, 256 - b) over its bytes, the first on a tie
    (libpng's choice)."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_png takes RGB uint8 (H, W, 3), not "
                         f"{rgb.dtype} {rgb.shape}")
    h, w, _ = rgb.shape
    rows = rgb.reshape(h, 3 * w)
    if adaptive:
        cand = _filtered(rows, 3)
        cost = np.minimum(cand, 256 - cand.astype(np.int32)).sum(2)
        ftype = cost.argmin(0).astype(np.uint8)
        data = cand[ftype, np.arange(h)]
    else:
        # Sub: each byte less the same channel of the pixel before
        ftype = np.ones(h, np.uint8)
        data = rows.copy()
        data[:, 3:] -= rows[:, :-3]
    scan = np.concatenate([ftype[:, None], data], axis=1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(scan.tobytes(), level))
            + _chunk(b"IEND", b""))
