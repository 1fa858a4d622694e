"""PNG reading and writing in numpy and zlib, for the inference CLI on a
machine without OpenCV or PIL.

`read_png(path)` returns what `cv2.imread(path, cv2.IMREAD_COLOR)[:, :,
::-1]` returns: RGB uint8 (H, W, 3). It reads every non-interlaced PNG of
the standard: gray (1, 2, 4, 8, 16 bits), gray with alpha, RGB, RGBA (8,
16 bits) and palette (1, 2, 4, 8 bits), each scanline under any of the
five filters. As OpenCV reads them, gray is repeated into the three
channels, gray of 1, 2 or 4 bits is scaled to 0..255, a palette index
takes its PLTE colour, 16-bit samples keep their high byte, and alpha and
tRNS are dropped without compositing. An interlaced PNG, a file that is
not a PNG, and a damaged one raise a ValueError.

`write_png(path, rgb)` writes RGB uint8 as an 8-bit PNG (each scanline
under the Sub filter), which OpenCV reads back bit for bit.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

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


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int,
              path) -> np.ndarray:
    """The scanlines of the decompressed stream with their filters undone:
    (height, stride) uint8. A pixel (bpp bytes, one byte below 8 bits a
    pixel) depends on its left, upper and upper-left neighbours, so the
    pixels are undone one anti-diagonal at a time, all rows at once, in a
    sheared copy where each diagonal is one contiguous slice."""
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: image data of {raw.size} bytes, "
                         f"{height * (stride + 1)} expected")
    rows = raw.reshape(height, stride + 1)
    ftype = rows[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"{path}: unknown PNG filter type")
    ncol = stride // bpp
    diags = height + ncol - 1
    # pixel (r, c) lies at sheared[r + c + 2, r + 1]; the first two
    # diagonals and row 0 hold the zeros left of and above the image
    r = np.repeat(np.arange(height), ncol)
    at = (r + np.tile(np.arange(ncol), height) + 2, r + 1)
    filt = np.zeros((diags + 2, height + 1, bpp), np.int16)
    filt[at] = rows[:, 1:].reshape(-1, bpp)
    kind = [(ftype == k)[:, None].astype(np.int16) for k in range(1, 5)]
    sheared = np.zeros_like(filt)
    for d in range(2, diags + 2):
        r0, r1 = max(0, d - 1 - ncol), min(height, d - 1)
        left = sheared[d - 1, r0 + 1:r1 + 1]
        up = sheared[d - 1, r0:r1]
        upleft = sheared[d - 2, r0:r1]
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, up, upleft))
        pred = (kind[0][r0:r1] * left + kind[1][r0:r1] * up
                + kind[2][r0:r1] * ((left + up) >> 1)
                + kind[3][r0:r1] * paeth)
        sheared[d, r0 + 1:r1 + 1] = (filt[d, r0 + 1:r1 + 1] + pred) & 0xFF
    return sheared[at].reshape(height, stride).astype(np.uint8)


def read_png(path) -> np.ndarray:
    """RGB uint8 (H, W, 3) of the PNG at `path`, as OpenCV's
    `imread(path, IMREAD_COLOR)` reads it, channels reversed."""
    with open(path, "rb") as f:
        data = f.read()
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
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{path}: damaged PNG image data ({e})") from None
    ch = _CHANNELS[ctype]
    bits = ch * depth
    stride = (width * bits + 7) // 8
    rows = _unfilter(raw, height, stride, max(1, bits // 8), path)
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


def write_png(path, rgb) -> None:
    """Write RGB uint8 (H, W, 3) as an 8-bit PNG."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_png takes RGB uint8 (H, W, 3), not "
                         f"{rgb.dtype} {rgb.shape}")
    h, w, _ = rgb.shape
    rows = rgb.reshape(h, 3 * w)
    # the Sub filter: each byte less the same channel of the pixel before
    sub = rows.copy()
    sub[:, 3:] -= rows[:, :-3]
    scan = np.concatenate([np.ones((h, 1), np.uint8), sub], axis=1)
    with open(path, "wb") as f:
        f.write(SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                              0))
                + _chunk(b"IDAT", zlib.compress(scan.tobytes(), 6))
                + _chunk(b"IEND", b""))
