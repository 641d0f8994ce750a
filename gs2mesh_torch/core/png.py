"""8-bit PNG files without an image library (zlib + struct).

``write_png`` writes (H, W, 3) uint8 RGB or (H, W) uint8 grayscale with
filter 0 on every row. ``read_png`` decodes 8-bit grayscale, RGB and RGBA
non-interlaced PNGs (all five row filters) and raises ValueError for any
other format, so an unsupported file never decodes into wrong pixels.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG color type -> channels (grayscale, RGB, RGBA)
_CHANNELS = {0: 1, 2: 3, 6: 4}


def write_png(path: str, img: np.ndarray) -> None:
    """(H, W, 3) uint8 -> 8-bit RGB PNG; (H, W) uint8 -> 8-bit grayscale."""
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and
                                                       img.shape[2] == 3)):
        raise ValueError(f"expected (H, W, 3) or (H, W) uint8, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    ctype = 0 if img.ndim == 2 else 2
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)],
                          axis=1)                # filter byte 0 per row

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                              0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))


def _unfilter_row(ft: int, line: bytes, prev: bytearray, bpp: int,
                  path: str) -> bytearray:
    """Undo one row's PNG filter (types 0-4) given the previous output row."""
    cur = bytearray(line)
    n = len(cur)
    if ft == 0:
        return cur
    if ft == 1:                                    # Sub
        for i in range(bpp, n):
            cur[i] = (cur[i] + cur[i - bpp]) & 0xFF
    elif ft == 2:                                  # Up
        for i in range(n):
            cur[i] = (cur[i] + prev[i]) & 0xFF
    elif ft == 3:                                  # Average
        for i in range(n):
            a = cur[i - bpp] if i >= bpp else 0
            cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF
    elif ft == 4:                                  # Paeth
        for i in range(n):
            a = cur[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            cur[i] = (cur[i] + pred) & 0xFF
    else:
        raise ValueError(f"{path}: unknown PNG row filter {ft}")
    return cur


def read_png(path: str) -> np.ndarray:
    """8-bit non-interlaced PNG -> (H, W) uint8 for grayscale, (H, W, 3 or
    4) uint8 for RGB / RGBA."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: corrupt {tag!r} chunk")
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: missing IHDR or IDAT")
    w, h, depth, ctype, comp, filt, interlace = header
    if depth != 8 or ctype not in _CHANNELS or comp or filt or interlace:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, color type {ctype}, "
            f"interlace {interlace}); this reader takes 8-bit grayscale, RGB "
            f"or RGBA, "
            f"non-interlaced")
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (stride + 1):
        raise ValueError(f"{path}: {len(raw)} bytes of pixel data, expected "
                         f"{h * (stride + 1)}")
    out = bytearray()
    prev = bytearray(stride)
    for y in range(h):
        row = raw[y * (stride + 1):(y + 1) * (stride + 1)]
        prev = _unfilter_row(row[0], row[1:], prev, bpp, path)
        out += prev
    img = np.frombuffer(bytes(out), np.uint8).reshape(h, w, bpp)
    return img[..., 0] if ctype == 0 else img
