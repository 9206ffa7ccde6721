"""Minimal dependency-free PNG I/O (8-bit RGB / grayscale); copy of
``rtnr_tpu.utils.image``.

The reference displays frames with OpenCV highgui (reference
example/render_trajectory/main.cpp:98); the render CLI saves PNGs instead.
Pure python + zlib, the same bytes as the JAX package's writer; fine for
trajectory dumps, not a hot path.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Union

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    c = tag + data
    return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))


def write_png(path: Union[str, Path], image: np.ndarray) -> None:
    """Write (H,W,3) uint8 RGB or (H,W) uint8 grayscale as PNG."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"write_png expects uint8, got {image.dtype}")
    if image.ndim == 2:
        color_type = 0
        row_bytes = image[:, :, None]
    elif image.ndim == 3 and image.shape[2] == 3:
        color_type = 2
        row_bytes = image
    else:
        raise ValueError(f"Unsupported image shape {image.shape}")
    h, w = image.shape[:2]
    raw = b"".join(b"\x00" + row_bytes[i].tobytes() for i in range(h))
    png = (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b"")
    )
    Path(path).write_bytes(png)


def read_png(path: Union[str, Path]) -> np.ndarray:
    """Read an 8-bit non-interlaced RGB/gray/RGBA PNG written by write_png
    (or equivalent). Returns (H,W,3) or (H,W) uint8; alpha dropped."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("Not a PNG file")
    pos = 8
    idat = b""
    w = h = None
    color_type = bit_depth = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, bit_depth, color_type, _, _, interlace = struct.unpack(">IIBBBBB", payload)
            if bit_depth != 8 or interlace != 0:
                raise ValueError("Only 8-bit non-interlaced PNG supported")
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
        pos += 12 + length
    channels = {0: 1, 2: 3, 6: 4}.get(color_type)
    if channels is None:
        raise ValueError(f"Unsupported PNG color type {color_type}")
    raw = zlib.decompress(idat)
    stride = w * channels
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    posr = 0
    for y in range(h):
        filt = raw[posr]
        line = np.frombuffer(raw[posr + 1 : posr + 1 + stride], np.uint8).copy()
        posr += 1 + stride
        if filt == 0:
            pass
        elif filt == 1:  # Sub
            for x in range(channels, stride):
                line[x] = (line[x] + line[x - channels]) & 0xFF
        elif filt == 2:  # Up
            line = (line.astype(np.int32) + prev).astype(np.uint8)
        elif filt == 3:  # Average
            for x in range(stride):
                a = line[x - channels] if x >= channels else 0
                line[x] = (line[x] + ((int(a) + int(prev[x])) >> 1)) & 0xFF
        elif filt == 4:  # Paeth
            for x in range(stride):
                a = int(line[x - channels]) if x >= channels else 0
                b = int(prev[x])
                c = int(prev[x - channels]) if x >= channels else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                line[x] = (line[x] + pred) & 0xFF
        else:
            raise ValueError(f"Unsupported PNG filter {filt}")
        out[y] = line
        prev = out[y]
    img = out.reshape(h, w, channels)
    if channels == 1:
        return img[:, :, 0]
    return img[:, :, :3]
