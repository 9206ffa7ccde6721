"""Baseline JPEG decoding and encoding on the port's host library
(``csrc/host/rtnr_jpeg.cpp``).

``decode_jpeg`` decodes baseline sequential Huffman JPEG (8-bit, greyscale
or three components, 4:4:4 / 4:2:2 / 4:2:0 and other integral samplings,
restart markers) as libjpeg(-turbo) does by default -- islow integer IDCT,
fancy upsampling, libjpeg's fixed-point YCbCr -> RGB -- so its pixels equal
that library's (and so Pillow's) bit for bit. Progressive, lossless,
hierarchical and arithmetic-coded files raise ``ValueError`` naming the
mode: Pillow would decode them, but scanners embed baseline JPEG.

``encode_jpeg`` writes baseline 4:4:4 or 4:2:0 files (Annex K tables at
libjpeg's quality scaling). It exists to make fixture photos where no other
encoder is installed; no entry point uses it.
"""

from __future__ import annotations

import ctypes

import numpy as np

from rtnr_tpu_torch.data import native


def jpeg_size(data: bytes):
    """(height, width, components) from the frame header."""
    lib = native.load()
    out = (ctypes.c_longlong * 3)()
    if lib.jpeg_probe(data, len(data), out) != 0:
        raise ValueError(f"cannot decode JPEG: {lib.jpeg_last_error().decode()}")
    return int(out[1]), int(out[0]), int(out[2])


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB (greyscale replicated to three
    channels, as Pillow's ``convert("RGB")``)."""
    data = bytes(data)
    h, w, _ = jpeg_size(data)
    rgb = np.empty((h, w, 3), np.uint8)
    lib = native.load()
    if lib.jpeg_decode(data, len(data), rgb.ctypes.data_as(ctypes.c_void_p)) != 0:
        raise ValueError(f"cannot decode JPEG: {lib.jpeg_last_error().decode()}")
    return rgb


def encode_jpeg(rgb: np.ndarray, quality: int = 95, subsampling: str = "4:2:0") -> bytes:
    """(H, W, 3) uint8 RGB -> baseline JPEG bytes; ``subsampling`` is
    "4:4:4" or "4:2:0"."""
    if subsampling not in ("4:4:4", "4:2:0"):
        raise ValueError(f"subsampling {subsampling!r}: 4:4:4 or 4:2:0")
    img = np.ascontiguousarray(rgb, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes (H, W, 3) uint8, not {img.shape}")
    h, w = img.shape[:2]
    cap = 2 * h * w * 3 + 65536
    out = np.empty(cap, np.uint8)
    lib = native.load()
    n = lib.jpeg_encode(img.ctypes.data_as(ctypes.c_void_p), w, h, int(quality),
                        int(subsampling == "4:2:0"), out.ctypes.data_as(ctypes.c_void_p), cap)
    if n < 0:
        raise ValueError(f"cannot encode JPEG: {lib.jpeg_last_error().decode()}")
    return out[:n].tobytes()
