"""The reference renderer's ``.oct`` scene cache, read and written in numpy.

Byte layout (reference Octreegrid.h:53-114; the JAX package's C++ ingest
library reads and writes the same bytes), little-endian:

- header: 4 x int32 ``nx, ny, nz, n_blocks``;
- per block, in ascending key order: int32 ``key``, uint64 ``n``,
  ``n * 3`` f32 points, ``n * 3`` u8 colours, 6 f32 bounds
  (``min xyz, max xyz`` of the block box).

``write_oct`` groups the points by block (stable, as ``Scene.sorted_by_block``)
and writes the same file as the JAX package's native ``write_oct``;
``read_oct`` returns the points in file order with each point's block key.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Tuple, Union

import numpy as np

_HEADER = struct.Struct("<4i")
_BLOCK = struct.Struct("<iQ")


def write_oct(path: Union[str, Path], scene) -> None:
    """Write a ``Scene`` as a reference-format .oct cache."""
    s = scene.sorted_by_block()
    keys_sorted = s.block_keys
    uniq, starts = np.unique(keys_sorted, return_index=True)
    ends = np.concatenate([starts[1:], [len(keys_sorted)]]).astype(np.int64)
    lo, hi = s.block_bounds(uniq)
    bb = np.ascontiguousarray(np.concatenate([lo, hi], axis=1), dtype="<f4")  # (B, 6)
    pts = np.ascontiguousarray(s.points, dtype="<f4")
    cols = np.ascontiguousarray(s.colors, dtype=np.uint8)
    nx, ny, nz = (int(v) for v in s.num_blocks)
    with open(path, "wb") as f:
        f.write(_HEADER.pack(nx, ny, nz, len(uniq)))
        for i, (a, b) in enumerate(zip(starts.tolist(), ends.tolist())):
            f.write(_BLOCK.pack(int(uniq[i]), b - a))
            f.write(pts[a:b].tobytes())
            f.write(cols[a:b].tobytes())
            f.write(bb[i].tobytes())


def read_oct(path: Union[str, Path]) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                               Tuple[int, int, int]]:
    """Read a reference-format .oct cache: (points (N,3) f32, colours (N,3)
    u8, keys (N,) i32, (nx, ny, nz)). Raises ``ValueError`` on a truncated
    file."""
    raw = Path(path).read_bytes()
    if len(raw) < _HEADER.size:
        raise ValueError(f"truncated .oct file {path}")
    nx, ny, nz, n_blocks = _HEADER.unpack_from(raw, 0)
    off = _HEADER.size
    spans = []  # (key, n, offset of the points)
    for _ in range(n_blocks):
        if off + _BLOCK.size > len(raw):
            raise ValueError(f"truncated .oct file {path}")
        key, n = _BLOCK.unpack_from(raw, off)
        off += _BLOCK.size
        spans.append((key, n, off))
        off += n * 15 + 24
        if off > len(raw):
            raise ValueError(f"truncated .oct file {path}")
    buf = np.frombuffer(raw, np.uint8)
    total = sum(n for _, n, _ in spans)
    pts = np.empty((total, 3), np.float32)
    cols = np.empty((total, 3), np.uint8)
    keys = np.empty((total,), np.int32)
    at = 0
    for key, n, o in spans:
        pts[at:at + n] = buf[o:o + 12 * n].view("<f4").reshape(n, 3)
        cols[at:at + n] = buf[o + 12 * n:o + 15 * n].reshape(n, 3)
        keys[at:at + n] = key
        at += n
    return pts, cols, keys, (int(nx), int(ny), int(nz))
