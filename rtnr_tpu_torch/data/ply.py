"""PLY point-cloud ingest and writer (copy of ``rtnr_tpu.data.ply``'s numpy
path).

Capability parity with the reference's tinyply-based ``loadPLY``
(reference cloudreader.cpp:122-177): requests vertex x/y/z (float) and
optional red/green/blue (uchar). Colors stay RGB here -- the reference
swaps to BGR only because it renders through OpenCV (cloudreader.cpp:168).

Supports ascii, binary_little_endian, and binary_big_endian PLY 1.0 with
arbitrary extra vertex properties (skipped) and non-vertex elements
(skipped). List properties in the vertex element are not supported (LiDAR
vertex clouds don't use them); faces after the vertex element are ignored.

The JAX package tries its C++ reader first and falls back to this numpy
reader; the port has only the numpy reader (a binary vertex element is one
``np.frombuffer``), and ``write_ply`` writes the same bytes as the JAX
package's.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np

_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


class _Element:
    def __init__(self, name: str, count: int):
        self.name = name
        self.count = count
        self.props: List[Tuple[str, str]] = []  # (name, dtype-code)
        self.has_list = False


def _parse_header(f) -> Tuple[List[_Element], str]:
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("Not a PLY file (missing 'ply' magic)")
    fmt = None
    elements: List[_Element] = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("Unexpected EOF in PLY header")
        tokens = line.decode("ascii", "replace").strip().split()
        if not tokens or tokens[0] == "comment" or tokens[0] == "obj_info":
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            elements.append(_Element(tokens[1], int(tokens[2])))
        elif tokens[0] == "property":
            if not elements:
                raise ValueError("property before element in PLY header")
            if tokens[1] == "list":
                elements[-1].has_list = True
                elements[-1].props.append((tokens[-1], "list:" + tokens[2] + ":" + tokens[3]))
            else:
                elements[-1].props.append((tokens[2], _DTYPES[tokens[1]]))
        elif tokens[0] == "end_header":
            break
    if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
        raise ValueError(f"Unsupported PLY format: {fmt}")
    return elements, fmt


def read_ply(path: Union[str, Path]) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Read (points (N,3) f32, colors (N,3) u8 or None) from a PLY file."""
    with open(path, "rb") as f:
        elements, fmt = _parse_header(f)
        vertex = next((e for e in elements if e.name == "vertex"), None)
        if vertex is None:
            raise ValueError("PLY has no vertex element")
        if vertex.has_list:
            raise ValueError("List properties on the vertex element are unsupported")

        endian = ">" if fmt == "binary_big_endian" else "<"
        names = [p[0] for p in vertex.props]
        for need in ("x", "y", "z"):
            if need not in names:
                raise ValueError(f"Missing vertex position property '{need}'")
        has_color = all(c in names for c in ("red", "green", "blue"))

        # Read elements in file order; only 'vertex' is materialized.
        data: Optional[np.ndarray] = None
        for e in elements:
            if fmt == "ascii":
                if e.name == "vertex":
                    rows = []
                    for _ in range(e.count):
                        rows.append(f.readline().split())
                    arr = np.asarray(rows)
                    rec = {}
                    for ci, (pname, code) in enumerate(e.props):
                        rec[pname] = arr[:, ci].astype(np.dtype(code))
                    data = rec
                else:
                    for _ in range(e.count):
                        f.readline()
            else:
                if e.has_list:
                    if e.name == "vertex":
                        raise ValueError("List properties on the vertex element are unsupported")
                    # variable-length rows: must walk them
                    for _ in range(e.count):
                        for pname, code in e.props:
                            if code.startswith("list:"):
                                _, cnt_t, item_t = code.split(":")
                                cnt = np.frombuffer(
                                    f.read(np.dtype(_DTYPES[cnt_t]).itemsize),
                                    dtype=endian + _DTYPES[cnt_t],
                                )[0]
                                f.read(int(cnt) * np.dtype(_DTYPES[item_t]).itemsize)
                            else:
                                f.read(np.dtype(code).itemsize)
                else:
                    dt = np.dtype([(p, endian + c) for p, c in e.props])
                    raw = f.read(dt.itemsize * e.count)
                    if len(raw) < dt.itemsize * e.count:
                        raise ValueError(f"Truncated PLY: element {e.name}")
                    if e.name == "vertex":
                        rec_arr = np.frombuffer(raw, dtype=dt)
                        data = {p: rec_arr[p] for p, _ in e.props}

        assert data is not None
        pts = np.stack(
            [data["x"].astype(np.float32), data["y"].astype(np.float32), data["z"].astype(np.float32)],
            axis=1,
        )
        cols = None
        if has_color:
            cols = np.stack(
                [data["red"], data["green"], data["blue"]], axis=1
            ).astype(np.uint8)
        return pts, cols


def write_ply(
    path: Union[str, Path],
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    binary: bool = True,
) -> None:
    """Write a minimal vertex-only PLY (test fixtures + interchange)."""
    n = points.shape[0]
    header = ["ply"]
    header.append("format binary_little_endian 1.0" if binary else "format ascii 1.0")
    header += [f"element vertex {n}", "property float x", "property float y", "property float z"]
    if colors is not None:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        pts = np.ascontiguousarray(points, np.float32)
        if binary:
            if colors is None:
                f.write(pts.tobytes())
            else:
                dt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                               ("red", "u1"), ("green", "u1"), ("blue", "u1")])
                rec = np.empty(n, dt)
                rec["x"], rec["y"], rec["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
                cols = np.ascontiguousarray(colors, np.uint8)
                rec["red"], rec["green"], rec["blue"] = cols[:, 0], cols[:, 1], cols[:, 2]
                f.write(rec.tobytes())
        else:
            cols = None if colors is None else np.ascontiguousarray(colors, np.uint8)
            lines = []
            for i in range(n):
                row = f"{pts[i,0]:.9g} {pts[i,1]:.9g} {pts[i,2]:.9g}"
                if cols is not None:
                    row += f" {cols[i,0]} {cols[i,1]} {cols[i,2]}"
                lines.append(row)
            f.write(("\n".join(lines) + "\n").encode("ascii"))
