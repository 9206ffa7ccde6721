"""ctypes bindings over the port's host library (``csrc/host``).

Counterpart of the E57 part of the JAX package's ``data/native.py``, over
the port's own copy of its C++ E57 container decoder. The same library
holds the JPEG codec (``data/jpeg.py``). PLY and ``.oct`` files are read and
written in numpy (``data/ply.py``, ``data/oct.py``), with the same results
as the JAX package's C readers.

``load()`` builds the library with g++ at first use (``_build.build_host``)
and raises if it cannot: there is no quiet fallback.
"""

from __future__ import annotations

import ctypes
import json
import numpy as np

from rtnr_tpu_torch import _build

_c = ctypes


def _bind(lib: ctypes.CDLL) -> None:
    lib.e57_open.restype = _c.c_void_p
    lib.e57_open.argtypes = [_c.c_char_p]
    lib.e57_close.restype = None
    lib.e57_close.argtypes = [_c.c_void_p]
    lib.e57_meta.restype = _c.c_char_p
    lib.e57_meta.argtypes = [_c.c_void_p]
    lib.e57_last_error.restype = _c.c_char_p
    lib.e57_last_error.argtypes = []
    lib.e57_read_field_f64.restype = _c.c_int
    lib.e57_read_field_f64.argtypes = [_c.c_void_p, _c.c_int, _c.c_char_p, _c.c_void_p]
    lib.e57_read_blob.restype = _c.c_int
    lib.e57_read_blob.argtypes = [_c.c_void_p, _c.c_int, _c.c_void_p]
    lib.jpeg_last_error.restype = _c.c_char_p
    lib.jpeg_last_error.argtypes = []
    lib.jpeg_probe.restype = _c.c_int
    lib.jpeg_probe.argtypes = [_c.c_char_p, _c.c_longlong, _c.POINTER(_c.c_longlong)]
    lib.jpeg_decode.restype = _c.c_int
    lib.jpeg_decode.argtypes = [_c.c_char_p, _c.c_longlong, _c.c_void_p]
    lib.jpeg_encode.restype = _c.c_longlong
    lib.jpeg_encode.argtypes = [_c.c_void_p, _c.c_int, _c.c_int, _c.c_int, _c.c_int,
                                _c.c_void_p, _c.c_longlong]


def load() -> ctypes.CDLL:
    """The host library, built with g++ at first use; raises RuntimeError
    with the compiler's output if the build fails."""
    return _build.load_host(_bind)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_c.c_void_p)


class NativeE57:
    """Handle-owning wrapper over the native E57 container reader
    (``csrc/host/rtnr_e57.cpp``). ``meta`` is the parsed JSON description;
    field reads return float64 arrays (libE57 doConversion=true semantics,
    which the reference relies on -- PointCloudReader.cpp:116-294)."""

    def __init__(self, path):
        self._lib = load()
        self._h = self._lib.e57_open(str(path).encode())
        if not self._h:
            raise ValueError(
                f"cannot open E57 file {path}: {self._lib.e57_last_error().decode()}")
        self.meta = json.loads(self._lib.e57_meta(self._h).decode())

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.e57_close(self._h)
            self._h = None

    def __del__(self):  # noqa: D105
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def scan_count(self) -> int:
        return len(self.meta["scans"])

    @property
    def image_count(self) -> int:
        return len(self.meta["images"])

    def read_field(self, scan: int, field: str) -> np.ndarray:
        n = int(self.meta["scans"][scan]["record_count"])
        out = np.empty(n, np.float64)
        rc = self._lib.e57_read_field_f64(self._h, scan, field.encode(), _ptr(out))
        if rc != 0:
            raise ValueError(
                f"E57 field read failed (scan {scan}, field {field}, rc={rc}): "
                f"{self._lib.e57_last_error().decode()}")
        return out

    def read_blob(self, image: int) -> bytes:
        n = int(self.meta["images"][image]["blob_length"])
        out = np.empty(n, np.uint8)
        rc = self._lib.e57_read_blob(self._h, image, _ptr(out))
        if rc != 0:
            raise ValueError(f"E57 blob read failed (image {image}, rc={rc})")
        return out.tobytes()
