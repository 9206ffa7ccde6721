"""U-Net checkpoints: flax ``.msgpack`` files and the reference's torch
``.pth.tar``, read and written without flax or msgpack.

- ``save_msgpack`` / ``load_msgpack``: the file format of
  ``flax.serialization.msgpack_serialize`` / ``msgpack_restore``, which the
  JAX package's ``save_msgpack`` / ``load_msgpack`` use
  (``rtnr_tpu/utils/checkpoint.py:40-53``), through a small msgpack codec of
  the port's own: maps, str keys, bin, ints, floats, bools, nil, arrays, and
  flax's ext types 1 (ndarray) and 3 (numpy scalar), each encoded as the
  msgpack triple ``(shape, dtype name, C-order bytes)``. Map keys are written
  sorted, as flax's tree traversal writes them, so the port writes the same
  bytes as the JAX package for the same tree.
- flax splits an array of more than 2**30 bytes into a chunked map. No U-Net
  leaf comes near that (the widest, the bottleneck's 3x3x1024x1024 f32
  kernel, is 37.7 MB), so the port neither writes nor reads that form, and
  ``save_msgpack`` refuses such a leaf.
- ``load_unet_variables``: the JAX package's loader (``:72-82``) for a
  ``.pth`` / ``.pth.tar`` (``models.convert.load_torch_checkpoint``) or a
  ``.msgpack``. An Orbax directory raises: Orbax is not a port dependency.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Dict, Sequence, Tuple, Union

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_MAX_LEAF_BYTES = 2**30  # flax's MAX_CHUNK_SIZE


# ---------------------------------------------------------------------------
# msgpack encoding
# ---------------------------------------------------------------------------

def _pack_len(out: bytearray, n: int, fix: int, fix_max: int, codes: Tuple[int, ...]) -> None:
    """A length header: ``fix | n`` below ``fix_max``, else the 8-, 16- or
    32-bit form (``codes``; None where msgpack has none)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n <= 0xFF:
        out += struct.pack(">BB", codes[0], n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", codes[1], n)
    else:
        out += struct.pack(">BI", codes[2], n)


def _ndarray_bytes(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.fields is not None:
        raise ValueError(f"cannot serialise an array of dtype {a.dtype}")
    out = bytearray()
    _pack((tuple(int(d) for d in a.shape), a.dtype.name, a.tobytes("C")), out)
    return bytes(out)


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, np.ndarray):
        if obj.nbytes > _MAX_LEAF_BYTES:
            raise ValueError(f"an array of {obj.nbytes} bytes needs flax's chunked form, "
                             "which this writer does not produce")
        _pack_ext(out, _EXT_NDARRAY, _ndarray_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    elif isinstance(obj, int):
        if 0 <= obj < 0x80 or -32 <= obj < 0:
            out += struct.pack(">b" if obj < 0 else ">B", obj)
        elif obj >= 0:
            for code, fmt, top in ((0xCC, ">BB", 0xFF), (0xCD, ">BH", 0xFFFF),
                                   (0xCE, ">BI", 0xFFFFFFFF), (0xCF, ">BQ", 2**64 - 1)):
                if obj <= top:
                    out += struct.pack(fmt, code, obj)
                    break
        else:
            for code, fmt, low in ((0xD0, ">Bb", -0x80), (0xD1, ">Bh", -0x8000),
                                   (0xD2, ">Bi", -0x80000000), (0xD3, ">Bq", -2**63)):
                if obj >= low:
                    out += struct.pack(fmt, code, obj)
                    break
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(out, len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k in sorted(obj):
            _pack(k, out)
            _pack(obj[k], out)
    else:
        raise TypeError(f"cannot serialise {type(obj).__name__}")


# ---------------------------------------------------------------------------
# msgpack decoding
# ---------------------------------------------------------------------------

_FIXED = {  # code -> (struct format, size)
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


def _take(buf: bytes, off: int, n: int) -> Tuple[bytes, int]:
    if off + n > len(buf):
        raise ValueError("truncated msgpack data")
    return buf[off:off + n], off + n


def _length(buf: bytes, off: int, size: int) -> Tuple[int, int]:
    raw, off = _take(buf, off, size)
    return struct.unpack(_LEN[size], raw)[0], off


def _ext(code: int, data: bytes) -> Any:
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"msgpack ext type {code} is not a flax array")
    (shape, name, raw), _ = _unpack(data, 0, raw_str=True)
    if name == b"bfloat16":
        raise ValueError("bfloat16 leaves are not supported; save the checkpoint in float32")
    a = np.frombuffer(raw, dtype=np.dtype(name.decode())).reshape(shape, order="C")
    return a if code == _EXT_NDARRAY else a[()]


def _unpack(buf: bytes, off: int, raw_str: bool = False) -> Tuple[Any, int]:
    """One object at ``off``: (object, offset after it). ``raw_str`` leaves
    strings as bytes (the ndarray triple's dtype name)."""
    raw, off = _take(buf, off, 1)
    c = raw[0]
    if c <= 0x7F:
        return c, off
    if c >= 0xE0:
        return c - 0x100, off
    if c in _FIXED:
        fmt, size = _FIXED[c]
        raw, off = _take(buf, off, size)
        return struct.unpack(fmt, raw)[0], off
    if c == 0xC0:
        return None, off
    if c in (0xC2, 0xC3):
        return c == 0xC3, off
    if 0x80 <= c <= 0x8F or c in (0xDE, 0xDF):  # map
        n, off = (c & 0x0F, off) if c <= 0x8F else _length(buf, off, 2 if c == 0xDE else 4)
        d = {}
        for _ in range(n):
            k, off = _unpack(buf, off, raw_str)
            d[k], off = _unpack(buf, off, raw_str)
        return d, off
    if 0x90 <= c <= 0x9F or c in (0xDC, 0xDD):  # array
        n, off = (c & 0x0F, off) if c <= 0x9F else _length(buf, off, 2 if c == 0xDC else 4)
        items = []
        for _ in range(n):
            v, off = _unpack(buf, off, raw_str)
            items.append(v)
        return items, off
    if 0xA0 <= c <= 0xBF or c in (0xD9, 0xDA, 0xDB):  # str
        n, off = (c & 0x1F, off) if c <= 0xBF else _length(buf, off, {0xD9: 1, 0xDA: 2,
                                                                      0xDB: 4}[c])
        raw, off = _take(buf, off, n)
        return (raw if raw_str else raw.decode("utf-8")), off
    if c in (0xC4, 0xC5, 0xC6):  # bin
        n, off = _length(buf, off, {0xC4: 1, 0xC5: 2, 0xC6: 4}[c])
        return _take(buf, off, n)
    if c in (0xC7, 0xC8, 0xC9) or 0xD4 <= c <= 0xD8:  # ext
        if c >= 0xD4:
            n = 1 << (c - 0xD4)
        else:
            n, off = _length(buf, off, {0xC7: 1, 0xC8: 2, 0xC9: 4}[c])
        raw, off = _take(buf, off, 1)
        data, off = _take(buf, off, n)
        return _ext(struct.unpack(">b", raw)[0], data), off
    raise ValueError(f"unknown msgpack code 0x{c:02x}")


def msgpack_serialize(tree: Any) -> bytes:
    """The bytes of ``flax.serialization.msgpack_serialize(tree)`` for a tree
    of dicts, lists and numpy leaves (no leaf above 2**30 bytes)."""
    out = bytearray()
    _pack(tree, out)
    return bytes(out)


def msgpack_restore(data: bytes) -> Any:
    """The tree of ``flax.serialization.msgpack_restore(data)``: dicts with
    str keys, lists, and read-only numpy arrays over the file's bytes."""
    obj, off = _unpack(data, 0)
    if off != len(data):
        raise ValueError(f"{len(data) - off} bytes after the msgpack object")
    return obj


# ---------------------------------------------------------------------------
# U-Net variable checkpoints
# ---------------------------------------------------------------------------

def _numpy_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if hasattr(tree, "detach"):  # a torch tensor
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_msgpack(path: Union[str, Path], variables: Dict[str, Any]) -> None:
    """Single-file msgpack checkpoint of nested dicts of arrays (numpy or
    torch leaves), readable by flax's ``msgpack_restore``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(msgpack_serialize(_numpy_tree(variables)))


def load_msgpack(path: Union[str, Path]) -> Dict[str, Any]:
    return msgpack_restore(Path(path).read_bytes())


def load_unet_variables(path: Union[str, Path],
                        features: Sequence[int] = (64, 128, 256, 512)) -> Dict[str, Any]:
    """U-Net variables from a torch .pth/.pth.tar (converted at ``features``;
    the JAX loader always converts at the default widths) or a flax
    .msgpack, as nested numpy dicts (``Renderer``'s ``unet_variables``)."""
    path = Path(path)
    if path.is_dir():
        raise ValueError(f"{path} is a directory: Orbax checkpoints are not read by the port "
                         "(Orbax is not a port dependency); save the variables as .msgpack")
    if path.suffix in (".pth", ".tar") or path.name.endswith(".pth.tar"):
        from rtnr_tpu_torch.models.convert import load_torch_checkpoint

        return load_torch_checkpoint(str(path), features)
    return load_msgpack(path)
