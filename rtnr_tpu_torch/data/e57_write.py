"""ASTM E2807 (.e57) container writer (counterpart of the JAX package's
``data/e57_write.py``, writing the same bytes for the same inputs).

Produces standard-layout E57 files: 48-byte header inside CRC-32C-protected
1024-byte pages, CompressedVector binary sections with bitpack-coded
Integer/ScaledInteger bytestreams and raw-IEEE Float bytestreams, blob
sections for embedded jpeg images, and the XML tree at the end of the file.

Primary uses: (1) synthetic test fixtures exercising the native reader
(``csrc/host/rtnr_e57.cpp``) against independently-constructed bytes, and (2)
exporting scenes + posed imagery to the same container the reference
consumes via libE57Format (reference PointCloudReader.cpp).

Layout notes (mirroring the spec, not any library's code):
- physical file = pages of 1020 payload bytes + 4-byte CRC-32C; "logical"
  offsets index payload bytes only; fileOffset attributes in the XML are
  PHYSICAL offsets of section starts.
- CompressedVector section: 32-byte header {u8 id=1, u8[7] zero,
  u64 sectionLogicalLength, u64 dataPhysicalOffset, u64 indexPhysicalOffset}
  then data packets {u8 type=1, u8 flags, u16 logicalLengthMinus1,
  u16 bytestreamCount, u16 lengths[...], buffers..., pad to 4}. Each
  field's bytestream is one continuous bit/byte stream split at byte
  granularity across packets (a record may straddle packets).
  indexPhysicalOffset is written 0: index packets only serve random seeks,
  which sequential readers (ours and the reference's loop,
  PointCloudReader.cpp:253) never use.
- Integer/ScaledInteger bitpack: (value - minimum) in
  ceil(log2(maximum - minimum + 1)) bits, LSB-first.
- Blob section: {u8 id=0, u8[7] zero, u64 sectionLogicalLength} + bytes.

The page checksums run in numpy over all pages at once, and the bitpack in
chunks of whole bytes, so a 5M-point scan writes in seconds; the bytes are
those of the byte-at-a-time loops they replace.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

_PAGE = 1024
_PAYLOAD = 1020
_E57_NS = "http://www.astm.org/COMMIT/E57/2010-e57-v1.0"

# CRC-32C (Castagnoli) table, reflected polynomial 0x82F63B78.
_CRC_TABLE = np.zeros(256, np.uint32)
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = 0x82F63B78 ^ (_c >> 1) if _c & 1 else _c >> 1
    _CRC_TABLE[_i] = _c


def _crc32c_rows(rows: np.ndarray) -> np.ndarray:
    """CRC-32C of each row of a (n, L) uint8 array: the table-driven
    byte loop, run down the columns for all rows at once."""
    c = np.full(rows.shape[0], 0xFFFFFFFF, np.uint32)
    for j in range(rows.shape[1]):
        c = _CRC_TABLE[(c ^ rows[:, j]) & 0xFF] ^ (c >> np.uint32(8))
    return c ^ np.uint32(0xFFFFFFFF)


def crc32c(data: bytes) -> int:
    return int(_crc32c_rows(np.frombuffer(bytes(data), np.uint8)[None])[0])


_PACK_CHUNK = 1 << 20  # records per bitpack chunk (a multiple of 8: chunks end on bytes)


def _pack_bits_lsb(values: np.ndarray, bits: int) -> bytes:
    """Bitpack unsigned values LSB-first at ``bits`` per record."""
    if bits == 0:
        return b""
    v = values.astype(np.uint64)
    shifts = np.arange(bits, dtype=np.uint64)
    out = []
    for a in range(0, len(v), _PACK_CHUNK):
        exploded = ((v[a:a + _PACK_CHUNK, None] >> shifts) & np.uint64(1)).astype(np.uint8)
        out.append(np.packbits(exploded.reshape(-1), bitorder="little").tobytes())
    return b"".join(out)


@dataclasses.dataclass
class E57Field:
    """One prototype field + its encoded data."""

    name: str
    kind: str  # "float" | "double" | "integer" | "scaled"
    data: np.ndarray
    minimum: int = 0
    maximum: int = 0
    scale: float = 1.0
    offset: float = 0.0

    def encode(self) -> bytes:
        if self.kind == "float":
            return np.asarray(self.data, "<f4").tobytes()
        if self.kind == "double":
            return np.asarray(self.data, "<f8").tobytes()
        if self.kind == "integer":
            raw = np.asarray(self.data, np.int64) - self.minimum
        elif self.kind == "scaled":
            raw = np.rint((np.asarray(self.data, np.float64) - self.offset) / self.scale).astype(
                np.int64
            ) - self.minimum
        else:
            raise ValueError(f"unknown field kind {self.kind}")
        if raw.min(initial=0) < 0 or raw.max(initial=0) > self.maximum - self.minimum:
            raise ValueError(f"field {self.name}: data outside [minimum, maximum]")
        return _pack_bits_lsb(raw, self._bits())

    def _bits(self) -> int:
        return int(self.maximum - self.minimum).bit_length()

    def prototype_xml(self) -> str:
        if self.kind in ("float", "double"):
            prec = ' precision="single"' if self.kind == "float" else ""
            return f'<{self.name} type="Float"{prec}/>'
        if self.kind == "integer":
            return f'<{self.name} type="Integer" minimum="{self.minimum}" maximum="{self.maximum}"/>'
        return (
            f'<{self.name} type="ScaledInteger" minimum="{self.minimum}" '
            f'maximum="{self.maximum}" scale="{float(self.scale)!r}" '
            f'offset="{float(self.offset)!r}"/>'
        )


@dataclasses.dataclass
class E57Scan:
    fields: List[E57Field]
    name: str = "scan"
    guid: str = "{00000000-0000-0000-0000-000000000000}"
    pose: Optional[Tuple[float, ...]] = None  # (qw qx qy qz tx ty tz)
    color_limits: Optional[Dict[str, float]] = None
    intensity_limits: Optional[Dict[str, float]] = None

    @property
    def record_count(self) -> int:
        return len(self.fields[0].data)


@dataclasses.dataclass
class E57Image:
    jpeg_bytes: bytes
    name: str = "image"
    pose: Optional[Tuple[float, ...]] = None  # (qw qx qy qz tx ty tz)
    image_width: int = 0
    image_height: int = 0
    focal_length: float = 0.0  # meters
    pixel_width: float = 1.0  # meters/pixel
    pixel_height: float = 1.0
    principal_point_x: float = 0.0  # pixels
    principal_point_y: float = 0.0


class _LogicalStream:
    """Accumulates logical bytes; paginates with CRCs on flush."""

    def __init__(self) -> None:
        self.buf = bytearray()

    def tell_logical(self) -> int:
        return len(self.buf)

    def tell_physical(self) -> int:
        n = len(self.buf)
        return (n // _PAYLOAD) * _PAGE + (n % _PAYLOAD)

    def write(self, b: bytes) -> None:
        self.buf += b

    def align(self, n: int) -> None:
        pad = (-len(self.buf)) % n
        self.buf += b"\0" * pad

    def paginate(self) -> bytes:
        data = bytes(self.buf)
        data += b"\0" * ((-len(data)) % _PAYLOAD)
        pages = np.frombuffer(data, np.uint8).reshape(-1, _PAYLOAD)
        crcs = _crc32c_rows(pages).astype("<u4").view(np.uint8).reshape(-1, 4)
        return np.concatenate([pages, crcs], axis=1).tobytes()


def _pose_xml(pose: Optional[Tuple[float, ...]]) -> str:
    if pose is None:
        return ""
    # builtin floats: numpy scalar repr would embed "np.float64(...)"
    qw, qx, qy, qz, tx, ty, tz = (float(v) for v in pose)
    return (
        '<pose type="Structure">'
        f'<rotation type="Structure"><w type="Float">{qw!r}</w><x type="Float">{qx!r}</x>'
        f'<y type="Float">{qy!r}</y><z type="Float">{qz!r}</z></rotation>'
        f'<translation type="Structure"><x type="Float">{tx!r}</x>'
        f'<y type="Float">{ty!r}</y><z type="Float">{tz!r}</z></translation>'
        "</pose>"
    )


def _limits_xml(tag: str, limits: Optional[Dict[str, float]], integer_keys: bool) -> str:
    if not limits:
        return ""
    parts = [f'<{tag} type="Structure">']
    for k, v in limits.items():
        if integer_keys and float(v).is_integer():
            parts.append(f'<{k} type="Integer">{int(v)}</{k}>')
        else:
            parts.append(f'<{k} type="Float">{float(v)!r}</{k}>')
    parts.append(f"</{tag}>")
    return "".join(parts)


def _write_compressed_vector(stream: _LogicalStream, scan: E57Scan) -> int:
    """Emit one CompressedVector section; returns its physical fileOffset."""
    stream.align(8)
    section_physical = stream.tell_physical()
    section_logical = stream.tell_logical()

    encoded = [f.encode() for f in scan.fields]
    n_streams = len(encoded)

    # Split the per-field byte streams across <=64KiB data packets.
    packets = bytearray()
    pos = [0] * n_streams
    max_packet = 1 << 16
    while any(pos[i] < len(encoded[i]) for i in range(n_streams)):
        header_len = 6 + 2 * n_streams
        budget = max_packet - header_len - 4  # leave room for pad-to-4
        remaining = [len(encoded[i]) - pos[i] for i in range(n_streams)]
        total_rem = sum(remaining)
        take = []
        for i in range(n_streams):
            share = remaining[i] if total_rem <= budget else max(
                1 if remaining[i] else 0, remaining[i] * budget // max(total_rem, 1)
            )
            take.append(min(share, remaining[i]))
        while sum(take) > budget:  # rounding guard
            j = int(np.argmax(take))
            take[j] -= 1
        body = bytearray()
        for i in range(n_streams):
            body += encoded[i][pos[i] : pos[i] + take[i]]
            pos[i] += take[i]
        length = header_len + len(body)
        padded = length + ((-length) % 4)
        pkt = bytearray()
        pkt += bytes([1, 0])  # type=data, flags
        pkt += (padded - 1).to_bytes(2, "little")
        pkt += n_streams.to_bytes(2, "little")
        for i in range(n_streams):
            pkt += take[i].to_bytes(2, "little")
        pkt += body
        pkt += b"\0" * (padded - length)
        packets += pkt

    # section header placeholder, then packets
    data_logical = section_logical + 32
    data_physical_of = lambda lo: (lo // _PAYLOAD) * _PAGE + (lo % _PAYLOAD)
    section_logical_length = 32 + len(packets)
    header = bytearray()
    header += bytes([1]) + b"\0" * 7
    header += section_logical_length.to_bytes(8, "little")
    header += data_physical_of(data_logical).to_bytes(8, "little")
    header += (0).to_bytes(8, "little")  # indexPhysicalOffset: unused (see module doc)
    stream.write(bytes(header))
    stream.write(bytes(packets))
    return section_physical


def _write_blob(stream: _LogicalStream, blob: bytes) -> int:
    stream.align(8)
    physical = stream.tell_physical()
    header = bytes([0]) + b"\0" * 7 + (16 + len(blob)).to_bytes(8, "little")
    stream.write(header)
    stream.write(blob)
    return physical


def write_e57(
    path: Union[str, Path],
    scans: Sequence[E57Scan],
    images: Sequence[E57Image] = (),
    guid: str = "{11111111-2222-3333-4444-555555555555}",
) -> None:
    stream = _LogicalStream()
    stream.write(b"\0" * 48)  # header patched at the end

    scan_offsets = [_write_compressed_vector(stream, s) for s in scans]
    blob_offsets = [_write_blob(stream, im.jpeg_bytes) for im in images]

    xml_parts = [
        f'<?xml version="1.0" encoding="UTF-8"?><e57Root type="Structure" xmlns="{_E57_NS}">',
        '<formatName type="String"><![CDATA[ASTM E57 3D Imaging Data File]]></formatName>',
        f'<guid type="String"><![CDATA[{guid}]]></guid>',
        '<versionMajor type="Integer">1</versionMajor>',
        '<versionMinor type="Integer">0</versionMinor>',
        '<data3D type="Vector" allowHeterogeneousChildren="1">',
    ]
    for s, off in zip(scans, scan_offsets):
        xml_parts.append('<vectorChild type="Structure">')
        xml_parts.append(f'<guid type="String"><![CDATA[{s.guid}]]></guid>')
        xml_parts.append(f'<name type="String"><![CDATA[{s.name}]]></name>')
        xml_parts.append(_pose_xml(s.pose))
        xml_parts.append(_limits_xml("colorLimits", s.color_limits, integer_keys=True))
        xml_parts.append(_limits_xml("intensityLimits", s.intensity_limits, integer_keys=False))
        xml_parts.append(
            f'<points type="CompressedVector" fileOffset="{off}" recordCount="{s.record_count}">'
        )
        xml_parts.append('<prototype type="Structure">')
        for f in s.fields:
            xml_parts.append(f.prototype_xml())
        xml_parts.append('</prototype><codecs type="Vector" allowHeterogeneousChildren="1"/>')
        xml_parts.append("</points></vectorChild>")
    xml_parts.append("</data3D>")
    if images:
        xml_parts.append('<images2D type="Vector" allowHeterogeneousChildren="1">')
        for im, off in zip(images, blob_offsets):
            xml_parts.append('<vectorChild type="Structure">')
            xml_parts.append(f'<name type="String"><![CDATA[{im.name}]]></name>')
            xml_parts.append(_pose_xml(im.pose))
            xml_parts.append('<pinholeRepresentation type="Structure">')
            xml_parts.append(
                f'<jpegImageBlob type="Blob" fileOffset="{off}" length="{len(im.jpeg_bytes)}"/>'
            )
            xml_parts.append(f'<imageWidth type="Integer">{int(im.image_width)}</imageWidth>')
            xml_parts.append(f'<imageHeight type="Integer">{int(im.image_height)}</imageHeight>')
            xml_parts.append(f'<focalLength type="Float">{float(im.focal_length)!r}</focalLength>')
            xml_parts.append(f'<pixelWidth type="Float">{float(im.pixel_width)!r}</pixelWidth>')
            xml_parts.append(f'<pixelHeight type="Float">{float(im.pixel_height)!r}</pixelHeight>')
            xml_parts.append(
                f'<principalPointX type="Float">{float(im.principal_point_x)!r}</principalPointX>'
            )
            xml_parts.append(
                f'<principalPointY type="Float">{float(im.principal_point_y)!r}</principalPointY>'
            )
            xml_parts.append("</pinholeRepresentation></vectorChild>")
        xml_parts.append("</images2D>")
    xml_parts.append("</e57Root>")
    xml = "".join(xml_parts).encode()

    stream.align(4)
    xml_physical = stream.tell_physical()
    stream.write(xml)

    data = bytearray(stream.paginate())
    header = bytearray()
    header += b"ASTM-E57"
    header += (1).to_bytes(4, "little")  # major
    header += (0).to_bytes(4, "little")  # minor
    header += len(data).to_bytes(8, "little")  # filePhysicalLength
    header += xml_physical.to_bytes(8, "little")
    header += len(xml).to_bytes(8, "little")
    header += _PAGE.to_bytes(8, "little")
    data[:48] = header
    # re-CRC page 0 (header patch invalidated its checksum)
    data[_PAYLOAD : _PAGE] = int(crc32c(bytes(data[:_PAYLOAD]))).to_bytes(4, "little")
    Path(path).write_bytes(bytes(data))


# ---------------------------------------------------------------------------
# Convenience builders
# ---------------------------------------------------------------------------
def scan_from_arrays(
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    pose: Optional[Tuple[float, ...]] = None,
    invalid: Optional[np.ndarray] = None,
    name: str = "scan",
    cartesian_scale: float = 0.0001,
    spherical: bool = False,
) -> E57Scan:
    """Build an E57Scan from (N,3) float points + optional (N,3) uint8 colors.

    ``cartesian_scale`` > 0 stores coordinates as ScaledInteger at that
    resolution (the common scanner encoding); 0 stores raw single Floats.
    ``spherical`` interprets ``points`` columns as (azimuth, elevation,
    range) instead of (x, y, z).
    """
    pts = np.asarray(points, np.float64)
    fields: List[E57Field] = []
    names = (
        ("sphericalAzimuth", "sphericalElevation", "sphericalRange")
        if spherical
        else ("cartesianX", "cartesianY", "cartesianZ")
    )
    for c, fname in enumerate(names):
        col = pts[:, c]
        if cartesian_scale > 0:
            raw = np.rint(col / cartesian_scale)
            lo, hi = int(raw.min(initial=0)), int(raw.max(initial=0))
            fields.append(
                E57Field(fname, "scaled", col, minimum=lo, maximum=hi, scale=cartesian_scale)
            )
        else:
            fields.append(E57Field(fname, "float", col))
    inv_name = "sphericalInvalidState" if spherical else "cartesianInvalidState"
    inv = np.zeros(len(pts), np.int64) if invalid is None else np.asarray(invalid, np.int64)
    fields.append(E57Field(inv_name, "integer", inv, minimum=0, maximum=2))
    limits = None
    if colors is not None:
        cols = np.asarray(colors)
        for c, fname in enumerate(("colorRed", "colorGreen", "colorBlue")):
            fields.append(E57Field(fname, "integer", cols[:, c].astype(np.int64), 0, 255))
        limits = {
            "colorRedMinimum": 0, "colorRedMaximum": 255,
            "colorGreenMinimum": 0, "colorGreenMaximum": 255,
            "colorBlueMinimum": 0, "colorBlueMaximum": 255,
        }
    return E57Scan(fields=fields, name=name, pose=pose, color_limits=limits)
