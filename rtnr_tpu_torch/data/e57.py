"""E57 LiDAR-scan ingest (counterpart of the JAX package's ``data/e57.py``).

Capability parity with the reference's libE57Format reader
(reference src/RTRenderer/src/PointCloudReader.cpp): multi-scan reads with
per-scan rigid transforms to world, cartesian AND spherical coordinates,
invalid-state filtering, color normalization against the scan's color
limits, and optional random skip decimation. Two deliberate divergences:

- The reference normalizes green and blue by the wrong ranges
  (colorBlueRange/colorRedRange mixups at PointCloudReader.cpp:262-263,
  281-282); we normalize each channel by its own range.
- Colors are RGB, not OpenCV BGR.

The ASTM E2807 container layer (XML section + CRC-32C pages + bitpack
compressed vectors + image blobs) is decoded by the port's host library
(``csrc/host/rtnr_e57.cpp``, loaded via data/native.py) — no external E57
library is needed. ``E57Reader`` is the high-level facade: per-scan world-frame
points/colors (``get_scan_cloud``) and embedded posed imagery
(``get_image`` — the reference's getImage, PointCloudReader.cpp:18-51,
including its K-from-pinhole math and extrinsics axis-flip convention at
:71-93). The scan-level math (spherical->cartesian, pose composition,
color limits, invalid masks) is pure Python below and tested without the
native lib; ``write_e57`` (data/e57_write.py) produces fixture files.
Embedded photos decode with the port's own baseline JPEG decoder
(data/jpeg.py, libjpeg's pixels bit for bit); progressive JPEG raises.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from rtnr_tpu_torch.camera import pose_from_quat_trans


def spherical_to_cartesian(
    azimuth: np.ndarray, elevation: np.ndarray, rng: np.ndarray
) -> np.ndarray:
    """E57 spherical -> cartesian (reference PointCloudReader.cpp:275-277)."""
    ce = np.cos(elevation)
    return np.stack(
        [rng * np.cos(azimuth) * ce, rng * np.sin(azimuth) * ce, rng * np.sin(elevation)],
        axis=1,
    )


def normalize_colors(
    red: np.ndarray,
    green: np.ndarray,
    blue: np.ndarray,
    limits: Optional[Dict[str, float]] = None,
) -> np.ndarray:
    """Scale scanner color channels to uint8 against their recorded limits
    (reference PointCloudReader.cpp:207-213, 261-263 — with the per-channel
    range bug fixed: each channel divides by ITS OWN range)."""
    if limits is None:
        limits = {}

    def norm(c, lo_key, hi_key):
        lo = float(limits.get(lo_key, 0.0))
        hi = float(limits.get(hi_key, 255.0))
        rngv = hi - lo if hi > lo else 1.0
        return np.clip((c.astype(np.float64) - lo) * 255.0 / rngv, 0, 255)

    return np.stack(
        [
            norm(red, "colorRedMinimum", "colorRedMaximum"),
            norm(green, "colorGreenMinimum", "colorGreenMaximum"),
            norm(blue, "colorBlueMinimum", "colorBlueMaximum"),
        ],
        axis=1,
    ).astype(np.uint8)


def assemble_scan(
    scan: Dict[str, np.ndarray],
    color_limits: Optional[Dict[str, float]] = None,
    skip: int = 0,
    rng_seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode one scan's field arrays to filtered world-frame points+colors.

    ``scan`` fields (all optional unless noted): cartesianX/Y/Z or
    sphericalAzimuth/Elevation/Range, cartesianInvalidState,
    sphericalInvalidState, colorRed/Green/Blue, and ``pose`` as
    (qw,qx,qy,qz,tx,ty,tz). ``skip`` reproduces the reference's random
    decimation stride (PointCloudReader.cpp:256).
    """
    if "cartesianX" in scan:
        pts = np.stack(
            [scan["cartesianX"], scan["cartesianY"], scan["cartesianZ"]], axis=1
        ).astype(np.float64)
        inv = scan.get("cartesianInvalidState")
    elif "sphericalAzimuth" in scan:
        pts = spherical_to_cartesian(
            np.asarray(scan["sphericalAzimuth"], np.float64),
            np.asarray(scan["sphericalElevation"], np.float64),
            np.asarray(scan["sphericalRange"], np.float64),
        )
        inv = scan.get("sphericalInvalidState")
    else:
        raise ValueError("Scan has neither cartesian nor spherical coordinates")

    n = pts.shape[0]
    keep = np.ones(n, bool) if inv is None else (np.asarray(inv) == 0)

    if skip > 0:
        # random stride decimation (reference: i += rand() % skip + 1)
        r = np.random.default_rng(rng_seed)
        sel = np.zeros(n, bool)
        i = 0
        while i < n:
            sel[i] = True
            i += int(r.integers(1, skip + 1))
        keep &= sel

    if "colorRed" in scan:
        cols = normalize_colors(
            np.asarray(scan["colorRed"]),
            np.asarray(scan["colorGreen"]),
            np.asarray(scan["colorBlue"]),
            color_limits,
        )
    else:
        cols = np.zeros((n, 3), np.uint8)

    pose = scan.get("pose")
    if pose is not None:
        P = pose_from_quat_trans(*pose)
        pts = pts @ P[:3, :3].T + P[:3, 3]

    return pts[keep].astype(np.float32), cols[keep]


class E57Reader:
    """High-level E57 facade over the native container decoder.

    Mirrors the reference's ``PointCloudReader`` surface
    (PointCloudReader.h:8-25): scan/image counts, per-scan world-frame
    clouds, and embedded posed images with pinhole intrinsics.
    """

    def __init__(self, path: Union[str, Path]):
        from rtnr_tpu_torch.data.native import NativeE57

        self._f = NativeE57(path)
        self.path = Path(path)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def scan_count(self) -> int:
        return self._f.scan_count

    @property
    def image_count(self) -> int:
        return self._f.image_count

    def get_scan_raw(self, i: int) -> Dict[str, np.ndarray]:
        """Decoded field arrays + pose tuple for ``assemble_scan``."""
        meta = self._f.meta["scans"][i]
        scan: Dict[str, np.ndarray] = {}
        for field in meta["fields"]:
            data = self._f.read_field(i, field)
            if field.endswith("InvalidState"):
                data = data.astype(np.int8)
            scan[field] = data
        if meta["pose"]["present"]:
            q = meta["pose"]["quaternion"]
            t = meta["pose"]["translation"]
            scan["pose"] = (q[0], q[1], q[2], q[3], t[0], t[1], t[2])
        return scan

    def get_scan_cloud(
        self, i: int, skip: int = 0, rng_seed: int = 0
    ) -> Tuple[np.ndarray, np.ndarray]:
        """One scan as filtered world-frame (points f32, colors u8) — the
        reference's getScanCloud (PointCloudReader.cpp:116-294)."""
        meta = self._f.meta["scans"][i]
        return assemble_scan(
            self.get_scan_raw(i),
            color_limits=meta.get("color_limits") or None,
            skip=skip,
            rng_seed=rng_seed,
        )

    def get_image(self, i: int) -> Tuple[np.ndarray, np.ndarray, "np.ndarray"]:
        """Embedded image i -> (rgb (H,W,3) uint8, world_to_cam 4x4, K 3x3).

        Reference getImage (PointCloudReader.cpp:18-51): K built from the
        pinhole representation (fx = focalLength/pixelWidth,
        fy = focalLength/pixelHeight, principal point direct), pose =
        (P_quat·diag(1,1,-1)·diag(1,-1,1)).inv() — the axis-flip convention
        of obtainCameraExtrinsics (PointCloudReader.cpp:71-93). Colors are
        RGB (the reference returns OpenCV BGR; documented divergence)."""
        from rtnr_tpu_torch.data.jpeg import decode_jpeg  # stands in for cv::imdecode

        meta = self._f.meta["images"][i]
        img = decode_jpeg(self._f.read_blob(i))

        K = np.eye(3, dtype=np.float64)
        if meta["pixel_width"]:
            K[0, 0] = meta["focal_length"] / meta["pixel_width"]
        if meta["pixel_height"]:
            K[1, 1] = meta["focal_length"] / meta["pixel_height"]
        K[0, 2] = meta["principal_point_x"]
        K[1, 2] = meta["principal_point_y"]

        q = meta["pose"]["quaternion"]
        t = meta["pose"]["translation"]
        P = pose_from_quat_trans(q[0], q[1], q[2], q[3], t[0], t[1], t[2])
        # axis flips: P·diag(1,1,-1,1)·diag(1,-1,1,1) == P·diag(1,-1,-1,1)
        P = P @ np.diag([1.0, -1.0, -1.0, 1.0])
        world_to_cam = np.linalg.inv(P)
        return img, world_to_cam, K


def read_e57(path: Union[str, Path]) -> Tuple[np.ndarray, np.ndarray]:
    """Read all scans of an .e57 file to world-frame (points, colors).

    Container decoding is native (``csrc/host/rtnr_e57.cpp``); everything
    above the raw field arrays goes through ``assemble_scan``.
    """
    with E57Reader(path) as f:
        all_pts: List[np.ndarray] = []
        all_cols: List[np.ndarray] = []
        for i in range(f.scan_count):
            pts, cols = f.get_scan_cloud(i)
            all_pts.append(pts)
            all_cols.append(cols)
    if not all_pts:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.uint8)
    return np.concatenate(all_pts), np.concatenate(all_cols)
