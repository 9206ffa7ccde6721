"""Camera model, calibration files and trajectories (copy of ``rtnr_tpu.camera``).

The same float64 numpy math and the same file formats as the JAX package, so
both packages build the same projection matrix for a pose (reference
project_cloud.cu:318, ``camProj = K4 * E``) and read and write each other's
files:

- ``Camera`` mirrors the reference's ``CameraCalibration``
  (CameraCalibration.h:8-54): pinhole K, 5 OpenCV or 4 fisheye distortion
  parameters (stored; the projection is pure pinhole, render.cu:53-83), and
  the image size.
- Calibration files: COLMAP ``cameras.txt`` (OPENCV / OPENCV_FISHEYE,
  CameraCalibration.cpp:103-158), the plain matrix file
  (CameraCalibration.cpp:160-208) and the binary layout
  (CameraCalibration.cpp:262-285).
- ``Trajectory``: TUM lines ``timestamp tx ty tz qx qy qz qw`` (the
  reference example, main.cpp:32) and COLMAP ``images.txt``
  (``IMAGE_ID qw qx qy qz tx ty tz CAMERA_ID NAME``, README.md:92).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np


def quat_to_rotmat(qw: float, qx: float, qy: float, qz: float) -> np.ndarray:
    """Unit-normalized quaternion -> 3x3 rotation matrix.

    Same convention as the reference (PointCloudReader.cpp:53-69 and
    cv::Quatd in main.cpp:34-37): w-first Hamilton quaternion.
    """
    n = np.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
    a, b, c, d = qw / n, qx / n, qy / n, qz / n
    return np.array(
        [
            [1 - 2 * (c * c + d * d), 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), 1 - 2 * (b * b + d * d), 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), 1 - 2 * (b * b + c * c)],
        ],
        dtype=np.float64,
    )


def pose_from_quat_trans(
    qw: float, qx: float, qy: float, qz: float, tx: float, ty: float, tz: float
) -> np.ndarray:
    """4x4 rigid transform from quaternion + translation."""
    P = np.eye(4, dtype=np.float64)
    P[:3, :3] = quat_to_rotmat(qw, qx, qy, qz)
    P[0, 3], P[1, 3], P[2, 3] = tx, ty, tz
    return P


@dataclasses.dataclass
class Camera:
    """Pinhole camera intrinsics + stored (unused-in-projection) distortion.

    ``K`` is a 3x3 float64 intrinsics matrix; ``dists`` holds 5 OpenCV params
    (k1 k2 p1 p2 k3) or 4 fisheye params (k1..k4).
    """

    K: np.ndarray
    width: int = 640
    height: int = 480
    dists: Tuple[float, ...] = ()
    fisheye: bool = False

    # ---- accessors mirroring CameraCalibration.cpp:232-250 ----
    @property
    def fx(self) -> float:
        return float(self.K[0, 0])

    @property
    def fy(self) -> float:
        return float(self.K[1, 1])

    @property
    def cx(self) -> float:
        return float(self.K[0, 2])

    @property
    def cy(self) -> float:
        return float(self.K[1, 2])

    @classmethod
    def from_params(
        cls,
        fx: float,
        fy: float,
        cx: float,
        cy: float,
        width: int,
        height: int,
        dists: Sequence[float] = (),
        fisheye: bool = False,
    ) -> "Camera":
        K = np.eye(3, dtype=np.float64)
        K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy
        return cls(K=K, width=width, height=height, dists=tuple(dists), fisheye=fisheye)

    def scaled(self, new_width: int, new_height: int) -> "Camera":
        """Rescale intrinsics to a new resolution.

        Same math as reference CameraCalibration.cpp:54-70 (fx,cx scale by
        width ratio; fy,cy by height ratio; distortion copied unchanged).
        """
        sx = new_width / self.width
        sy = new_height / self.height
        K = self.K.copy()
        K[0, 0] *= sx
        K[0, 2] *= sx
        K[1, 1] *= sy
        K[1, 2] *= sy
        return Camera(K=K, width=new_width, height=new_height, dists=self.dists, fisheye=self.fisheye)

    def intrinsics4(self) -> np.ndarray:
        """K embedded into 4x4 (top-left 3x3, [3,3]=1) — the ``glm::mat4(K)``
        of reference project_cloud.cu:318."""
        K4 = np.eye(4, dtype=np.float64)
        K4[:3, :3] = self.K
        return K4

    def cam_proj(self, extrinsics: np.ndarray) -> np.ndarray:
        """Full 4x4 projection matrix M = K4 @ E (world -> pixel-homogeneous).

        Row 2 of M yields camera-space depth (K row 2 is [0,0,1]); the raster
        divides rows 0,1 by row 2. Matches the ``camProj`` construction at
        reference project_cloud.cu:318 (modulo its row/col-major juggling).
        """
        return (self.intrinsics4() @ np.asarray(extrinsics, dtype=np.float64)).astype(np.float64)

    # ---- text I/O ----
    def save_calibration(self, path: Union[str, Path]) -> None:
        """Plain matrix-file format writer (reference CameraCalibration.cpp:72-99)."""
        lines = [f"{self.width} {self.height}"]
        for r in range(3):
            lines.append(" ".join(repr(float(v)) for v in self.K[r]) + " ")
        lines.append(" ".join(repr(float(d)) for d in self.dists) + " ")
        lines.append(str(int(self.fisheye)))
        Path(path).write_text("\n".join(lines) + "\n")

    @classmethod
    def load_calibration(cls, path: Union[str, Path]) -> "Camera":
        """Load either COLMAP ``cameras.txt`` or the plain matrix format.

        Dispatch rule identical to the reference: a file whose name ends in
        ``cameras.txt`` is parsed as COLMAP (CameraCalibration.cpp:103);
        anything else as the matrix format (CameraCalibration.cpp:160-208).
        """
        path = Path(path)
        if path.name.endswith("cameras.txt"):
            return cls._load_colmap_cameras(path)
        return cls._load_matrix_file(path)

    # ---- binary I/O (reference CameraCalibration.cpp:262-285) ----
    def save_binary(self, path: Union[str, Path]) -> None:
        """Binary calibration writer, byte-compatible with the reference's
        ``CameraCalibration::save`` (CameraCalibration.cpp:262-273): row-major
        3x3 f64 K, u64 distortion count, f64 distortions, i32 width, i32
        height, u8 fisheye flag (little-endian / x86 layout)."""
        import struct

        buf = bytearray()
        buf += np.ascontiguousarray(self.K, dtype="<f8").tobytes()
        buf += struct.pack("<Q", len(self.dists))
        buf += np.asarray(self.dists, dtype="<f8").tobytes()
        buf += struct.pack("<ii?", int(self.width), int(self.height), bool(self.fisheye))
        Path(path).write_bytes(bytes(buf))

    @classmethod
    def load_binary(cls, path: Union[str, Path]) -> "Camera":
        """Binary calibration reader (reference CameraCalibration.cpp:275-285)."""
        import struct

        raw = Path(path).read_bytes()
        if len(raw) < 80:
            raise ValueError(f"truncated calibration file {path}")
        K = np.frombuffer(raw[:72], dtype="<f8").reshape(3, 3).copy()
        (dsize,) = struct.unpack_from("<Q", raw, 72)
        off = 80
        if len(raw) != off + 8 * dsize + 9:
            raise ValueError(f"truncated calibration file {path}")
        dists = tuple(np.frombuffer(raw[off : off + 8 * dsize], dtype="<f8").tolist())
        off += 8 * dsize
        width, height, fisheye = struct.unpack_from("<ii?", raw, off)
        return cls(K=K, width=width, height=height, dists=dists, fisheye=bool(fisheye))

    @classmethod
    def _load_colmap_cameras(cls, path: Path) -> "Camera":
        for line in Path(path).read_text().splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            # CAMERA_ID MODEL WIDTH HEIGHT fx fy cx cy <dists...>
            model = parts[1]
            if model not in ("OPENCV", "OPENCV_FISHEYE"):
                raise ValueError(f"Unsupported camera model: {model}")
            width, height = int(parts[2]), int(parts[3])
            fx, fy, cx, cy = (float(v) for v in parts[4:8])
            if model == "OPENCV_FISHEYE":
                dists = tuple(float(v) for v in parts[8:12])
                fisheye = True
            else:
                dists = tuple(float(v) for v in parts[8:13])
                fisheye = False
            return cls.from_params(fx, fy, cx, cy, width, height, dists, fisheye)
        raise ValueError(f"No valid camera data found in {path}")

    @classmethod
    def _load_matrix_file(cls, path: Path) -> "Camera":
        text = Path(path).read_text()
        lines = [ln for ln in text.splitlines()]
        # Token stream: width height then 9 K entries (possibly spread over
        # lines), then a distortion line (comma- or space-separated), then
        # the fisheye flag.
        tokens: List[str] = []
        line_of_token: List[int] = []
        for i, ln in enumerate(lines):
            for tok in ln.replace(",", " ").split():
                tokens.append(tok)
                line_of_token.append(i)
        if len(tokens) < 11:
            raise ValueError(f"Malformed calibration file {path}")
        width, height = int(float(tokens[0])), int(float(tokens[1]))
        K = np.array([float(t) for t in tokens[2:11]], dtype=np.float64).reshape(3, 3)
        # The reference reads the rest of the K line, then one full line of
        # distortion values, then the fisheye flag (CameraCalibration.cpp:175-187).
        dist_line_idx = line_of_token[10] + 1
        while dist_line_idx < len(lines) and not lines[dist_line_idx].strip():
            dist_line_idx += 1
        dist_line = lines[dist_line_idx].replace(",", " ")
        dists = tuple(float(v) for v in dist_line.split())
        rest = "\n".join(lines[dist_line_idx + 1 :]).split()
        fisheye = bool(int(rest[0])) if rest else False
        if fisheye and len(dists) != 4:
            raise ValueError(f"Fisheye camera expects 4 distortion parameters, got {len(dists)}")
        if not fisheye and len(dists) != 5:
            raise ValueError(f"Pinhole camera expects 5 distortion parameters, got {len(dists)}")
        return cls(K=K, width=width, height=height, dists=dists, fisheye=fisheye)


@dataclasses.dataclass
class TrajectoryEntry:
    frame_id: int
    pose: np.ndarray  # 4x4 cam-to-world
    filename: str


@dataclasses.dataclass
class Trajectory:
    """An ordered list of camera poses (cam-to-world 4x4).

    ``world_to_cam(i)`` gives the extrinsics the renderer consumes — the
    reference passes ``entry.pose.inv()`` (main.cpp:96).
    """

    entries: List[TrajectoryEntry]

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i: int) -> TrajectoryEntry:
        return self.entries[i]

    def world_to_cam(self, i: int) -> np.ndarray:
        return np.linalg.inv(self.entries[i].pose)

    def world_to_cam_all(self) -> np.ndarray:
        """(F, 4, 4) stack of world->cam extrinsics for batched rendering."""
        return np.stack([self.world_to_cam(i) for i in range(len(self))], axis=0)

    @classmethod
    def load(cls, path: Union[str, Path], fmt: str = "tum") -> "Trajectory":
        """Parse a trajectory file.

        fmt="tum":    ``timestamp tx ty tz qx qy qz qw`` per line — the format
                      the reference example implements (main.cpp:32).
        fmt="colmap": genuine COLMAP ``images.txt`` — records alternate a pose
                      line ``IMAGE_ID qw qx qy qz tx ty tz CAMERA_ID NAME``
                      with a POINTS2D line (``x y id ...``, possibly empty);
                      the POINTS2D lines are skipped. This is the order the
                      reference README documents (README.md:92). COLMAP stores
                      world-to-cam; we invert to keep ``pose`` cam-to-world
                      like the TUM path delivers. Files exported with only
                      pose lines (no POINTS2D rows) also parse: a line shaped
                      like a pose record is never consumed as points.
        """
        if fmt == "colmap":
            return cls._load_colmap_images(path)
        if fmt != "tum":
            raise ValueError(f"Unknown trajectory format: {fmt}")
        entries: List[TrajectoryEntry] = []
        frame_id = 0
        for raw in Path(path).read_text().splitlines():
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            frame_id += 1
            _ts, tx, ty, tz, qx, qy, qz, qw = (float(v) for v in parts[:8])
            pose = pose_from_quat_trans(qw, qx, qy, qz, tx, ty, tz)
            entries.append(
                TrajectoryEntry(frame_id=frame_id, pose=pose, filename=f"frame_{frame_id}.png")
            )
        return cls(entries=entries)

    @staticmethod
    def _looks_like_pose_line(parts: List[str]) -> bool:
        """True iff a token list matches ``IMAGE_ID qw..tz CAMERA_ID NAME``.

        A POINTS2D row is triplets of numbers (token count % 3 == 0, all
        numeric); a pose row has 10 tokens and typically a non-numeric
        trailing image name. Used only to tolerate pose-only exports."""
        if len(parts) < 10:
            return False
        try:
            int(parts[0])
            [float(v) for v in parts[1:8]]
            int(parts[8])
        except ValueError:
            return False
        try:
            float(parts[9])
        except ValueError:
            return True  # trailing image name
        return False

    @classmethod
    def _load_colmap_images(cls, path: Union[str, Path]) -> "Trajectory":
        entries: List[TrajectoryEntry] = []
        expecting_points = False
        for raw in Path(path).read_text().splitlines():
            line = raw.strip()
            if line.startswith("#"):
                continue
            parts = line.split()
            if expecting_points and not cls._looks_like_pose_line(parts):
                expecting_points = False  # POINTS2D row (possibly empty)
                continue
            if not line:
                continue
            qw, qx, qy, qz, tx, ty, tz = (float(v) for v in parts[1:8])
            w2c = pose_from_quat_trans(qw, qx, qy, qz, tx, ty, tz)
            entries.append(
                TrajectoryEntry(
                    frame_id=int(parts[0]),
                    pose=np.linalg.inv(w2c),
                    filename=parts[9] if len(parts) > 9 else f"frame_{parts[0]}.png",
                )
            )
            expecting_points = True
        return cls(entries=entries)
