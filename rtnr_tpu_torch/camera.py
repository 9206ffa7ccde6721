"""Pinhole camera (copy of the parts of ``rtnr_tpu.camera`` the port uses).

``Camera.from_params``, ``intrinsics4`` and ``cam_proj`` are the same float64
numpy math as the JAX package, so both packages build the same projection
matrix for a pose (reference project_cloud.cu:318, ``camProj = K4 * E``).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Camera:
    """Pinhole intrinsics ``K`` (3x3 float64) plus image size. The JAX
    package also stores lens distortion, which its projection never reads."""

    K: np.ndarray
    width: int = 640
    height: int = 480

    @classmethod
    def from_params(cls, fx: float, fy: float, cx: float, cy: float, width: int,
                    height: int) -> "Camera":
        K = np.eye(3, dtype=np.float64)
        K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy
        return cls(K=K, width=width, height=height)

    @property
    def fx(self) -> float:
        return float(self.K[0, 0])

    @property
    def fy(self) -> float:
        return float(self.K[1, 1])

    def intrinsics4(self) -> np.ndarray:
        """K embedded into 4x4 (top-left 3x3, [3,3] = 1)."""
        K4 = np.eye(4, dtype=np.float64)
        K4[:3, :3] = self.K
        return K4

    def cam_proj(self, extrinsics: np.ndarray) -> np.ndarray:
        """World -> pixel-homogeneous projection ``M = K4 @ E`` (float64)."""
        return (self.intrinsics4() @ np.asarray(extrinsics, dtype=np.float64)).astype(np.float64)
