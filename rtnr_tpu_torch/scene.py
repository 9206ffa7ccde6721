"""Scene container (copy of the parts of ``rtnr_tpu.scene`` the port uses).

A point cloud plus the 0.25 m uniform block grid of the reference
(include/Octreegrid.h:48-50, cloudreader.cpp:8-82). ``from_arrays``,
``synthetic``, ``decode_key``, ``block_bounds``, ``sorted_by_block`` and
``device_arrays`` are the same numpy code as the JAX package, so the block
keys, the block boxes (frustum culling) and the device point order match
bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from rtnr_tpu_torch.config import RenderConfig


@dataclasses.dataclass
class Scene:
    points: np.ndarray  # (N, 3) float32, world space
    colors: np.ndarray  # (N, 3) uint8, RGB
    block_keys: np.ndarray  # (N,) int32 voxel key per point
    num_blocks: Tuple[int, int, int]
    bb_min: np.ndarray  # (3,) float32 meter-rounded AABB min
    bb_max: np.ndarray  # (3,) float32 meter-rounded AABB max

    @property
    def n_points(self) -> int:
        return int(self.points.shape[0])

    @classmethod
    def from_arrays(
        cls,
        points: np.ndarray,
        colors: Optional[np.ndarray] = None,
        block_size_m: float = RenderConfig.block_size_m,
    ) -> "Scene":
        """Block grid over raw arrays: AABB rounded outward to whole meters,
        block count = extent / block size (truncated), key
        ``x + y*nx + z*nx*ny``."""
        points = np.ascontiguousarray(points, dtype=np.float32)
        n = points.shape[0]
        if colors is None:
            colors = np.zeros((n, 3), dtype=np.uint8)
        colors = np.ascontiguousarray(colors, dtype=np.uint8)
        if n == 0:
            return cls(
                points=points,
                colors=colors,
                block_keys=np.zeros((0,), np.int32),
                num_blocks=(1, 1, 1),
                bb_min=np.zeros(3, np.float32),
                bb_max=np.ones(3, np.float32),
            )

        bb_min = np.floor(points.min(axis=0)).astype(np.float32)
        bb_max = np.ceil(points.max(axis=0)).astype(np.float32)
        extent = np.maximum(bb_max - bb_min, np.float32(block_size_m))
        bb_max = bb_min + extent
        nb = np.maximum((extent / np.float32(block_size_m)).astype(np.int64), 1)

        rel = (points - bb_min) / extent
        idx = np.floor(rel * nb).astype(np.int64)
        idx = np.clip(idx, 0, nb - 1)
        keys = (idx[:, 0] + idx[:, 1] * nb[0] + idx[:, 2] * nb[0] * nb[1]).astype(np.int32)

        return cls(
            points=points,
            colors=colors,
            block_keys=keys,
            num_blocks=(int(nb[0]), int(nb[1]), int(nb[2])),
            bb_min=bb_min,
            bb_max=bb_max.astype(np.float32),
        )

    @classmethod
    def synthetic(
        cls,
        n_points: int = 100_000,
        seed: int = 0,
        extent: float = 10.0,
        block_size_m: float = RenderConfig.block_size_m,
    ) -> "Scene":
        """Uniform random coloured cloud in a cube of side ``extent``."""
        rng = np.random.default_rng(seed)
        pts = rng.uniform(-extent / 2, extent / 2, size=(n_points, 3)).astype(np.float32)
        cols = rng.integers(0, 256, size=(n_points, 3), dtype=np.uint8)
        return cls.from_arrays(pts, cols, block_size_m)

    def decode_key(self, key: np.ndarray) -> np.ndarray:
        """Linear key -> (x, y, z) block index (reference Octreegrid.h:116-121)."""
        nx, ny, _nz = self.num_blocks
        z = key // (nx * ny)
        rem = key - z * nx * ny
        y = rem // nx
        x = rem % nx
        return np.stack([x, y, z], axis=-1)

    def block_bounds(self, key: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Per-block AABB (reference cloudreader.cpp:62-80)."""
        nb = np.asarray(self.num_blocks, np.float32)
        size = (self.bb_max - self.bb_min) / nb
        xyz = self.decode_key(np.asarray(key)).astype(np.float32)
        lo = self.bb_min + xyz * size
        return lo, lo + size

    def sorted_by_block(self) -> "Scene":
        """Points reordered by block key (stable)."""
        order = np.argsort(self.block_keys, kind="stable")
        return Scene(
            points=self.points[order],
            colors=self.colors[order],
            block_keys=self.block_keys[order],
            num_blocks=self.num_blocks,
            bb_min=self.bb_min,
            bb_max=self.bb_max,
        )

    def device_arrays(
        self, pad_to_multiple: int = 8
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Renderer inputs: positions (N',3) f32, colors (N',3) f32, valid
        (N',) bool, with N padded to a multiple by masked-out points."""
        n = self.n_points
        n_pad = (-n) % pad_to_multiple
        pts = self.points
        cols = self.colors.astype(np.float32)
        valid = np.ones((n,), dtype=bool)
        if n_pad:
            pts = np.concatenate([pts, np.zeros((n_pad, 3), np.float32)], axis=0)
            cols = np.concatenate([cols, np.zeros((n_pad, 3), np.float32)], axis=0)
            valid = np.concatenate([valid, np.zeros((n_pad,), bool)])
        return np.ascontiguousarray(pts), np.ascontiguousarray(cols), valid
