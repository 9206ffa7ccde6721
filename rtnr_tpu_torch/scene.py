"""Scene container: point cloud + uniform voxel block grid + cache (copy of
``rtnr_tpu.scene``).

The reference's "OctreeGrid" is a flat uniform voxel grid (reference
include/Octreegrid.h:16-180, cloudreader.cpp:8-82):

- 0.25 m blocks over the meter-rounded AABB, linear key
  ``x + y*nx + z*nx*ny`` (reference Octreegrid.h:48-50).
- Load-or-rebuild disk cache (reference cloudreader.cpp:180-216): a
  compressed ``pcd.npz`` with the JAX package's keys, so each package reads
  the other's cache; and the reference's binary ``.oct`` through the numpy
  reader and writer of ``data/oct.py``.
- Random per-block downsampling (reference Octreegrid.h:124-149), with the
  JAX package's seed semantics, so both keep the same rows.
- Flattening to contiguous position/color arrays for the renderer
  (reference Octreegrid.h:162-180).

The grid is a per-point int32 block key plus grid metadata; the block boxes
are the culling unit (``ops/culling.py``). Every function is the same numpy
code as the JAX package, so keys, boxes and the device point order match bit
for bit.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from rtnr_tpu_torch.config import RenderConfig


@dataclasses.dataclass
class Scene:
    points: np.ndarray  # (N, 3) float32, world space
    colors: np.ndarray  # (N, 3) uint8, RGB
    block_keys: np.ndarray  # (N,) int32 voxel key per point
    num_blocks: Tuple[int, int, int]  # grid dims (nx, ny, nz)
    bb_min: np.ndarray  # (3,) float32 meter-rounded AABB min
    bb_max: np.ndarray  # (3,) float32 meter-rounded AABB max

    @property
    def n_points(self) -> int:
        return int(self.points.shape[0])

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------
    @classmethod
    def from_arrays(
        cls,
        points: np.ndarray,
        colors: Optional[np.ndarray] = None,
        block_size_m: float = RenderConfig.block_size_m,
    ) -> "Scene":
        """Build the block grid over raw arrays.

        Mirrors reference cloudreader.cpp:8-82: AABB is rounded outward to
        whole meters (ceil/floor), block count = extent / 0.25 truncated,
        and each point maps to ``floor((p - bbMin) / extent * nBlocks)``.
        """
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
        # Guard degenerate axes (all points in one meter slab after rounding
        # still yields extent >= 1 because floor/ceil differ unless exactly
        # integral; force a minimum extent of one block).
        extent = np.maximum(bb_max - bb_min, np.float32(block_size_m))
        bb_max = bb_min + extent
        nb = np.maximum((extent / np.float32(block_size_m)).astype(np.int64), 1)

        rel = (points - bb_min) / extent  # in [0, 1]
        idx = np.floor(rel * nb).astype(np.int64)
        idx = np.clip(idx, 0, nb - 1)  # points exactly on bbMax land inside
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
        """Random colored cloud (the CPU-runnable baseline config)."""
        rng = np.random.default_rng(seed)
        pts = rng.uniform(-extent / 2, extent / 2, size=(n_points, 3)).astype(np.float32)
        cols = rng.integers(0, 256, size=(n_points, 3), dtype=np.uint8)
        return cls.from_arrays(pts, cols, block_size_m)

    @classmethod
    def synthetic_room(
        cls,
        n_points: int = 1_000_000,
        seed: int = 0,
        size: Tuple[float, float, float] = (12.0, 8.0, 3.0),
        n_clusters: int = 24,
        block_size_m: float = RenderConfig.block_size_m,
    ) -> "Scene":
        """Room-scan-shaped cloud: points on the six walls plus furniture-like
        blobs — the realistic LiDAR distribution where frustum culling on the
        block grid pays off (a camera inside the room never sees every wall),
        unlike ``synthetic``'s uniform box."""
        rng = np.random.default_rng(seed)
        sx, sy, sz = size
        n_wall = int(n_points * 0.7)
        n_blob = n_points - n_wall

        # areas of the 6 faces -> proportional point counts
        areas = np.array([sy * sz, sy * sz, sx * sz, sx * sz, sx * sy, sx * sy])
        counts = (areas / areas.sum() * n_wall).astype(int)
        counts[-1] += n_wall - counts.sum()
        faces = []
        for f, c in enumerate(counts):
            u = rng.uniform(0, 1, (c, 2))
            p = np.empty((c, 3), np.float32)
            axis = f // 2
            sign = f % 2
            dims = [d for d in range(3) if d != axis]
            p[:, dims[0]] = (u[:, 0] - 0.5) * size[dims[0]]
            p[:, dims[1]] = (u[:, 1] - 0.5) * size[dims[1]]
            p[:, axis] = (0.5 if sign else -0.5) * size[axis]
            # 1cm scan noise
            p += rng.normal(0, 0.01, p.shape).astype(np.float32)
            faces.append(p)
        centers = np.stack(
            [
                rng.uniform(-sx / 2 * 0.8, sx / 2 * 0.8, n_clusters),
                rng.uniform(-sy / 2 * 0.8, sy / 2 * 0.8, n_clusters),
                rng.uniform(-sz / 2, -sz / 2 * 0.2, n_clusters),
            ],
            axis=1,
        )
        per = np.full(n_clusters, n_blob // n_clusters)
        per[: n_blob % n_clusters] += 1
        blobs = [
            (c + rng.normal(0, 0.25, (k, 3))).astype(np.float32)
            for c, k in zip(centers, per)
        ]
        pts = np.concatenate(faces + blobs).astype(np.float32)
        cols = rng.integers(0, 256, size=(len(pts), 3), dtype=np.uint8)
        return cls.from_arrays(pts, cols, block_size_m)

    # ------------------------------------------------------------------
    # Disk cache (load-or-rebuild, like reference cloudreader.cpp:180-216)
    # ------------------------------------------------------------------
    CACHE_NAME = "pcd.npz"

    def save_cache(self, cache_dir: Union[str, Path]) -> Path:
        cache_dir = Path(cache_dir)
        cache_dir.mkdir(parents=True, exist_ok=True)
        out = cache_dir / self.CACHE_NAME
        np.savez_compressed(
            out,
            points=self.points,
            colors=self.colors,
            block_keys=self.block_keys,
            num_blocks=np.asarray(self.num_blocks, np.int64),
            bb_min=self.bb_min,
            bb_max=self.bb_max,
        )
        return out

    @classmethod
    def load_cache(cls, cache_dir: Union[str, Path]) -> Optional["Scene"]:
        f = Path(cache_dir) / cls.CACHE_NAME
        if not f.exists():
            return None
        z = np.load(f)
        return cls(
            points=z["points"],
            colors=z["colors"],
            block_keys=z["block_keys"],
            num_blocks=tuple(int(v) for v in z["num_blocks"]),
            bb_min=z["bb_min"],
            bb_max=z["bb_max"],
        )

    @classmethod
    def from_file(
        cls,
        path: Union[str, Path],
        cache_dir: Optional[Union[str, Path]] = None,
        block_size_m: float = RenderConfig.block_size_m,
    ) -> "Scene":
        """Load a cloud from .ply or .e57, with load-or-rebuild caching.

        Same dispatch-and-cache semantics as reference
        ``CloudReader::loadCloud`` (cloudreader.cpp:180-216); a cache hit
        never reads ``path``.
        """
        if cache_dir is not None:
            cached = cls.load_cache(cache_dir)
            if cached is not None:
                return cached
        path = Path(path)
        ext = path.suffix.lower()
        if ext == ".ply":
            from rtnr_tpu_torch.data.ply import read_ply

            pts, cols = read_ply(path)
        elif ext == ".e57":
            from rtnr_tpu_torch.data.e57 import read_e57

            pts, cols = read_e57(path)
        else:
            raise ValueError(f"File extension {ext} not supported. Only .e57 and .ply are supported.")
        scene = cls.from_arrays(pts, cols, block_size_m)
        if cache_dir is not None:
            scene.save_cache(cache_dir)
        return scene

    # ------------------------------------------------------------------
    # Reference-format .oct interop (numpy, data/oct.py)
    # ------------------------------------------------------------------
    @classmethod
    def from_oct(cls, path: Union[str, Path]) -> "Scene":
        """Load a cache written by the reference renderer (.oct binary,
        reference Octreegrid.h:82-114)."""
        from rtnr_tpu_torch.data.oct import read_oct

        pts, cols, keys, nb = read_oct(path)
        # Reconstruct the AABB the keys were built against: blocks are
        # 0.25 m (reference cloudreader.cpp:10) over a meter-rounded box.
        bb_min = np.floor(pts.min(axis=0)).astype(np.float32) if len(pts) else np.zeros(3, np.float32)
        bb_max = bb_min + np.asarray(nb, np.float32) * np.float32(RenderConfig.block_size_m)
        return cls(
            points=pts, colors=cols, block_keys=keys, num_blocks=nb,
            bb_min=bb_min, bb_max=bb_max,
        )

    def save_oct(self, path: Union[str, Path]) -> bool:
        """Write this scene as a reference-compatible .oct cache (True once
        written, as the JAX package's native writer returns)."""
        from rtnr_tpu_torch.data.oct import write_oct

        write_oct(path, self)
        return True

    # ------------------------------------------------------------------
    # Grid utilities
    # ------------------------------------------------------------------
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

    def downsample(self, keep_percentage: float, seed: int = 0) -> "Scene":
        """Random per-block decimation (reference Octreegrid.h:124-149).

        Keeps ``ceil-ish`` the same count per block as the reference:
        ``size - size*(1-keep)`` truncated.
        """
        rng = np.random.default_rng(seed)
        order = np.argsort(self.block_keys, kind="stable")
        keys_sorted = self.block_keys[order]
        # segment boundaries
        boundaries = np.flatnonzero(np.diff(keys_sorted)) + 1
        starts = np.concatenate([[0], boundaries])
        ends = np.concatenate([boundaries, [len(keys_sorted)]])
        keep_idx = []
        for s, e in zip(starts, ends):
            size = e - s
            remove = int(size * (1.0 - keep_percentage))
            sel = rng.permutation(size)[: size - remove]
            keep_idx.append(order[s:e][sel])
        if keep_idx:
            keep = np.concatenate(keep_idx)
        else:
            keep = np.zeros((0,), np.int64)
        return Scene(
            points=self.points[keep],
            colors=self.colors[keep],
            block_keys=self.block_keys[keep],
            num_blocks=self.num_blocks,
            bb_min=self.bb_min,
            bb_max=self.bb_max,
        )

    def sorted_by_block(self) -> "Scene":
        """Reorder points grouped by block key: the layout uploaded to the
        device (the flattening step of reference Octreegrid.h:162-180)."""
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
        """Flatten to renderer inputs: positions (N',3) f32, colors (N',3)
        f32, valid mask (N',) bool.

        Pads N up to a multiple; padded entries are masked out by ``valid``
        so they never contribute to any frame regardless of camera
        placement.
        """
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
