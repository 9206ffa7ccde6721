"""Training views inside one room: a pool of seeded camera poses.

Each pose stands uniformly inside the middle ``inner_share`` of the room's
floor plan, its eye ``eye_height_m`` (a [low, high] range) above the floor,
with a uniform yaw and a pitch uniform in +-``pitch_deg``. The training
cell steps through the pool in order and starts again after its end, so
every step renders a view of the room.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from rtnr_bench.scenes import room_centers


def extrinsics(pos: np.ndarray, yaw: float, pitch: float) -> np.ndarray:
    """World -> camera (x right, y down, z forward), z up in the world."""
    f = np.array([np.cos(yaw) * np.cos(pitch), np.sin(yaw) * np.cos(pitch), np.sin(pitch)])
    r = np.cross(f, [0.0, 0.0, 1.0])
    r /= np.linalg.norm(r)
    d = np.cross(f, r)
    R = np.stack([r, d, f])
    E = np.eye(4)
    E[:3, :3] = R
    E[:3, 3] = -R @ pos
    return E


def poses(config: Dict, params: Dict, seed: int) -> np.ndarray:
    spec = config["scene"]
    sx, sy, sz = spec["room_size"]
    cx, cy = room_centers(spec)[0]
    rng = np.random.default_rng(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    n = int(params["pool"])
    a = float(params["inner_share"]) / 2
    lo, hi = params["eye_height_m"]
    pos = np.stack([cx + rng.uniform(-a, a, n) * sx, cy + rng.uniform(-a, a, n) * sy,
                    -sz / 2 + rng.uniform(lo, hi, n)], axis=1)
    yaw = rng.uniform(-np.pi, np.pi, n)
    pitch = np.deg2rad(rng.uniform(-1, 1, n) * params["pitch_deg"])
    return np.stack([extrinsics(p, y, t) for p, y, t in zip(pos, yaw, pitch)])
