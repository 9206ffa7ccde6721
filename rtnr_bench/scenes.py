"""Scan-shaped point clouds made on the device from a seed.

The recipe is the room of ``Scene.synthetic_room`` (the port's
``scene.py``), copied here so that the benchmark's inputs do not change
when the program's helper does: 70% of a room's points lie uniformly on
its walls, floor and ceiling (1 cm Gaussian scan noise on every
coordinate), 30% in ``n_clusters`` furniture blobs (centres inside 80% of
the floor plan, between the floor and 0.2 of the half height; 0.25 m
Gaussian spread), every point with a random RGB colour.

A building is a grid of such rooms, side by side, joined by door
openings (``door_width_m`` wide, ``door_height_m`` high, centred on each
wall two neighbouring rooms share). A wall with a door is sampled as the
three rectangles around the opening, so every room keeps its full point
count. z is up; a room's floor is at ``-size_z / 2``.

Everything is drawn with one ``torch.Generator`` on ``device`` in a few
bulk calls, so the same seed gives the same cloud on the same device.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

WALL_SHARE = 0.7


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    return g


def room_centers(spec: Dict) -> List[Tuple[float, float]]:
    """Floor-plan centres of the rooms, row by row: room (i, j) of a
    ``grid`` (nx, ny) is number ``j * nx + i``."""
    nx, ny = spec.get("grid", (1, 1))
    sx, sy, _ = spec["room_size"]
    return [((i - (nx - 1) / 2) * sx, (j - (ny - 1) / 2) * sy)
            for j in range(ny) for i in range(nx)]


def doors(spec: Dict) -> List[Tuple[int, int]]:
    """Pairs of neighbouring rooms (a, b), a < b; every pair has a door."""
    nx, ny = spec.get("grid", (1, 1))
    out = []
    for j in range(ny):
        for i in range(nx):
            a = j * nx + i
            if i + 1 < nx:
                out.append((a, a + 1))
            if j + 1 < ny:
                out.append((a, a + nx))
    return out


def _wall(fixed_axis: int, fixed: float, along: int, lo: float, hi: float, z0: float,
          z1: float, door_at, door_w: float, door_h: float) -> List[np.ndarray]:
    """Rectangles (origin, edge u, edge v) of one vertical wall, with a door
    opening centred at ``door_at`` along the wall if it is not None."""

    def rect(a0, a1, b0, b1):
        o = np.zeros(3)
        o[fixed_axis], o[along], o[2] = fixed, a0, b0
        u, v = np.zeros(3), np.zeros(3)
        u[along], v[2] = a1 - a0, b1 - b0
        return np.stack([o, u, v])

    if door_at is None:
        return [rect(lo, hi, z0, z1)]
    d0, d1 = door_at - door_w / 2, door_at + door_w / 2
    return [rect(lo, d0, z0, z1), rect(d1, hi, z0, z1), rect(d0, d1, z0 + door_h, z1)]


def _room_rects(center, size, door_sides: Sequence[str], door_w: float,
                door_h: float) -> List[np.ndarray]:
    cx, cy = center
    sx, sy, sz = size
    x0, x1, y0, y1, z0, z1 = cx - sx / 2, cx + sx / 2, cy - sy / 2, cy + sy / 2, -sz / 2, sz / 2
    rects = []
    for side, x in (("-x", x0), ("+x", x1)):
        rects += _wall(0, x, 1, y0, y1, z0, z1, cy if side in door_sides else None, door_w, door_h)
    for side, y in (("-y", y0), ("+y", y1)):
        rects += _wall(1, y, 0, x0, x1, z0, z1, cx if side in door_sides else None, door_w, door_h)
    for z in (z0, z1):
        rects.append(np.stack([np.array([x0, y0, z]), np.array([sx, 0.0, 0.0]),
                               np.array([0.0, sy, 0.0])]))
    return rects


def make_scene(spec: Dict, seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(points (N, 3) f32, colours (N, 3) uint8) on ``device``; N is
    ``points_per_room`` times the number of rooms."""
    g = generator(seed, device)
    size = tuple(float(v) for v in spec["room_size"])
    n_room = int(spec["points_per_room"])
    n_clusters = int(spec["n_clusters"])
    door_w, door_h = float(spec.get("door_width_m", 1.0)), float(spec.get("door_height_m", 2.1))
    noise, spread = float(spec["noise_m"]), float(spec["blob_sigma_m"])
    centers = room_centers(spec)
    sides: List[set] = [set() for _ in centers]
    nx = spec.get("grid", (1, 1))[0]
    for a, b in doors(spec):
        ax = "x" if b == a + 1 else "y"
        sides[a].add("+" + ax)
        sides[b].add("-" + ax)

    n_wall = int(n_room * WALL_SHARE)
    n_blob = n_room - n_wall
    rect_rows, counts = [], []
    for c, s in zip(centers, sides):
        rects = _room_rects(c, size, s, door_w, door_h)
        area = np.array([np.linalg.norm(r[1]) * np.linalg.norm(r[2]) for r in rects])
        k = (area / area.sum() * n_wall).astype(np.int64)
        k[-1] += n_wall - k.sum()
        rect_rows += rects
        counts += list(k)
    table = torch.from_numpy(np.stack(rect_rows).astype(np.float32)).to(device)  # (R, 3, 3)
    at = torch.repeat_interleave(torch.arange(len(counts), device=device),
                                 torch.tensor(counts, device=device))
    uv = torch.rand((at.numel(), 2), generator=g, device=device)
    walls = table[at, 0] + uv[:, :1] * table[at, 1] + uv[:, 1:] * table[at, 2]
    del uv
    walls += torch.randn(walls.shape, generator=g, device=device) * noise

    sx, sy, sz = size
    n_rooms = len(centers)
    lo = torch.tensor([[cx - 0.4 * sx, cy - 0.4 * sy, -sz / 2] for cx, cy in centers],
                      dtype=torch.float32, device=device)
    span = torch.tensor([0.8 * sx, 0.8 * sy, 0.4 * sz], dtype=torch.float32, device=device)
    u = torch.rand((n_rooms, n_clusters, 3), generator=g, device=device)
    blob_c = (lo[:, None, :] + u * span).reshape(-1, 3)
    per = np.full(n_clusters, n_blob // n_clusters)
    per[: n_blob % n_clusters] += 1
    which = torch.repeat_interleave(torch.arange(n_rooms * n_clusters, device=device),
                                    torch.tensor(np.tile(per, n_rooms), device=device))
    blobs = blob_c[which] + torch.randn((which.numel(), 3), generator=g, device=device) * spread
    points = torch.cat([walls, blobs])
    del walls, blobs
    colors = torch.randint(0, 256, (points.shape[0], 3), generator=g, device=device,
                           dtype=torch.uint8)
    return points.contiguous(), colors
