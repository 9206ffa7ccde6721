"""A walk through a building of rooms: closed-loop viewer poses.

``loop`` lists the grid coordinates of rooms that neighbour one another in
turn, closing back on the first. The seed draws the way round (the loop as
listed or reversed, so the turns go to the one side or the other) and the
room it starts in. The camera stands at ``eye_height_m`` above the floor in
the centre of the start room, facing the next room; it walks there straight
through the door (a door is centred on the wall two rooms share, so the
centres and the door lie on one line), turns in place towards the room
after, and so on round the loop. Each frame moves ``step_m`` or turns
``yaw_step_deg`` at most. After the last room the loop starts again.

Every seed walks the same doors and makes the same turns, from another
start and the other way round for half the seeds, so every seed's frames
do the same kinds of work in another order.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from rtnr_bench.scenes import room_centers


def extrinsics(pos: np.ndarray, yaw: float) -> np.ndarray:
    """World -> camera (x right, y down, z forward) for a level camera at
    ``pos`` looking along ``yaw`` (radians, from +x towards +y; z is up)."""
    f = np.array([np.cos(yaw), np.sin(yaw), 0.0])
    r = np.cross(f, [0.0, 0.0, 1.0])
    d = np.cross(f, r)
    R = np.stack([r, d, f])
    E = np.eye(4)
    E[:3, :3] = R
    E[:3, 3] = -R @ pos
    return E


def _turn(out: List, pos, yaw, target, step):
    """Frames turning from ``yaw`` to ``target`` in steps of at most
    ``step``; returns the final yaw."""
    delta = (target - yaw + np.pi) % (2 * np.pi) - np.pi
    n = int(np.ceil(abs(delta) / step - 1e-9))
    for k in range(1, n + 1):
        out.append(extrinsics(pos, yaw + delta * k / n))
    return yaw + delta


def _walk(out: List, a, b, yaw, step):
    n = int(np.ceil(np.linalg.norm(b - a) / step - 1e-9))
    for k in range(1, n + 1):
        out.append(extrinsics(a + (b - a) * k / n, yaw))


def poses(config: Dict, params: Dict, seed: int) -> np.ndarray:
    """(F, 4, 4) float64 world-to-camera matrices of one round of the loop."""
    spec = config["scene"]
    nx = spec.get("grid", (1, 1))[0]
    centers = room_centers(spec)
    z = -spec["room_size"][2] / 2 + params["eye_height_m"]
    loop = [np.array([*centers[j * nx + i], z]) for i, j in params["loop"]]
    rng = np.random.default_rng(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    if rng.integers(2):
        loop = loop[::-1]
    start = int(rng.integers(len(loop)))
    loop = loop[start:] + loop[:start]
    step = float(params["step_m"])
    rot = np.deg2rad(params["yaw_step_deg"])
    heading = lambda a, b: float(np.arctan2(b[1] - a[1], b[0] - a[0]))
    yaw = heading(loop[0], loop[1])
    out = [extrinsics(loop[0], yaw)]
    for k, here in enumerate(loop):
        there, after = loop[(k + 1) % len(loop)], loop[(k + 2) % len(loop)]
        _walk(out, here, there, yaw, step)
        yaw = _turn(out, there, yaw, heading(there, after), rot)
    return np.stack(out[:-1])  # the last pose is the first one again
