"""The traffic and scene generators: deterministic for a seed, and drawing
what their documents say."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from rtnr_bench import scenes, weights
from rtnr_bench.traffic import building_walk, room_poses

BENCH = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 12345  # seeds may run past 32 signed bits


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def traffic(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def centres(E):
    return np.stack([-e[:3, :3].T @ e[:3, 3] for e in E])


def yaw(E):
    f = np.stack([e[2, :3] for e in E])  # the camera's forward axis in the world
    return np.arctan2(f[:, 1], f[:, 0])


def test_walk_is_deterministic_and_paced():
    cfg, tr = config("building50m-int8-1080p"), traffic("walk")
    a = building_walk.poses(cfg, tr, SEED)
    assert np.array_equal(a, building_walk.poses(cfg, tr, SEED))
    steps = np.linalg.norm(np.diff(centres(a), axis=0), axis=1)
    turns = np.abs((np.diff(yaw(a)) + np.pi) % (2 * np.pi) - np.pi)
    assert steps.max() <= tr["step_m"] + 1e-9
    assert np.rad2deg(turns.max()) <= tr["yaw_step_deg"] + 1e-9
    assert np.all((steps > 1e-9) | (turns > 1e-12)), "every frame moves or turns"
    floor = -cfg["scene"]["room_size"][2] / 2
    assert np.allclose(centres(a)[:, 2], floor + tr["eye_height_m"])


def test_walk_seeds_take_the_same_route():
    cfg, tr = config("building50m-int8-1080p"), traffic("walk")
    rounds = [building_walk.poses(cfg, tr, s) for s in (1, 3, 4, SEED)]
    a = rounds[0]
    for b in rounds[1:]:  # the same work, from another start or the other way round
        assert len(a) == len(b)
        assert np.allclose(sorted(centres(a)[:, 0]), sorted(centres(b)[:, 0]))
        assert np.allclose(sorted(centres(a)[:, 1]), sorted(centres(b)[:, 1]))
    assert len({tuple(np.round(centres(r)[0], 6)) for r in rounds}) > 1, "starts drawn"
    # a round closes on its first pose: one 90-degree turn a room, all to one side
    turns = [(np.diff(yaw(np.concatenate([r, r[:1]]))) + np.pi) % (2 * np.pi) - np.pi
             for r in rounds]
    assert {np.sign(t.sum()) for t in turns} == {-1.0, 1.0}, "both ways round"
    for t in turns:
        assert np.rad2deg(np.abs(t).sum()) == pytest.approx(360.0, abs=1e-6)
        assert np.mean(t != 0) == pytest.approx(4 * 90 / tr["yaw_step_deg"] / len(t))


def test_room_poses_deterministic_inside_the_room():
    cfg, tr = config("room5m-train-1080p"), traffic("steps")
    a = room_poses.poses(cfg, tr, SEED)
    assert np.array_equal(a, room_poses.poses(cfg, tr, SEED))
    assert len(a) == tr["pool"]
    c = centres(a)
    sx, sy, sz = cfg["scene"]["room_size"]
    assert np.all(np.abs(c[:, 0]) <= sx * tr["inner_share"] / 2)
    assert np.all(np.abs(c[:, 1]) <= sy * tr["inner_share"] / 2)
    lo, hi = tr["eye_height_m"]
    assert np.all((c[:, 2] >= -sz / 2 + lo) & (c[:, 2] <= -sz / 2 + hi))
    for e in a:  # rotations
        assert np.allclose(e[:3, :3] @ e[:3, :3].T, np.eye(3))


def small_building():
    spec = dict(config("building50m-int8-1080p")["scene"])
    spec.update(grid=[2, 2], points_per_room=4000)
    return spec


def test_scene_is_deterministic_with_doors():
    spec = small_building()
    p, c = scenes.make_scene(spec, SEED, "cpu")
    p2, c2 = scenes.make_scene(spec, SEED, "cpu")
    assert torch.equal(p, p2) and torch.equal(c, c2)
    assert p.shape == (4 * 4000, 3) and c.dtype == torch.uint8
    assert not torch.equal(p, scenes.make_scene(spec, SEED + 1, "cpu")[0])
    # the door between rooms 0 and 1 (x = 0, |y - cy| < 0.5, below 2.1 m) holds
    # no wall points: only scan noise and furniture reach into it
    sx, sy, sz = spec["room_size"]
    cy = scenes.room_centers(spec)[0][1]
    wall = p[: int(4 * 4000 * scenes.WALL_SHARE)]
    z0 = -sz / 2
    in_door = ((wall[:, 0].abs() < 0.03) & ((wall[:, 1] - cy).abs() < 0.45)
               & (wall[:, 2] > z0 + 0.05) & (wall[:, 2] < z0 + 2.05))
    assert int(in_door.sum()) == 0
    assert len(scenes.doors(spec)) == 4


def test_weights_deterministic_in_the_flax_layout():
    a = weights.unet_variables(SEED, (8, 16), "cpu")
    b = weights.unet_variables(SEED, (8, 16), "cpu")
    assert a["params"]["down0"]["conv0"]["kernel"].shape == (3, 3, 5, 8)
    assert a["params"]["up0"]["kernel"].shape == (2, 2, 32, 16)
    assert a["params"]["final_conv"]["kernel"].shape == (1, 1, 8, 3)
    for k in ("params", "batch_stats"):
        for name in a[k]:
            for leaf in a[k][name]:
                x, y = a[k][name][leaf], b[k][name][leaf]
                if isinstance(x, dict):
                    for kk in x:
                        assert np.array_equal(x[kk], y[kk])
                else:
                    assert np.array_equal(x, y)
    var = a["batch_stats"]["down0"]["bn0"]["var"]
    assert var.min() >= 0.8 and var.max() <= 1.2
    full = weights.unet_variables(SEED, (64, 128, 256, 512), "cpu")["params"]
    leaves = lambda t: [x for v in t.values() for x in (leaves(v) if isinstance(v, dict) else [v])]
    assert sum(a.size for a in leaves(full)) == pytest.approx(31.04e6, rel=0.01)
