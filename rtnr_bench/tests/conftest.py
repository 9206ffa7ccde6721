"""Fixtures of the benchmark's CPU tests.

``tiny_root`` is a checkout-shaped directory holding a copy of the
benchmark's files (``BENCHMARK.json`` and the ``configs``, ``traffic``,
``runners`` and ``metrics`` folders) with every configuration cut to a
size the CPU runs in seconds: the same cells, metrics and code paths, at
64x32 pixels, a U-Net of widths (8, 16) on two pyramid levels (where the
static int8 path applies), and a few thousand points a room.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
FOLDERS = ("configs", "traffic", "runners", "metrics")
TINY_CAMERA = {"fx": 40.0, "fy": 40.0, "cx": 32.0, "cy": 16.0, "width": 64, "height": 32}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped without one")


def shrink(cfg: dict) -> dict:
    cfg = json.loads(json.dumps(cfg))
    cfg["camera"] = dict(TINY_CAMERA)
    scene = cfg["scene"]
    scene["points_per_room"] = 6000 if scene.get("grid", [1, 1]) != [1, 1] else 20000
    scene["grid"] = [2, 2] if scene.get("grid", [1, 1]) != [1, 1] else [1, 1]
    for key in ("render", "train"):
        if key in cfg:
            cfg[key]["unet_features"] = [8, 16]
            cfg[key]["pyramid_levels"] = 2
    if "train" in cfg:
        # the tiny net's own limits: bf16 against f32 reads higher at widths 8
        # and 16 (CPU, seeds 5, 7, 9, 11, 13, each leaf against its own norm:
        # output 0.0103-0.0136, gradient 0.106-0.160, update 0.067-0.204,
        # statistics 6.2e-4-2.1e-3; the fp8 control's output 0.119-0.168,
        # statistics 0.416-0.495; a leaf left unmoved reads 1)
        cfg["limits"].update(out_gap=0.04, grad_gap=0.3, update_gap=0.4, stats_gap=0.02)
    return cfg


def make_root(dst: Path) -> Path:
    (dst / "rtnr_bench").mkdir(parents=True)
    for f in FOLDERS:
        shutil.copytree(ROOT / "rtnr_bench" / f, dst / "rtnr_bench" / f)
    for p in (dst / "rtnr_bench" / "configs").glob("*.json"):
        p.write_text(json.dumps(shrink(json.loads(p.read_text())), indent=1))
    walk = dst / "rtnr_bench" / "traffic" / "walk.json"
    if walk.exists():
        t = json.loads(walk.read_text())
        t["loop"] = [[0, 0], [1, 0], [1, 1], [0, 1]]
        t["trace_frames"] = 3
        walk.write_text(json.dumps(t))
    steps = dst / "rtnr_bench" / "traffic" / "steps.json"
    if steps.exists():
        t = json.loads(steps.read_text())
        t["pool"], t["trace_steps"] = 5, 2
        steps.write_text(json.dumps(t))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    return dst


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path / "checkout")


@pytest.fixture
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)
