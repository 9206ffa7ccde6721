"""The benchmark harness: one run of one cell, driven by data.

``BENCHMARK.json`` at the checkout's root names the cells, configurations,
traffic mixes and metrics. Everything that belongs to one of them is a file
of its own under ``rtnr_bench/``, found by its name:

- ``configs/<config>.json``: the configuration as it is run (scene,
  camera, U-Net, renderer or trainer settings) and the limits of the
  numbers that decide ``correct``;
- ``traffic/<traffic>.json``: the traffic's parameters; its ``runner``
  names ``runners/<runner>.py`` (the loop: frames or training steps) and
  its ``generator`` names ``traffic/<generator>.py`` (the poses);
- ``metrics/<metric>.py``: a reader ``read(run) -> float | None`` of one
  metric from the run's record (None: nothing to read in this run).

A run builds the system under test (the ``rtnr_tpu_torch`` package) from
the seed, warms up every shape the traffic uses, measures ``--seconds``
seconds, optionally traces a short window after it (``--trace 1``), frees
the program's state and holds the window's answers against the plain
reference in ``rtnr_bench/reference``.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH = "rtnr_bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "rtnr_tpu")


@dataclasses.dataclass
class Run:
    """What one run did, for the runner to fill and the metric readers to
    read."""

    name: str
    config: Dict
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    device: str
    root: Path
    t_start: float
    setup_s: Optional[float] = None
    scene_s: Optional[float] = None
    window_s: Optional[float] = None
    frames: List[Dict] = dataclasses.field(default_factory=list)
    steps: int = 0
    memory_peak_bytes: int = 0
    traced: Optional[Dict] = None
    checks: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def check(self, name: str, value: float) -> None:
        """Record a compared number beside its limit from the configuration."""
        self.checks[name] = {"value": float(value), "limit": float(self.config["limits"][name])}

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in self.checks.values())


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of the benchmark's folder by its file (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(f"_rtnr_bench_{path.parent.name}_"
                                                  f"{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find(root: Path, kind: str, name: str, suffix: str) -> Path:
    return root / BENCH / kind / f"{name}{suffix}"


def cell_metrics(manifest: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones without
    tracing, the per-layer ones with it; a metric with a ``workloads`` list
    only in those cells."""
    group = manifest["per_layer"] if trace else manifest["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def stray_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def prepare(args: argparse.Namespace, root: Path, device: str, t_start: float) -> Run:
    """The run's record, from the manifest and the files its cell names."""
    cell = find_cell(load_json(root / "BENCHMARK.json"), args.workload)
    config = load_json(find(root, "configs", cell["config"], ".json"))
    traffic = load_json(find(root, "traffic", cell["traffic"], ".json"))
    return Run(name=cell["name"], config=config, traffic=traffic, seed=args.seed,
               seconds=float(args.seconds), trace=bool(args.trace), device=device, root=root,
               t_start=t_start)


def find_cell(manifest: Dict, name: str) -> Dict:
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    return cells[name]


def device_info(run: Run, chips: int) -> Dict:
    if run.device == "cuda":
        import torch

        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                "memory_peak_bytes": int(run.memory_peak_bytes)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if run.trace and run.traced:
        info["busy_s"] = run.traced["busy_s"]
        info["window_s"] = run.traced["window_s"]
    return info


def execute(argv: Optional[List[str]] = None, *, root: Path = ROOT, device: str = "cuda",
            t_start: Optional[float] = None) -> Dict:
    """Run one cell; returns the result line's object (the caller prints
    it). ``device="cpu"`` is for the CPU tests: it skips the look for a
    chip."""
    t_start = time.time() if t_start is None else t_start
    args = parse(argv)
    root = Path(root)
    manifest = load_json(root / "BENCHMARK.json")
    cell = find_cell(manifest, args.workload)
    if device == "cuda":
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    try:
        import rtnr_tpu_torch  # noqa: F401  (the system under test)
    except ImportError as e:
        raise SystemExit(f"the program under test, rtnr_tpu_torch, is not importable: {e}")
    run = prepare(args, root, device, t_start)
    runner = load_module(find(root, "runners", run.traffic["runner"], ".py"))
    runner.run(run)
    metrics = {}
    for m in cell_metrics(manifest, args.workload, run.trace):
        value = load_module(find(root, "metrics", m["name"], ".py")).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": run.correct, "attempted": run.extra.get("attempted", 0),
              "failed": run.extra.get("failed", 0), "metrics": metrics,
              "device": device_info(run, cell["chips"])}
    if run.trace and run.traced:
        result["breakdown"] = {"device_ops": run.traced["device_ops"],
                               "idle_gaps": run.traced["idle_gaps"]}
    result["checks"] = run.checks
    print(f"set-up {run.setup_s!r} s (scene and program state {run.scene_s!r} s), window "
          f"{run.window_s!r} s, reference {run.extra.get('reference_s')!r} s", file=sys.stderr)
    return result


def main(argv: Optional[List[str]] = None, t_start: Optional[float] = None) -> int:
    try:
        result = execute(argv, t_start=t_start)
    except SystemExit as e:
        if e.code not in (None, 0):
            print(e.code if isinstance(e.code, str) else f"exit {e.code}", file=sys.stderr)
        return 2
    stray = stray_modules()
    if stray:
        print(f"refused: the run loaded {', '.join(stray)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
