"""The cost of the program's frame and step record (``rtnr_tpu_torch.utils.
trace``) on the card: a cell is built once, as its benchmark run builds it,
then the same frames (or training steps) run in turns with the record on
and off (``trace.enabled``), in the order on, off, off, on, on, off, ...,
so that a drift of the host or the card weighs on both sides alike; last,
one turn under the profiler (``trace.capture``) gives its own cost beside
the record's.

    python3 rtnr_bench/record_cost.py --workload building50m-int8-1080p.walk \
        --seed 11 --turns 8 --n 200

A walk turn renders the ``n`` poses after the warm-up, from the same pose
each turn; a training turn takes ``n`` steps on the same views, each
ending in a read of its loss. Each frame or step is timed on the host
clock, call to return, as the cell's window times it. One JSON line per
turn on standard output: the record on or off, the mean and median ms, the
mean stage times (walk: ``last_timings``) or the mean host ms of the
step's call before its loss read (steps) and, with the record on, the
mean of the record's own root host ms; then one line with the mean of the
on and of the off turns and each adjacent on / off pair's difference. Not
part of a benchmark run.
"""

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from rtnr_bench import harness  # noqa: E402

PROFILED = {"serve": 30, "train": 4}  # frames or steps of the profiled turn


def walk_turns(rec):
    """The walk's renderer built and warmed up: ``turn(k)``, which renders
    the ``k`` poses after the warm-up and gives each frame's ms and the mean
    stage times, and the scene's host arrays (held, as the cell's run holds
    them)."""
    runner = harness.load_module(harness.find(rec.root, "runners", rec.traffic["runner"], ".py"))
    renderer, cam, arrays, _ = runner.build(rec)
    gen = harness.load_module(harness.find(rec.root, "traffic", rec.traffic["generator"], ".py"))
    poses = gen.poses(rec.config, rec.traffic, rec.seed)
    w = rec.traffic["warmup_frames"]
    for i in range(w):
        renderer.compute_full(cam, poses[i % len(poses)])

    def turn(k: int):
        ms, st = [], [0.0, 0.0, 0.0]
        for i in range(w, w + k):
            t0 = time.perf_counter()
            renderer.compute_full(cam, poses[i % len(poses)])
            ms.append((time.perf_counter() - t0) * 1e3)
            lt = renderer.last_timings
            for j, v in enumerate((lt.projection_ms, lt.filter_ms, lt.unet_ms)):
                st[j] += v / k
        return ms, dict(zip(("projection_ms", "filter_ms", "unet_ms"), st))

    return turn, arrays


def train_turns(rec):
    """The training cell's state and step built and warmed up (its followed
    steps): ``turn(k)``, which takes ``k`` steps on the pool's first views
    and gives each step's ms and the mean host ms of the step's call (its
    launches, before the read of its loss), and the scene's host arrays."""
    runner = harness.load_module(harness.find(rec.root, "runners", rec.traffic["runner"], ".py"))
    state, step, feed, projs, targets, _, _, arrays, _ = runner.build(rec)
    box = [state]

    def go(i: int) -> float:
        """One step; the host ms of its call, before the read of its loss."""
        t0 = time.perf_counter()
        box[0], met = step(box[0], *feed, projs[i % len(projs)][None],
                           targets[i % len(targets)][None])
        t1 = time.perf_counter()
        float(met["loss"])
        return (t1 - t0) * 1e3

    for i in range(runner.FOLLOWED):
        go(i)

    def turn(k: int):
        ms, call = [], 0.0
        for i in range(k):
            t0 = time.perf_counter()
            call += go(i) / k
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms, {"call_ms": call}

    return turn, arrays


def main(argv=None, *, root: Path = harness.ROOT, device: str = "cuda") -> int:
    """``device="cpu"`` (with a ``root`` of tiny configurations) is for the
    CPU tests."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--turns", type=int, default=8)
    p.add_argument("--n", type=int, default=200, help="frames or steps a turn")
    a = p.parse_args(argv)
    import torch

    from rtnr_tpu_torch.utils import trace

    rec = harness.prepare(harness.parse(["--workload", a.workload, "--seed", str(a.seed),
                                         "--seconds", "0"]), Path(root), device, time.time())
    kind = rec.traffic["runner"]
    turn, held = (train_turns if kind == "train" else walk_turns)(rec)
    gpu = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    head = {"workload": a.workload, "gpu": gpu, "seed": a.seed}
    means = []
    for t in range(a.turns):
        on = t % 4 in (0, 3)
        was = trace.enabled(on)
        try:
            ms, stages = turn(a.n)
        finally:
            trace.enabled(was)
        line = {**head, "turn": t, "record": on, "n": len(ms), "mean_ms": statistics.fmean(ms),
                "median_ms": statistics.median(ms), **stages}
        if on:
            roots = trace.records(a.n)
            line["record_root_host_ms"] = statistics.fmean(r["host_ms"] for r in roots)
        means.append((on, line["mean_ms"]))
        print(json.dumps(line), flush=True)
    with tempfile.TemporaryDirectory() as d:
        with trace.capture(d, device=device):
            ms, stages = turn(PROFILED[kind])
    print(json.dumps({**head, "turn": a.turns, "record": True, "profiler": True, "n": len(ms),
                      "mean_ms": statistics.fmean(ms), "median_ms": statistics.median(ms),
                      **stages}), flush=True)
    on_ms = [m for on, m in means if on]
    off_ms = [m for on, m in means if not on]
    pairs = [means[i][1] - means[i + 1][1] if means[i][0] else means[i + 1][1] - means[i][1]
             for i in range(0, len(means) - 1, 2)]
    print(json.dumps({**head, "on_mean_ms": statistics.fmean(on_ms) if on_ms else None,
                      "off_mean_ms": statistics.fmean(off_ms) if off_ms else None,
                      "pair_on_minus_off_ms": pairs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
