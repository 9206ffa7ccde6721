"""The readers of the program's frame and step record (``rtnr_bench/spans.py``
and its ten metrics) on synthetic records: the window picked by order, the
alignment check, the recompute-only mean; then the walk cell on the CPU
with ``--trace 1``, whose host-clock readers find their window."""

import json
from types import SimpleNamespace

import pytest

from rtnr_bench import harness, spans
from rtnr_bench.harness import load_module
from rtnr_bench.tests.conftest import ROOT
from rtnr_tpu_torch.utils import trace

WALK = ("cull.ms", "cull.recompute_ms", "projection.sort_ms", "copy.ms", "copy.gb_per_s",
        "frame.self_ms")
STEPS = ("step.render_ms", "step.forward_ms", "step.backward_ms", "step.optimizer_ms")


def reader(name):
    return load_module(ROOT / "rtnr_bench" / "metrics" / f"{name}.py").read


def frame(i, recomputed=0, device=True):
    """A synthetic frame record: stage times from ``i``, the cull span 1 ms
    (10 on a recompute), the sort 3, the copy 5 ms of 50 MB; 0.25 ms of the
    frame's 40 is no span's."""
    dev = (lambda ms: ms) if device else (lambda ms: None)
    kids = [("frame.cull", 10.0 if recomputed else 1.0, None),
            ("frame.projection", 10.0 + i, 10.0 + i), ("frame.filter", 4.0, 4.0 + i / 8),
            ("frame.unet", 3.0, 3.0), ("frame.wait", 1.0, None), ("frame.copy_out", 5.0, None)]
    own = 0.25
    total = sum(h for _, h, _ in kids) + own
    sp = [{"name": "frame", "id": 100 * i, "parent": None, "host_ms": total,
           "device_ms": dev(total)}]
    for j, (name, host, device_ms) in enumerate(kids):
        sp.append({"name": name, "id": 100 * i + j + 1, "parent": 100 * i, "host_ms": host,
                   "device_ms": dev(device_ms) if device_ms is not None else dev(host)})
        if name == "frame.projection":
            sp.append({"name": "projection.sort", "id": 100 * i + 50, "parent": 100 * i + j + 1,
                       "host_ms": 0.01, "device_ms": dev(3.0)})
    return {"name": "frame", "request": i, "host_ms": total, "device_ms": sp[0]["device_ms"],
            "counters": {"cull.recomputed": recomputed, "copy_out.bytes": 50_000_000},
            "spans": sp}


def timings(rec):
    ms = {sp["name"]: spans.stage_ms(sp) for sp in spans.children(rec)}
    return {"projection_ms": ms["frame.projection"], "filter_ms": ms["frame.filter"],
            "unet_ms": ms["frame.unet"]}


def step(i, device=True):
    parts = {"step.render": 5.0, "step.forward": 50.0, "step.backward": 100.0,
             "step.optimizer": 4.0 + i}
    sp = [{"name": "step", "id": 10 * i, "parent": None, "host_ms": 170.0, "device_ms": 170.0}]
    sp += [{"name": n, "id": 10 * i + j + 1, "parent": 10 * i, "host_ms": 1.0,
            "device_ms": ms if device else None} for j, (n, ms) in enumerate(parts.items())]
    return {"name": "step", "request": i, "host_ms": 170.0, "device_ms": 170.0,
            "counters": {}, "spans": sp}


@pytest.fixture
def record(monkeypatch):
    """Set the records ``trace.records()`` returns."""
    held = []
    monkeypatch.setattr(trace, "records", lambda last=None: list(held))
    return held


def walk_run(frames, trace_on=True, warmup=2, traced=3):
    return SimpleNamespace(frames=[timings(f) for f in frames], trace=trace_on,
                           traffic={"warmup_frames": warmup, "trace_frames": traced})


def test_walk_window_is_picked_by_order(record):
    earlier = [frame(i) for i in range(4)]  # an earlier run's frames in the same process
    warm = [frame(10 + i) for i in range(2)]
    window = [frame(20 + i, recomputed=int(i in (1, 4))) for i in range(6)]
    traced = [frame(30 + i, recomputed=1) for i in range(3)]
    record += earlier + warm + window + traced
    run = walk_run(window)
    assert [r["request"] for r in spans.walk_frames(run)] == [r["request"] for r in window]
    got = {m: reader(m)(run) for m in WALK}
    assert got["cull.ms"] == pytest.approx((4 * 1.0 + 2 * 10.0) / 6)
    assert got["cull.recompute_ms"] == pytest.approx(10.0)  # the recomputing frames only
    assert got["projection.sort_ms"] == pytest.approx(3.0)
    assert got["copy.ms"] == pytest.approx(5.0)
    assert got["copy.gb_per_s"] == pytest.approx(50e6 / 5e-3 / 1e9)
    assert got["frame.self_ms"] == pytest.approx(0.25)
    # the untraced run holds no traced frames after its window
    record[:] = earlier + warm + window
    assert spans.walk_frames(walk_run(window, trace_on=False)) is not None


def test_walk_readers_read_nothing_where_the_record_does_not_line_up(record):
    warm = [frame(10 + i) for i in range(2)]
    window = [frame(20 + i, recomputed=1) for i in range(4)]
    traced = [frame(30 + i) for i in range(3)]
    record += warm + window + traced
    run = walk_run(window)
    assert spans.walk_frames(run) is not None
    run.frames[2] = dict(run.frames[2], filter_ms=run.frames[2]["filter_ms"] + 1e-9)
    assert all(reader(m)(run) is None for m in WALK)
    # the traced frames missing: the window's place shifts by three frames
    record[:] = [frame(i) for i in range(3)] + warm + window
    assert spans.walk_frames(walk_run(window)) is None
    record[:] = window + traced  # too few frames
    assert spans.walk_frames(walk_run(window)) is None
    record[:] = warm + [frame(20 + i) for i in range(4)] + traced  # no recompute in the window
    run = walk_run(window)
    assert reader("cull.ms")(run) == pytest.approx(1.0)
    assert reader("cull.recompute_ms")(run) is None


def test_device_readers_read_nothing_off_the_card(record):
    warm = [frame(10 + i, device=False) for i in range(2)]
    window = [frame(20 + i, device=False) for i in range(3)]
    record += warm + window + [frame(30 + i, device=False) for i in range(3)]
    run = walk_run(window)
    assert reader("projection.sort_ms")(run) is None
    assert reader("copy.ms")(run) == pytest.approx(5.0)
    steps = [step(i, device=False) for i in range(3 + 5 + 2)]
    record[:] = steps
    run = SimpleNamespace(steps=5, trace=True, root=ROOT,
                          traffic={"runner": "train", "trace_steps": 2})
    assert all(reader(m)(run) is None for m in STEPS)


def test_step_readers_take_the_window_between_followed_and_traced(record):
    record += [step(i) for i in range(3 + 5 + 2)]
    run = SimpleNamespace(steps=5, trace=True, root=ROOT,
                          traffic={"runner": "train", "trace_steps": 2})
    assert [r["request"] for r in spans.train_steps(run)] == [3, 4, 5, 6, 7]
    got = {m: reader(m)(run) for m in STEPS}
    assert got == {"step.render_ms": 5.0, "step.forward_ms": 50.0, "step.backward_ms": 100.0,
                   "step.optimizer_ms": pytest.approx(4.0 + 5.0)}  # mean of 4 + (3..7)
    run.steps = 6  # the ring holds one step fewer than the run took
    assert all(reader(m)(run) is None for m in STEPS)


def test_a_program_without_the_record_reads_nothing(monkeypatch):
    monkeypatch.delattr(trace, "records")
    walk = walk_run([frame(1)])
    steps = SimpleNamespace(steps=1, trace=True, root=ROOT,
                            traffic={"runner": "train", "trace_steps": 1})
    assert all(reader(m)(walk) is None for m in WALK)
    assert all(reader(m)(steps) is None for m in STEPS)


def test_the_walk_cell_reads_its_window_on_the_cpu(tiny_root, one_thread):
    out = harness.execute(["--workload", "building50m-int8-1080p.walk", "--seed",
                           "3000000017", "--seconds", "0.5", "--trace", "1"], root=tiny_root,
                          device="cpu")
    assert out["correct"] is True
    m = {k: v["value"] for k, v in out["metrics"].items()}
    for name in ("cull.ms", "copy.ms", "copy.gb_per_s", "frame.self_ms"):
        assert name in m and m[name] >= 0, name
    assert "projection.sort_ms" not in m  # a device span: nothing off the card
    assert m["cull.ms"] + m["copy.ms"] + m["frame.self_ms"] <= m["entry.outside_stages_ms"]


def test_record_cost_runs_the_cell_in_turns(tiny_root, one_thread, capsys):
    from rtnr_bench import record_cost

    first = trace.records(1)[0]["request"] if trace.records(1) else 0
    assert record_cost.main(["--workload", "room5m-train-1080p.steps", "--seed", "7",
                             "--turns", "4", "--n", "2"], root=tiny_root, device="cpu") == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(x["turn"], x["record"], x["n"]) for x in lines[:4]] == \
        [(0, True, 2), (1, False, 2), (2, False, 2), (3, True, 2)]  # on, off, off, on
    assert all(x["mean_ms"] > 0 for x in lines[:4])
    assert "record_root_host_ms" in lines[0] and "record_root_host_ms" not in lines[1]
    assert lines[4]["profiler"] is True and lines[4]["n"] == record_cost.PROFILED["train"]
    assert len(lines[5]["pair_on_minus_off_ms"]) == 2
    assert lines[5]["on_mean_ms"] == pytest.approx((lines[0]["mean_ms"] + lines[3]["mean_ms"]) / 2)
    # the followed steps, the two turns with the record on and the profiled turn
    got = [r for r in trace.records() if r["request"] > first]
    assert len(got) == 3 + 2 + 2 + record_cost.PROFILED["train"]
