"""The port's frame and step record (``rtnr_tpu_torch.utils.trace``): the
recorder itself (nesting, ids, counters, the ring, the switch, the profiler's
annotations), and what ``Renderer`` and the training step put in it on the
CPU; one test on the card. It imports neither JAX nor the JAX package:

    python -m pytest --noconftest -q tests/test_torch_record.py
"""

import json

import numpy as np
import pytest
import torch

from rtnr_tpu_torch.apps.render_trajectory import main as cli_main
from rtnr_tpu_torch.apps.render_trajectory import record_line
from rtnr_tpu_torch.camera import Camera
from rtnr_tpu_torch.config import RenderConfig
from rtnr_tpu_torch.models.convert import init_unet_numpy
from rtnr_tpu_torch.pipeline import Renderer
from rtnr_tpu_torch.scene import Scene
from rtnr_tpu_torch.train import trainer as tt
from rtnr_tpu_torch.utils import trace
from torch_threads import one_thread  # noqa: F401 (autouse: torch on one thread)

FEAT = (8, 16)
FRAME_CHILDREN = ["frame.cull", "frame.projection", "frame.filter", "frame.unet", "frame.wait",
                  "frame.copy_out"]
PROJECTION_CHILDREN = ["projection.sort"]
STEP_CHILDREN = ["step.render", "step.forward", "step.backward", "step.optimizer"]


def _last_id():
    last = trace.records(1)
    return last[0]["request"] if last else 0


def _since(first_excluded):
    return [r for r in trace.records() if r["request"] > first_excluded]


def _children(rec, parent_id):
    return [sp for sp in rec["spans"] if sp["parent"] == parent_id]


def _named(rec, name):
    (sp,) = [sp for sp in rec["spans"] if sp["name"] == name]
    return sp


@pytest.fixture(scope="module")
def room():
    scene = Scene.synthetic_room(40_000, seed=4)
    cam = Camera.from_params(80.0, 80.0, 48, 32, 96, 64)
    poses = []
    for dx in (0.0, 0.2, 2.0, 2.1):  # reuse, then recompute beyond the 0.5 m radius
        E = np.eye(4)
        E[2, 3] = 3.5
        E[0, 3] = dx
        poses.append(E)
    return scene, cam, poses


@pytest.fixture(scope="module")
def renderer(room):
    scene, _, _ = room
    cfg = RenderConfig(unet_features=FEAT, pyramid_levels=2)
    return Renderer(scene, cfg, init_unet_numpy(1, FEAT), cull_budget="auto", device="cpu")


def test_spans_nest_with_ids_and_counters_per_request():
    first = _last_id()
    for k in range(2):
        with trace.span("req", root=True) as root:
            trace.count("n", 2)
            with trace.span("a") as a:
                with trace.span("a.b") as b:
                    trace.count("n", 3)
            with trace.span("c") as c:
                trace.count("m")
    trace.count("n", 100)  # no request open: counted nowhere
    recs = _since(first)
    assert [r["name"] for r in recs] == ["req", "req"]
    assert recs[0]["request"] < recs[1]["request"]
    for rec in recs:
        names = [sp["name"] for sp in rec["spans"]]
        assert names == ["req", "a", "a.b", "c"]
        ids = {sp["name"]: sp["id"] for sp in rec["spans"]}
        assert [sp["parent"] for sp in rec["spans"]] == [None, ids["req"], ids["a"], ids["req"]]
        assert {sp["request"] for sp in rec["spans"]} == {rec["request"]}
        assert rec["counters"] == {"n": 5, "m": 1}
        for sp in rec["spans"]:
            assert sp["end"] >= sp["start"] and sp["host_ms"] >= 0
            assert sp["device_ms"] is None  # off the card
        a_, b_ = _named(rec, "a"), _named(rec, "a.b")
        assert a_["start"] <= b_["start"] and b_["end"] <= a_["end"]
        assert rec["host_ms"] == rec["spans"][0]["host_ms"]
    assert (root.request, a.request, b.request, c.request) == (recs[1]["request"],) * 4
    assert len({sp["id"] for rec in recs for sp in rec["spans"]}) == 8


def test_a_root_inside_a_request_is_a_child_and_spans_outside_keep_nothing():
    first = _last_id()
    with trace.span("outside") as lone:
        pass
    with trace.span("outer", root=True):
        with trace.span("inner", root=True):
            pass
    recs = _since(first)
    assert [[sp["name"] for sp in r["spans"]] for r in recs] == [["outer", "inner"]]
    assert not isinstance(lone, trace.Span)  # nothing kept, no request


def test_the_ring_keeps_the_last_requests():
    for _ in range(trace.RING + 5):
        with trace.span("tick", root=True):
            pass
    recs = trace.records()
    assert len(recs) == trace.RING
    assert [r["request"] for r in recs] == list(range(recs[0]["request"],
                                                      recs[0]["request"] + trace.RING))
    assert trace.records(3) == recs[-3:] and trace.records(0) == []


def test_no_records_when_off_and_timed_spans_still_time():
    first = _last_id()
    was = trace.enabled(False)
    try:
        assert trace.enabled() is False
        with trace.span("req", root=True) as root:
            trace.count("n")
            with trace.span("plain") as plain:
                pass
            with trace.span("stage", timed=True) as stage:
                pass
    finally:
        trace.enabled(was)
    assert _since(first) == []
    assert root.id is None and root.request is None  # the root holds the stages' clock only
    assert not isinstance(plain, trace.Span)
    assert stage.ms == stage.host_ms >= 0 and stage.id is None


def test_renderer_frame_records(room, renderer):
    _, cam, poses = room
    first = _last_id()
    outs = []
    for E in poses:
        prev = renderer._cull_cache
        out = renderer.compute_full(cam, E)
        cache = renderer._cull_cache
        outs.append((out, cache, cache is not prev, renderer.last_timings))
    recs = _since(first)
    assert [r["name"] for r in recs] == ["frame"] * len(poses)
    assert [o[2] for o in outs] == [True, False, True, False]  # both paths of the cull cache
    for rec, (out, cache, recomputed, lt) in zip(recs, outs):
        root = rec["spans"][0]
        names = [sp["name"] for sp in _children(rec, root["id"])]
        assert names == FRAME_CHILDREN  # the first frame calibrates, in no span of its own
        proj = _named(rec, "frame.projection")
        assert [sp["name"] for sp in _children(rec, proj["id"])] == PROJECTION_CHILDREN
        c = rec["counters"]
        assert c["cull.recomputed"] == int(recomputed)
        assert c["cull.kept_points"] == cache["n_kept"]
        assert c["cull.overflowed"] == int(cache["overflowed"]) == 0
        assert c["copy_out.bytes"] == sum(a.nbytes for a in out.values())
        # last_timings are the record's stage spans, the same numbers
        assert (lt.projection_ms, lt.filter_ms, lt.unet_ms) == tuple(
            _named(rec, n)["host_ms"] for n in ("frame.projection", "frame.filter",
                                                "frame.unet"))
        assert lt.total_ms == lt.projection_ms + lt.filter_ms + lt.unet_ms
        kids = sum(sp["host_ms"] for sp in _children(rec, root["id"]))
        assert kids <= root["host_ms"]


def test_renderer_overflow_and_the_other_entries(room):
    scene, cam, poses = room
    tiny = Renderer(scene, RenderConfig(unet_features=FEAT, pyramid_levels=2),
                    init_unet_numpy(1, FEAT), cull_budget=64, device="cpu")
    first = _last_id()
    tiny.compute_rgbd(cam, poses[0])
    tiny.compute_filtered_rgbd(cam, poses[0])
    tiny.compute_full_tensors(cam, poses[0])
    recs = _since(first)
    assert len(recs) == 3
    shapes = [[sp["name"] for sp in _children(r, r["spans"][0]["id"])] for r in recs]
    assert shapes == [["frame.cull", "frame.projection", "frame.wait", "frame.copy_out"],
                      ["frame.cull", "frame.projection", "frame.filter", "frame.wait",
                       "frame.copy_out"],
                      ["frame.cull", "frame.projection", "frame.filter", "frame.unet",
                       "frame.wait"]]
    assert [r["counters"]["cull.recomputed"] for r in recs] == [1, 0, 0]
    assert all(r["counters"]["cull.overflowed"] == 1 for r in recs)
    assert recs[0]["counters"]["cull.kept_points"] == tiny._cull_cache["n_kept"] > 64
    assert recs[2]["counters"].get("copy_out.bytes") is None  # outputs stay on the device
    assert tiny.last_timings.unet_ms == _named(recs[2], "frame.unet")["host_ms"]


def test_renderer_with_the_record_off(room, renderer):
    _, cam, poses = room
    first = _last_id()
    want = renderer.compute_full(cam, poses[0])
    was = trace.enabled(False)
    try:
        got = renderer.compute_full(cam, poses[0])
    finally:
        trace.enabled(was)
    assert len(_since(first)) == 1
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    lt = renderer.last_timings
    assert lt.projection_ms > 0 and lt.filter_ms > 0 and lt.unet_ms > 0


def test_train_step_record():
    W, H = 32, 16
    scene = Scene.synthetic(4000, seed=1, extent=3.0)
    pts, cols, valid = scene.sorted_by_block().device_arrays(8)
    cam = Camera.from_params(20.0, 20.0, W / 2, H / 2, W, H)
    E = np.eye(4)
    E[2, 3] = 6.0
    M = torch.from_numpy(cam.cam_proj(E).astype(np.float32))[None]
    state = tt.create_train_state(init_unet_numpy(0, FEAT), features=FEAT, device="cpu")
    step = tt.make_train_step(width=W, height=H, levels=2)
    first = _last_id()
    for _ in range(2):
        state, met = step(state, torch.from_numpy(pts), torch.from_numpy(cols),
                          torch.from_numpy(valid), M, torch.full((1, H, W, 3), 0.5))
        float(met["loss"])
    recs = _since(first)
    assert [r["name"] for r in recs] == ["step", "step"]
    for rec in recs:
        root = rec["spans"][0]
        kids = _children(rec, root["id"])
        assert [sp["name"] for sp in kids] == STEP_CHILDREN
        render = _named(rec, "step.render")
        assert [sp["name"] for sp in _children(rec, render["id"])] == PROJECTION_CHILDREN
        assert sum(sp["host_ms"] for sp in kids) <= root["host_ms"]
        assert rec["counters"] == {}


def _annotations(path, names):
    events = json.loads(path.read_text())["traceEvents"]
    ann = [e for e in events if e.get("cat") == "user_annotation" and e["name"] in names]
    return sorted(ann, key=lambda e: (float(e["ts"]), -float(e["dur"])))  # outer first


def test_capture_holds_the_spans_as_annotations_with_their_ids(tmp_path):
    """Each span of the record is one annotation, in the order of the
    record's span ids, nested as the record's parent ids nest them."""
    first = _last_id()
    with trace.capture(str(tmp_path), device="cpu"):
        with trace.span("lone.stage"):
            for _ in range(2):
                with trace.span("req", root=True):
                    with trace.span("req.part"):
                        torch.ones(8).sum()
    recs = _since(first)
    spans = [sp for rec in recs for sp in rec["spans"]]
    assert [sp["id"] for sp in spans] == sorted(sp["id"] for sp in spans)
    ann = _annotations(tmp_path / "trace.json", ("lone.stage", "req", "req.part"))
    assert [e["name"] for e in ann] == ["lone.stage"] + [sp["name"] for sp in spans]
    by_id = dict(zip((sp["id"] for sp in spans), ann[1:]))
    end = lambda e: e["ts"] + e["dur"]
    for sp in spans:
        outer = ann[0] if sp["parent"] is None else by_id[sp["parent"]]
        e = by_id[sp["id"]]
        assert outer["ts"] <= e["ts"] and end(e) <= end(outer)
    assert end(by_id[spans[0]["id"]]) <= by_id[spans[2]["id"]]["ts"]  # one request, then the next


def test_capture_names_the_settle_of_the_previous_request(tmp_path, fake_card):
    """A root that closes reads the previous request's events under an
    annotation of its own, after its own (the card still runs the later
    request)."""
    first = _last_id()
    with trace.capture(str(tmp_path), device="cpu"):
        for _ in range(2):
            with trace.span("step", root=True, device="cuda"):
                with trace.span("step.render"):
                    pass
    assert len(_since(first)) == 2
    ann = _annotations(tmp_path / "trace.json", ("step", "step.render", "trace.settle"))
    assert [e["name"] for e in ann] == ["step", "step.render", "step", "step.render",
                                        "trace.settle"]
    second, settle = ann[2], ann[4]
    assert second["ts"] + second["dur"] <= settle["ts"]


def test_cli_timings_adds_the_frame_record(tmp_path, capsys):
    from rtnr_tpu_torch.data.ply import write_ply

    scene = Scene.synthetic_room(20_000, seed=2)
    cloud = tmp_path / "c.ply"
    write_ply(cloud, scene.points, scene.colors)
    calib = tmp_path / "calib.txt"
    Camera.from_params(30, 30, 16, 16, 32, 32, (0, 0, 0, 0, 0)).save_calibration(calib)
    traj = tmp_path / "traj.txt"
    traj.write_text("0.0 0 0 0 0 0 0 1\n1.0 0.1 0 0 0 0 0 1\n")
    files = [str(cloud), str(traj), str(calib), "-o", str(tmp_path / "o"), "--stage",
             "filtered"]
    assert cli_main(files, device="cpu") == 0
    plain = capsys.readouterr().out.splitlines()
    assert cli_main(files + ["--timings"], device="cpu") == 0
    timed = capsys.readouterr().out.splitlines()
    recs = trace.records(2)
    assert [line.split("  RENDER_TIME")[0] for line in plain[2:4]] == \
        [line.split("  RENDER_TIME")[0] for line in timed[2:4]]
    for line, rec in zip(timed[2:4], recs):
        assert line.endswith("  " + record_line(rec))
        assert "recomputed[" in line and "kept[" in line and "copy[" in line
        assert line.endswith(f"overflowed[{rec['counters']['cull.overflowed']}]")
    assert "cull[" not in plain[2] and "cull[" in timed[2]


class _FakeStream:
    device_index = 0


class _FakeEvent:
    """A CUDA event stand-in: each record is one tick of a clock."""

    made = 0
    tick = 0

    def __init__(self, enable_timing=False):
        type(self).made += 1
        self.t = None
        self.done = True

    def record(self, stream):
        type(self).tick += 1
        self.t = type(self).tick

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, other):
        return float(other.t - self.t)


@pytest.fixture
def fake_card(monkeypatch):
    """The record's CUDA path on the CPU: a stream and events that count."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(trace._S, "pool", {})
    _FakeEvent.made = _FakeEvent.tick = 0
    return _FakeEvent


def _frame_shape(stages):
    """The span tree of a frame, as ``Renderer`` opens it, with nothing inside."""
    with trace.span("frame", root=True, device="cuda"):
        with trace.span("frame.cull", fresh=True):
            pass
        for name in ("frame.projection", "frame.filter", "frame.unet"):
            with trace.span(name, timed=True) as sp:
                stages.append(sp)
                if name == "frame.projection":
                    with trace.span("projection.sort", fresh=True):
                        pass
        with trace.span("frame.wait"):
            stages[-1].wait()
        with trace.span("frame.copy_out"):
            pass


def test_device_times_share_one_event_between_back_to_back_spans(fake_card):
    first = _last_id()
    stages = []
    _frame_shape(stages)
    # the root's start, the two fresh spans' starts (the culling's, the sort's)
    # and one event at each of its 7 spans' ends and its own
    assert fake_card.tick == 11
    assert [sp.ms for sp in stages] == [3.0, 1.0, 1.0]  # end minus the previous end
    _frame_shape([])  # its wait reads the first frame's events: its last 3 reuse them
    assert fake_card.tick == 22 and fake_card.made == 11 + 8
    (a, b) = _since(first)
    for rec in (a, b):
        ms = {sp["name"]: sp["device_ms"] for sp in rec["spans"]}
        assert ms == {"frame": 10.0, "frame.cull": 1.0, "frame.projection": 3.0,
                      "projection.sort": 1.0, "frame.filter": 1.0, "frame.unet": 1.0,
                      "frame.wait": 1.0, "frame.copy_out": 1.0}


def test_pending_requests_wait_for_their_events(fake_card):
    first = _last_id()
    with trace.span("step", root=True, device="cuda"):
        with trace.span("step.render"):
            pass
    trace._S.pending[-1].marks[-1].done = False  # its last event not yet done on the card
    with trace.span("step", root=True, device="cuda"):
        pass
    assert len(trace._S.pending) == 2  # the first not settled, the second behind it
    with trace.span("frame", root=True):  # off the card: queued behind them
        pass
    assert len(trace._S.pending) == 3
    recs = _since(first)  # records() waits for them, in order
    assert [r["name"] for r in recs] == ["step", "step", "frame"] and not trace._S.pending
    assert [r["request"] for r in recs] == sorted(r["request"] for r in recs)
    assert recs[0]["spans"][1]["device_ms"] == 1.0


def test_with_the_record_off_a_frame_takes_the_stage_clock_only(fake_card):
    first = _last_id()
    was = trace.enabled(False)
    try:
        stages = []
        _frame_shape(stages)
    finally:
        trace.enabled(was)
    assert fake_card.tick == 4  # the projection's start and the three stage ends
    assert [sp.ms for sp in stages] == [1.0, 1.0, 1.0]
    assert _since(first) == []


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_record_on_the_card(cuda, room):
    """On the card every span of a frame and a step has a device time from
    its CUDA events; ``last_timings`` is the stage spans' device times; the
    parts lie inside their whole; the record off keeps nothing and times the
    stages."""
    scene, cam, poses = room
    feat = (16, 32)
    r = Renderer(scene, RenderConfig(unet_features=feat, pyramid_levels=2),
                 init_unet_numpy(1, feat), cull_budget="auto", device=cuda)
    first = _last_id()
    timings = []
    for E in poses:
        r.compute_full(cam, E)
        timings.append(r.last_timings)
    recs = _since(first)
    assert len(recs) == len(poses)
    for rec, lt in zip(recs, timings):
        assert all(sp["device_ms"] is not None and sp["device_ms"] >= 0 for sp in rec["spans"])
        dev = {sp["name"]: sp["device_ms"] for sp in rec["spans"]}
        assert (lt.projection_ms, lt.filter_ms, lt.unet_ms) == (
            dev["frame.projection"], dev["frame.filter"], dev["frame.unet"])
        assert dev["projection.sort"] <= dev["frame.projection"]
        root = rec["spans"][0]
        kids = sum(sp["device_ms"] for sp in _children(rec, root["id"]))
        assert kids <= root["device_ms"] * 1.001 + 1e-3
    was = trace.enabled(False)
    try:
        r.compute_full(cam, poses[0])
    finally:
        trace.enabled(was)
    assert len(_since(first)) == len(poses)
    assert r.last_timings.projection_ms > 0 and r.last_timings.unet_ms > 0

    W, H = 64, 48
    pts, cols, valid = Scene.synthetic(4000, seed=1, extent=3.0).sorted_by_block() \
        .device_arrays(8)
    cam2 = Camera.from_params(40.0, 40.0, W / 2, H / 2, W, H)
    E = np.eye(4)
    E[2, 3] = 6.0
    M = torch.from_numpy(cam2.cam_proj(E).astype(np.float32))[None].to(cuda)
    state = tt.create_train_state(init_unet_numpy(0, feat), features=feat, device=cuda)
    step = tt.make_train_step(width=W, height=H, levels=2)
    first = _last_id()
    feed = [torch.from_numpy(a).to(cuda) for a in (pts, cols, valid)]
    for _ in range(2):
        state, met = step(state, *feed, M, torch.full((1, H, W, 3), 0.5, device=cuda))
        float(met["loss"])
    recs = _since(first)
    assert [r_["name"] for r_ in recs] == ["step", "step"]
    for rec in recs:
        root = rec["spans"][0]
        kids = _children(rec, root["id"])
        assert [sp["name"] for sp in kids] == STEP_CHILDREN
        assert all(sp["device_ms"] is not None for sp in rec["spans"])
        assert sum(sp["device_ms"] for sp in kids) <= root["device_ms"] * 1.001 + 1e-3
