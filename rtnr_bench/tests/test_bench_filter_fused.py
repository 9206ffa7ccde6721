"""The ``filter.fused.serve`` and ``filter.fused.train`` readers on
synthetic frame and step records: the mean per window frame or step of the
``prefilter.fused`` counter, and nothing from a program whose frames or
steps never count it."""

from types import SimpleNamespace

import pytest

from rtnr_bench.tests import test_bench_record as rec
from rtnr_bench.tests.conftest import ROOT

record = rec.record


def test_filter_fused_serve_reads_the_window_frames_counter(record):
    frames = [rec.frame(i) for i in range(2 + 6 + 3)]
    record += frames
    run = rec.walk_run(frames[2:8])
    fused = rec.reader("filter.fused.serve")
    assert fused(run) is None  # no frame counted it: a program without the kernels
    for i, r in enumerate(frames):  # the warm-up and traced frames are not the window's
        r["counters"]["prefilter.fused"] = 1 if 2 <= i < 8 else 5
    assert fused(run) == pytest.approx(1.0)
    frames[4]["counters"]["prefilter.fused"] = 2  # a frame that also calibrated
    del frames[5]["counters"]["prefilter.fused"]  # a window frame that ran none
    assert fused(run) == pytest.approx((4 * 1 + 2) / 6)


def test_filter_fused_train_reads_the_window_steps_counter(record):
    steps = [rec.step(i) for i in range(3 + 5 + 2)]
    record += steps
    run = SimpleNamespace(steps=5, trace=True, root=ROOT,
                          traffic={"runner": "train", "trace_steps": 2})
    fused = rec.reader("filter.fused.train")
    assert fused(run) is None
    for i, r in enumerate(steps):  # the followed and the traced steps are not the window's
        r["counters"]["prefilter.fused"] = 1 if 3 <= i < 8 else 7
    assert fused(run) == pytest.approx(1.0)
    del steps[6]["counters"]["prefilter.fused"]
    assert fused(run) == pytest.approx(4 / 5)
