"""The ``step.bn_fused`` reader on synthetic step records: the mean per
window step of the ``bn.fused`` counter, and nothing from a program whose
steps never count it."""

from types import SimpleNamespace

import pytest

from rtnr_bench.tests import test_bench_record as rec
from rtnr_bench.tests.conftest import ROOT

record = rec.record


def test_step_bn_fused_reads_the_window_steps_counter(record):
    steps = [rec.step(i) for i in range(3 + 5 + 2)]
    record += steps
    run = SimpleNamespace(steps=5, trace=True, root=ROOT,
                          traffic={"runner": "train", "trace_steps": 2})
    bn_fused = rec.reader("step.bn_fused")
    assert bn_fused(run) is None  # no step counted it: a program without the kernels
    for i, r in enumerate(steps):  # the followed and the traced steps are not the window's
        r["counters"]["bn.fused"] = 18 if 3 <= i < 8 else 99
    steps[5]["counters"]["bn.fused"] = 9
    assert bn_fused(run) == pytest.approx((4 * 18 + 9) / 5)
    del steps[6]["counters"]["bn.fused"]  # a window step that ran none
    assert bn_fused(run) == pytest.approx((3 * 18 + 9) / 5)
