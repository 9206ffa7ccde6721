"""The port's tracing module (``rtnr_tpu_torch.utils.trace``) against the JAX
package's ``rtnr_tpu.utils.trace``: ``StageTimer.line()`` gives the same
text for the same stages, spans nest, ``capture(device="cpu")`` writes a
Chrome trace that holds the spans, and ``capture()`` without a card raises.
The record itself: ``tests/test_torch_record.py``."""

import json

import numpy as np
import pytest
import torch

from rtnr_tpu.utils import trace as jtrace
from rtnr_tpu_torch.utils import trace


def test_stage_timer_line_equals_jax():
    stages = {"Projection": 1.23456, "Filter": 0.5, "UNet": 12.0049, "Total I/O": 0.0}
    port, jax_t = trace.StageTimer(), jtrace.StageTimer()
    port.stages, jax_t.stages = dict(stages), dict(stages)
    assert port.line() == jax_t.line()
    assert port.line().startswith("RENDER_TIME: Projection[1.23], ")
    empty = trace.StageTimer()
    assert empty.line() == jtrace.StageTimer().line() == "RENDER_TIME: , Total[0.00]"


def test_stage_accumulates_and_syncs_cpu_tensors():
    t = trace.StageTimer()
    for _ in range(2):
        with t.stage("a", sync=torch.ones(3)):
            pass
        with t.stage("b", sync={"x": [torch.zeros(1)], "y": (np.zeros(1),)}):
            pass
    assert list(t.stages) == ["a", "b"] and all(v >= 0 for v in t.stages.values())


def _events(path):
    return json.loads(path.read_text())["traceEvents"]


def test_capture_cpu_holds_the_nested_spans(tmp_path):
    x = torch.arange(64, dtype=torch.float32)
    with trace.capture(str(tmp_path / "tr"), device="cpu"):
        with trace.span("outer.stage"):
            with trace.span("inner.stage"):
                y = (x * 2).sum()
    assert float(y) == 4032.0
    ev = {e["name"]: e for e in _events(tmp_path / "tr" / "trace.json")
          if e.get("ph") == "X"}
    outer, inner = ev["outer.stage"], ev["inner.stage"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_capture_writes_the_trace_when_the_block_raises(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with trace.capture(str(tmp_path), device="cpu"):
            with trace.span("failing.stage"):
                1 / 0
    assert any(e["name"] == "failing.stage" for e in _events(tmp_path / "trace.json"))


def test_capture_needs_a_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        with trace.capture(str(tmp_path)):
            pass
    with pytest.raises(ValueError, match="neither"):
        with trace.capture(str(tmp_path), device="tpu"):
            pass
