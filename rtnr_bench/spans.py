"""What the readers of the program's frame and step record share: the
window's roots, checked against the run, and span times by name.

The record is ``rtnr_tpu_torch.utils.trace.records()``: one dict per
``Renderer`` frame (root span ``frame``) or training step (root ``step``),
its spans with their host and device ms and its counters. A run's own roots
are the last of their name: a walk's ``warmup_frames``, its window's frames
and, with ``--trace 1``, its ``trace_frames``; a training run's followed
steps (its runner's ``FOLLOWED``), the window's steps and its
``trace_steps``. The window's
roots are picked by order between them, so every reading is of the
unprofiled window. Where the record does not line up with the run (a
program without the record, a ring too short, a walk frame whose three
stage times are not the run's ``last_timings``), the readers read nothing.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from rtnr_bench.harness import find, load_module

STAGES = (("frame.projection", "projection_ms"), ("frame.filter", "filter_ms"),
          ("frame.unet", "unet_ms"))


def _roots(name: str) -> Optional[List[Dict]]:
    try:
        from rtnr_tpu_torch.utils import trace
    except ImportError:
        return None
    records = getattr(trace, "records", None)
    if records is None:  # a program without the record
        return None
    return [r for r in records() if r["name"] == name]


def _window(roots: Optional[List[Dict]], before: int, n: int, after: int):
    if roots is None or n <= 0 or len(roots) < before + n + after:
        return None
    mine = roots[len(roots) - (before + n + after):]
    return mine[before:before + n]


def stage_ms(sp: Dict) -> float:
    """A span's time as ``last_timings`` takes it: device ms, else host ms."""
    return sp["host_ms"] if sp["device_ms"] is None else sp["device_ms"]


def spans(rec: Dict, name: str) -> List[Dict]:
    return [sp for sp in rec["spans"] if sp["name"] == name]


def children(rec: Dict) -> List[Dict]:
    """The root's own spans."""
    root = rec["spans"][0]["id"]
    return [sp for sp in rec["spans"] if sp["parent"] == root]


def walk_frames(run) -> Optional[List[Dict]]:
    """The walk window's frame records, one for each of ``run.frames``, or
    None where they do not line up."""
    tr = run.traffic
    window = _window(_roots("frame"), tr["warmup_frames"], len(run.frames),
                     tr["trace_frames"] if run.trace else 0)
    if window is None:
        return None
    for rec, f in zip(window, run.frames):
        for name, key in STAGES:
            got = [stage_ms(sp) for sp in children(rec) if sp["name"] == name]
            if got != [f[key]]:
                return None
    return window


def train_steps(run) -> Optional[List[Dict]]:
    """The training window's step records, or None where the record holds
    fewer than the run's followed, window and traced steps."""
    runner = load_module(find(run.root, "runners", run.traffic["runner"], ".py"))
    return _window(_roots("step"), runner.FOLLOWED, run.steps,
                   run.traffic["trace_steps"] if run.trace else 0)


def mean_host_ms(recs: Optional[List[Dict]], name: str) -> Optional[float]:
    """Mean over the records of their ``name`` spans' host ms."""
    if not recs:
        return None
    return sum(sum(sp["host_ms"] for sp in spans(r, name)) for r in recs) / len(recs)


def mean_device_ms(recs: Optional[List[Dict]], name: str) -> Optional[float]:
    """Mean over the records of their ``name`` spans' device ms (None off
    the card)."""
    if not recs:
        return None
    per = [[sp["device_ms"] for sp in spans(r, name)] for r in recs]
    if any(not ms or None in ms for ms in per):
        return None
    return sum(sum(ms) for ms in per) / len(per)
