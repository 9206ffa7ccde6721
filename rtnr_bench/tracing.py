"""A traced window: device busy time, idle gaps and the top device operations.

The window is captured with the program's ``utils.trace.capture``
(``torch.profiler``, CPU and CUDA activity, exported as a Chrome trace)
around a span ``bench.window`` that the harness opens. From that one trace:

- device intervals: every kernel, memcpy and memset event; ``busy_s`` is
  the length of their union inside the window span, ``window_s`` the
  span's length;
- idle gaps: the stretches of the window that no device interval covers,
  each named by the most specific host event (CPU op, CUDA runtime call or
  annotation) that contains its midpoint, summed by name;
- device operations: the device events' time summed by name.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

WINDOW_SPAN = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def summarize(events: List[Dict]) -> Dict:
    """Chrome-trace events (times in us) -> {busy_s, window_s, device_ops,
    idle_gaps}; None values where the trace holds no window span."""
    spans = [e for e in events if e.get("name") == WINDOW_SPAN and e.get("ph") == "X"]
    if not spans:
        return {"busy_s": None, "window_s": None, "device_ops": [], "idle_gaps": []}
    w0 = min(float(e["ts"]) for e in spans)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    dev, ops = [], defaultdict(float)
    host = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                dev.append((a, b))
                ops[e["name"]] += (b - a) * 1e-6
        elif cat in HOST_CATS and e.get("name") != WINDOW_SPAN:
            host.append((a, b, e["name"]))
    busy = merge(dev)
    gaps, cur = [], w0
    for a, b in busy:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if w1 > cur:
        gaps.append((cur, w1))
    # each gap takes the name of the shortest host event holding its midpoint:
    # paint the sorted midpoints longest event first, shorter ones over them
    mids = np.array([(a + b) / 2 for a, b in gaps])
    order = np.argsort(mids)
    sorted_mids = mids[order]
    label = np.full(len(gaps), -1)
    host.sort(key=lambda t: t[0] - t[1])
    for i, (ha, hb, _) in enumerate(host):
        lo = np.searchsorted(sorted_mids, ha, side="left")
        hi = np.searchsorted(sorted_mids, hb, side="right")
        label[order[lo:hi]] = i
    by_name = defaultdict(float)
    for (a, b), i in zip(gaps, label):
        by_name[host[i][2] if i >= 0 else "(no host event)"] += (b - a) * 1e-6
    top = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:10]
    return {"busy_s": sum(b - a for a, b in busy) * 1e-6, "window_s": (w1 - w0) * 1e-6,
            "device_ops": top(ops), "idle_gaps": top(by_name)}


def traced(fn, device: str) -> Dict:
    """Run ``fn`` under the profiler inside the window span; the summary of
    its trace. The trace file lives in a temporary directory that is
    removed afterwards."""
    import torch

    from rtnr_tpu_torch.utils.trace import capture

    with tempfile.TemporaryDirectory(prefix="rtnr_bench_trace_") as d:
        with capture(d, device=device):
            with torch.profiler.record_function(WINDOW_SPAN):
                fn()
                if device == "cuda":
                    torch.cuda.synchronize()
        with open(os.path.join(d, "trace.json")) as f:
            events = json.load(f).get("traceEvents", [])
    return summarize(events)
