"""The U-Net's operations at their precisions' published peaks over the
mean frame latency, in % (the whole frame's share of the chip's peak)."""

from rtnr_bench import flops
from rtnr_bench.record import serve_calls


def read(run):
    if not run.frames or run.device != "cuda":
        return None
    mean_s = sum(f["latency_ms"] for f in run.frames) / len(run.frames) * 1e-3
    return 100.0 * flops.math_s(serve_calls(run)) / mean_s
