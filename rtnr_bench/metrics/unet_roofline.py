"""The U-Net's least time at the published peaks over the mean
``stage.unet_ms``, in %: per conv call the larger of its operations over
its precision's peak and its bytes over the memory bandwidth, counted from
the shapes (``rtnr_bench/flops.py``), whatever kernel runs it."""

from rtnr_bench import flops
from rtnr_bench.record import serve_calls


def read(run):
    if not run.frames or run.device != "cuda":
        return None
    unet_ms = sum(f["unet_ms"] for f in run.frames) / len(run.frames)
    return 100.0 * sum(flops.least_s(c) for c in serve_calls(run)) * 1e3 / unet_ms
