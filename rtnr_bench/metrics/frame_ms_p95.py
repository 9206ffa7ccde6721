"""The 95th percentile of the latency of every frame of the window: from
the call of ``compute_full`` to its return with the outputs in host
memory (host clock, ms)."""

import numpy as np


def read(run):
    if not run.frames:
        return None
    return float(np.percentile([f["latency_ms"] for f in run.frames], 95))
