"""Mean ``frame.cull`` span (host clock, ms) over the window's frames that
recomputed the culled compaction (counter ``cull.recomputed`` 1): what a
recompute costs."""

from rtnr_bench import spans


def read(run):
    frames = spans.walk_frames(run)
    if frames is None:
        return None
    return spans.mean_host_ms([r for r in frames if r["counters"].get("cull.recomputed")],
                              "frame.cull")
