"""Mean over the window's frames of the ``frame.cull`` span (host clock,
ms): the culling test of the pose against the cached compaction and, on a
recompute, ``cull_points``, the kept-count sync and ``compact_points``."""

from rtnr_bench import spans


def read(run):
    return spans.mean_host_ms(spans.walk_frames(run), "frame.cull")
