"""Mean over the window's frames of the ``prefilter.fused`` counter: the
prefilter calls a walk frame ran on the prefilter kernels
(``ops/prefilter.filter_frame``). None where no frame of the window counted
it (a program without the kernels, or a frame off the card)."""

from rtnr_bench import spans


def read(run):
    frames = spans.walk_frames(run)
    if not frames or not any("prefilter.fused" in r["counters"] for r in frames):
        return None
    return sum(r["counters"].get("prefilter.fused", 0) for r in frames) / len(frames)
