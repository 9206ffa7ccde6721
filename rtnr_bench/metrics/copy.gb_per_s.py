"""The window's bytes copied to the host (counter ``copy_out.bytes``) over
the time of its ``frame.copy_out`` spans (host clock), in GB/s."""

from rtnr_bench import spans


def read(run):
    frames = spans.walk_frames(run)
    if not frames:
        return None
    n = sum(r["counters"].get("copy_out.bytes", 0) for r in frames)
    ms = sum(sp["host_ms"] for r in frames for sp in spans.spans(r, "frame.copy_out"))
    return n / (ms * 1e-3) / 1e9 if n and ms > 0 else None
