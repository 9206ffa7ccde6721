"""Share of the window's frames that recomputed the culled compaction
(``Renderer._cull_cache`` replaced by the frame), in %."""


def read(run):
    if not run.frames:
        return None
    return 100.0 * sum(f["recomputed"] for f in run.frames) / len(run.frames)
