"""Mean over the window's frames of ``Renderer.last_timings.projection_ms``
(CUDA events on the render stream, ms)."""


def read(run):
    if not run.frames:
        return None
    return sum(f["projection_ms"] for f in run.frames) / len(run.frames)
