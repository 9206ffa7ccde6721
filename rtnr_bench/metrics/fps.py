"""Frames returned by ``Renderer.compute_full`` in the window over the
window's seconds (host clock)."""


def read(run):
    if not run.frames or not run.window_s:
        return None
    return len(run.frames) / run.window_s
