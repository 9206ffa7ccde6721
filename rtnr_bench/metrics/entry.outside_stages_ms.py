"""Mean over the window's frames of the frame's latency less its three
stage spans (``Renderer.last_timings``): culling, the pose upload, the
wait for the last span and the copy of the outputs to host numpy (ms)."""


def read(run):
    if not run.frames:
        return None
    out = [f["latency_ms"] - f["projection_ms"] - f["filter_ms"] - f["unet_ms"]
           for f in run.frames]
    return sum(out) / len(out)
