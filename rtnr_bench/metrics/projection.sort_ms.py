"""Mean over the window's frames of the ``projection.sort`` span (CUDA
events on the render stream, ms): the one ``torch.sort`` of the projection's
key stream."""

from rtnr_bench import spans


def read(run):
    return spans.mean_device_ms(spans.walk_frames(run), "projection.sort")
