"""Mean over the window's frames of the ``frame.copy_out`` span (host
clock, ms): the copy of the frame's outputs to host numpy."""

from rtnr_bench import spans


def read(run):
    return spans.mean_host_ms(spans.walk_frames(run), "frame.copy_out")
