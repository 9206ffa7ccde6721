"""Mean over the window's steps of the ``step.backward`` span (CUDA events on
the training stream, ms): the backward pass."""

from rtnr_bench import spans


def read(run):
    return spans.mean_device_ms(spans.train_steps(run), "step.backward")
