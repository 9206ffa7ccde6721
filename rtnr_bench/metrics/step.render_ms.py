"""Mean over the window's steps of the ``step.render`` span (CUDA events on
the training stream, ms): the no-grad raster and prefilter of the step's
frames."""

from rtnr_bench import spans


def read(run):
    return spans.mean_device_ms(spans.train_steps(run), "step.render")
