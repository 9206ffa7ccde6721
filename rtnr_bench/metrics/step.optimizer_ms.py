"""Mean over the window's steps of the ``step.optimizer`` span (CUDA events on
the training stream, ms): the gradient sum, ``global_norm`` and Adam."""

from rtnr_bench import spans


def read(run):
    return spans.mean_device_ms(spans.train_steps(run), "step.optimizer")
