"""Mean over the window's steps of the ``step.forward`` span (CUDA events on
the training stream, ms): ``zero_grad``, the BatchNorm sync, the U-Net
forward and the loss."""

from rtnr_bench import spans


def read(run):
    return spans.mean_device_ms(spans.train_steps(run), "step.forward")
