"""Three times the U-Net forward's operations (forward and backward) at
the bf16 peak over the mean step time, in %."""

from rtnr_bench import flops
from rtnr_bench.record import train_calls


def read(run):
    if not run.steps or run.device != "cuda":
        return None
    step_s = run.window_s / run.steps
    return 100.0 * 3 * flops.total_ops(train_calls(run)) / flops.PEAKS["bf16"] / step_s
