"""Mean over the window's steps of the ``prefilter.fused`` counter: the
prefilter calls a training step ran on the prefilter kernels
(``ops/prefilter.filter_frame``). None where no step of the window counted
it (a program without the kernels, or a step off the card)."""

from rtnr_bench import spans


def read(run):
    steps = spans.train_steps(run)
    if not steps or not any("prefilter.fused" in r["counters"] for r in steps):
        return None
    return sum(r["counters"].get("prefilter.fused", 0) for r in steps) / len(steps)
