"""Mean over the window's steps of the ``bn.fused`` counter: the BatchNorm
layers a step ran on the fused BatchNorm + ReLU kernels (``ops/bn_train.py``).
None where no step of the window counted it (a program without the kernels,
or a step off the card)."""

from rtnr_bench import spans


def read(run):
    steps = spans.train_steps(run)
    if not steps or not any("bn.fused" in r["counters"] for r in steps):
        return None
    return sum(r["counters"].get("bn.fused", 0) for r in steps) / len(steps)
