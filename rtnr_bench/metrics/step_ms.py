"""The window's milliseconds over the training steps completed in it;
every step ends in a read of its loss (host clock)."""


def read(run):
    if not run.steps or not run.window_s:
        return None
    return run.window_s * 1e3 / run.steps
