"""Seconds from the process's start to the first timed frame or step:
imports, the scene and weights, the program's set-up, the kernel builds
on a checkout's first run, and the warm-up (host clock)."""


def read(run):
    return run.setup_s
