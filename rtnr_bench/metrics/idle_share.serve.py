"""1 - busy / window of the traced window, in %: busy is the union of the
device's kernel, memcpy and memset intervals in the profiler's trace."""

from rtnr_bench.record import idle_share


def read(run):
    return idle_share(run)
