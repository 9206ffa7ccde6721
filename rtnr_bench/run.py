"""Run one benchmark cell once and print its result line.

    python3 rtnr_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python -m rtnr_bench.run ...``) from the root of a checkout. The last
line of standard output is the result's JSON object; the numbers compared
to decide ``correct`` close standard error, each beside its limit. Exits 2
without the CUDA devices the cell needs or without the program under test,
and 3 if the run loaded JAX or the JAX package.
"""

import time

T_START = time.time()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from rtnr_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
