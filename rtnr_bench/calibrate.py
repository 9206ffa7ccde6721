"""Read the numbers that decide ``correct`` over many seeds, for setting
their limits: the program's readings, and those of what stands in its
place.

    python3 rtnr_bench/calibrate.py --workload <cell> --seconds 3 \
        --seeds 11 12 13 --stand-in control 11 12 13 --stand-in frozen 11

Each seed runs the cell's set-up and a short window as a benchmark run
does, then the reference. For a seed named after ``--stand-in NAME`` the
runner's stand-in ``NAME`` (its ``STAND_INS``) also runs in the program's
place on the same inputs and is compared as the program is: ``control``,
the reference computed in the precision below the configuration's (the
walk: static int4 scales and codes; training: float8 e4m3 convs);
``frozen`` (training), the reference with a learning rate of 0, a state
left unchanged. One JSON line per seed on standard output. Not part of a
benchmark run.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from rtnr_bench import harness  # noqa: E402


def readings(workload: str, seeds, stand_ins: Dict[str, List[int]], seconds: float,
             device: str = "cuda", root: Path = harness.ROOT):
    """Yields {seed, program?, <stand-in>?...} per seed."""
    import torch

    every = list(seeds) + [s for v in stand_ins.values() for s in v]
    for seed in dict.fromkeys(every):
        args = harness.parse(["--workload", workload, "--seed", str(seed),
                              "--seconds", str(seconds)])
        rec = harness.prepare(args, Path(root), device, time.time())
        runner = harness.load_module(harness.find(Path(root), "runners", rec.traffic["runner"],
                                                  ".py"))
        unknown = set(stand_ins) - set(runner.STAND_INS)
        if unknown:
            raise SystemExit(f"{workload} has no stand-in {sorted(unknown)}; "
                             f"it has {list(runner.STAND_INS)}")
        ctx = runner.measure(rec)
        out = {"seed": seed, "frames_or_steps": rec.extra.get("attempted")}
        if seed in seeds:
            out["program"] = runner.checks(rec, ctx)
        for name, chosen in stand_ins.items():
            if seed in chosen:
                out[name] = runner.checks(rec, ctx, stand_in=name)
        del ctx, rec
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        yield out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--stand-in", nargs="+", action="append", default=[],
                   metavar=("NAME", "SEED"))
    a = p.parse_args(argv)
    stand_ins = {s[0]: [int(x) for x in s[1:]] for s in a.stand_in}
    for out in readings(a.workload, a.seeds, stand_ins, a.seconds):
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
