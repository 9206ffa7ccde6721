"""Run a function on N ranks, each a fresh Python process, and collect what
each returns.

    results = run_ranks("pkg.module:function", 4, {"arg": value}, device="cpu")

The ranks join one process group through the environment that ``torchrun``
sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR`` = 127.0.0.1, a free ``MASTER_PORT``) and ``mesh.
init_distributed(device)``; each calls ``function(**kwargs)`` and returns a
picklable value (tensors as numpy arrays). The processes are fresh
interpreters, not forks, so no thread or CUDA state of the caller crosses
into them, and each sets ``torch.set_num_threads(threads)``. Several ranks
on one card get gloo by the backend rule; one process a card gets NCCL.

Used by the port's CPU tests (gloo ranks), and by its card tests and
``chip_smoke.py`` (ranks sharing one card). A rank that fails, or a run past
``timeout`` seconds, stops every rank and raises with the failing rank's
error output.
"""

from __future__ import annotations

import importlib
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankProcesses:
    """The running ranks of ``start_ranks``; ``wait()`` returns their
    results in rank order."""

    def __init__(self, procs, workdir: Path, timeout: float, tmp):
        self.procs, self.workdir, self.timeout, self._tmp = procs, workdir, timeout, tmp
        self.t0 = time.perf_counter()

    def _stop(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def wait(self) -> List[Any]:
        try:
            while True:
                rcs = [p.poll() for p in self.procs]
                bad = [r for r, rc in enumerate(rcs) if rc not in (None, 0)]
                if bad:
                    time.sleep(1.0)  # let the other ranks' errors reach their logs
                    self._stop()
                    rcs = [p.returncode for p in self.procs]
                    raise RuntimeError("\n".join(
                        f"rank {r} exited with {rc}:\n"
                        + (self.workdir / f"rank{r}.err").read_text()[-4000:]
                        for r, rc in enumerate(rcs) if rc != 0))
                if all(rc == 0 for rc in rcs):
                    break
                if time.perf_counter() - self.t0 > self.timeout:
                    self._stop()
                    raise TimeoutError(f"ranks still running after {self.timeout} s")
                time.sleep(0.05)
            out = []
            for r in range(len(self.procs)):
                with open(self.workdir / f"rank{r}.pkl", "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            self._stop()
            self._tmp.cleanup()


def start_ranks(target: str, world_size: int, kwargs: Optional[Dict[str, Any]] = None, *,
                device: str = "cpu", threads: int = 1, timeout: float = 600.0,
                extra_path: Sequence[str] = ()) -> RankProcesses:
    """Start ``world_size`` ranks of ``target`` ("module:function") with
    ``kwargs``; returns at once. ``extra_path``: directories put before
    the package on the ranks' ``PYTHONPATH`` (where ``target``'s module
    lies); the package's own parent is always on it."""
    tmp = tempfile.TemporaryDirectory(prefix="rtnr_ranks_")
    wd = Path(tmp.name)
    with open(wd / "args.pkl", "wb") as f:
        pickle.dump(kwargs or {}, f)
    root = str(Path(__file__).resolve().parents[2])
    base = dict(os.environ)
    path = [*extra_path, root] + ([base["PYTHONPATH"]] if base.get("PYTHONPATH") else [])
    port = str(free_port())
    procs = []
    for r in range(world_size):
        e = dict(base, RANK=str(r), WORLD_SIZE=str(world_size), LOCAL_RANK=str(r),
                 LOCAL_WORLD_SIZE=str(world_size), MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                 PYTHONPATH=os.pathsep.join(path), OMP_NUM_THREADS=str(threads))
        cmd = [sys.executable, "-m", "rtnr_tpu_torch.parallel.launch", target, str(wd),
               device, str(threads)]
        with open(wd / f"rank{r}.err", "w") as err:
            procs.append(subprocess.Popen(cmd, env=e, stdout=err, stderr=subprocess.STDOUT,
                                          cwd=root))
    return RankProcesses(procs, wd, timeout, tmp)


def run_ranks(target: str, world_size: int, kwargs: Optional[Dict[str, Any]] = None,
              **kw) -> List[Any]:
    """``start_ranks(...).wait()``: each rank's return value, in rank order."""
    return start_ranks(target, world_size, kwargs, **kw).wait()


def _rank_main(target: str, workdir: str, device: str, threads: int) -> None:
    import torch
    import torch.distributed as dist

    from rtnr_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(threads)
    init_distributed(device)
    module, fn = target.split(":")
    with open(Path(workdir) / "args.pkl", "rb") as f:
        kwargs = pickle.load(f)
    out = getattr(importlib.import_module(module), fn)(**kwargs)
    rank = dist.get_rank()
    tmp = Path(workdir) / f"rank{rank}.pkl.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(out, f)
    os.replace(tmp, Path(workdir) / f"rank{rank}.pkl")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4]))
