"""Profiling / tracing (counterpart of the JAX package's ``utils/trace.py``).

The reference's observability is hand-inserted chrono prints
(project_cloud.cu:490) plus ``-lineinfo`` for nsight (SURVEY.md section 5).
The port's equivalents on ``torch.profiler``:

- ``annotate(name)``: a ``record_function`` span -- stages show up named in
  the profiler's trace.
- ``capture(dir)``: a ``torch.profiler`` trace (CPU and CUDA activity) of
  the enclosed block, exported as a Chrome trace (``trace.json``) into
  ``dir``; it needs a card unless ``device="cpu"``.
- ``StageTimer``: wall timers that synchronise the card at the end of a
  stage, emitting the same four-stage line the reference prints, plus
  derived throughput counters (frames/s, points/s, pixels/s).
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, Iterator

import torch


def annotate(name: str):
    """Named trace span: ``with annotate('raster'): ...``"""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def capture(trace_dir: str, device: str = "cuda") -> Iterator[None]:
    """Capture a profiler trace of the enclosed block into
    ``trace_dir/trace.json`` (CPU and, on the card, CUDA activity)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("capture(device='cuda') needs a CUDA device; pass device='cpu'")
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    elif device != "cpu":
        raise ValueError(f"capture: device {device!r} is neither 'cuda' nor 'cpu'")
    Path(trace_dir).mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(str(Path(trace_dir) / "trace.json"))


def _sync(tree) -> None:
    """Wait for the card where ``tree`` (a tensor, or lists, tuples and
    dicts of them) holds CUDA tensors."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            torch.cuda.synchronize(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _sync(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _sync(v)


class StageTimer:
    """Wall-clock per-stage timing with throughput counters."""

    def __init__(self) -> None:
        self.stages: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync=None) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        if sync is not None:
            _sync(sync)
        self.stages[name] = self.stages.get(name, 0.0) + (time.perf_counter() - t0) * 1e3

    def line(self) -> str:
        total = sum(self.stages.values())
        parts = ", ".join(f"{k}[{v:.2f}]" for k, v in self.stages.items())
        return f"RENDER_TIME: {parts}, Total[{total:.2f}]"

    def throughput(self, n_points: int, n_pixels: int, n_frames: int = 1) -> Dict[str, float]:
        total_s = sum(self.stages.values()) / 1e3
        if total_s <= 0:
            return {}
        return {
            "fps": n_frames / total_s,
            "points_per_s": n_points * n_frames / total_s,
            "pixels_per_s": n_pixels * n_frames / total_s,
        }
