"""Profiling / tracing (counterpart of the JAX package's ``utils/trace.py``).

The reference's observability is hand-inserted chrono prints
(project_cloud.cu:490) plus ``-lineinfo`` for nsight (SURVEY.md section 5).
The port keeps one record of its frames and training steps, beside
``torch.profiler``:

- ``span(name)``: a nested span. A span opened with ``root=True`` (a
  ``Renderer`` frame, a training step) opens a request; every span opened
  inside it is recorded with its name, its own id, its parent's id, the
  request's id, its start and end on the host's monotonic clock
  (``time.perf_counter``) and, on a CUDA device, the time between two CUDA
  events on the request's stream (taken from a pool; a span starts at the
  request's last event, so back-to-back spans share one, unless it opens
  with ``fresh=True`` after work that no span holds). The events are read
  without a synchronise of their own, once a request's last event is done:
  when a later request waits for its own events (``Span.wait()``, before
  it synchronises) or closes, both while the card still runs the later
  one, or in ``records()``.
- ``count(name, n)``: a counter added to the open request's record.
- ``records()``: the closed requests, oldest first, as dicts (a ring of the
  last ``RING``; ``records(n)``: the last n): ``{"name", "request",
  "host_ms", "device_ms", "counters", "spans"}``, where ``spans`` lists
  every span of the request in the order they opened, the root first,
  each ``{"name", "id", "parent", "request", "start", "end", "host_ms",
  "device_ms"}`` (``device_ms`` None off the card).
- ``enabled(on)``: the record's one switch, on by default. Off, nothing is
  kept; only spans opened with ``timed=True`` inside a root (the three
  stage spans behind ``Renderer.last_timings``) take their events.
- ``capture(dir)``: a ``torch.profiler`` trace (CPU and CUDA activity) of
  the enclosed block, exported as a Chrome trace (``trace.json``) into
  ``dir``; it needs a card unless ``device="cpu"``. Inside it every span also
  enters ``record_function(name)``, so the spans sit in the trace on the
  profiler's clock beside the kernels they launched; the record's own
  reading of the earlier requests' events is the annotation
  ``trace.settle``.
- ``StageTimer``: wall timers that synchronise the card at the end of a
  stage, emitting the same four-stage line the reference prints.

The record belongs to one thread: spans nest on one stack.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import torch

RING = 8192  # closed requests the record keeps


class _State:
    def __init__(self) -> None:
        self.on = True
        self.profiling = False  # inside capture(): spans are annotations
        self.request: Optional[_Request] = None  # the open request
        self.stack: List[Span] = []  # its open spans
        self.pending: collections.deque = collections.deque()  # closed, events not yet read
        self.ring: collections.deque = collections.deque(maxlen=RING)
        self.pool: Dict[int, List[torch.cuda.Event]] = {}  # free events by device index
        self.span_ids = itertools.count(1)
        self.request_ids = itertools.count(1)


_S = _State()
_FIELDS = ("name", "id", "parent", "request", "start", "end", "host_ms", "device_ms")


class _Request:
    """The spans of one root (a frame, a step), kept when the record is on;
    with the record off, only its ``timed`` spans' clock. Its marks are the
    CUDA events recorded on its stream, in order; once settled, its spans
    are kept as rows of plain values (which the garbage collector leaves
    alone)."""

    __slots__ = ("id", "name", "keep", "device", "stream", "marks", "spans", "counters", "rows")

    def __init__(self, name: str, keep: bool, device: Optional[torch.device]) -> None:
        self.id = next(_S.request_ids) if keep else None
        self.name, self.keep = name, keep
        self.device = device if device is not None and device.type == "cuda" else None
        self.stream = None  # the device's current stream, from when the root opens
        self.marks: List[torch.cuda.Event] = []
        self.spans: List[Span] = []
        self.counters: Dict[str, float] = {}
        self.rows = None

    def mark(self) -> torch.cuda.Event:
        """A new event recorded on the request's stream."""
        free = _S.pool.get(self.stream.device_index)
        ev = free.pop() if free else torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        self.marks.append(ev)
        return ev

    def done(self) -> bool:
        return not self.marks or self.marks[-1].query()

    def settle(self) -> None:
        """Read the spans' device times (every mark done), free the marks
        and keep the rows."""
        for sp in self.spans:
            sp._settle()
        if self.marks:
            _S.pool.setdefault(self.stream.device_index, []).extend(self.marks)
        if self.keep:
            self.rows = tuple(sp.row() for sp in self.spans)
            _S.ring.append(self)
        self.spans = self.marks = self.stream = None

    def as_dict(self) -> Dict:
        spans = [dict(zip(_FIELDS, row)) for row in self.rows]
        return {"name": self.name, "request": self.id, "host_ms": spans[0]["host_ms"],
                "device_ms": spans[0]["device_ms"], "counters": dict(self.counters),
                "spans": spans}


class Span:
    """A span of the record (``span()``); after it closes, ``host_ms`` and,
    on the card once its end event is done, ``device_ms`` (``ms``)."""

    __slots__ = ("name", "id", "parent", "request", "start", "end", "host_ms", "device_ms",
                 "_req", "_root", "_timed", "_fresh", "_ev", "_rf")

    def __init__(self, name: str, req: Optional[_Request], root: bool, timed: bool,
                 fresh: bool = False) -> None:
        self.name, self._req, self._root, self._fresh = name, req, root, fresh
        self._timed = timed and req is not None and req.device is not None
        self.id = self.parent = self.request = None
        self.start = self.end = self.host_ms = self.device_ms = None
        self._ev = self._rf = None

    def __enter__(self) -> "Span":
        s = _S
        req = self._req
        if self._root:
            s.request = req
            if req.device is not None:
                req.stream = torch.cuda.current_stream(req.device)
        if req is not None:
            req.spans.append(self)
            if req.keep:
                self.id, self.request = next(s.span_ids), req.id
                self.parent = s.stack[-1].id if s.stack else None
                s.stack.append(self)
        if s.profiling:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.start = time.perf_counter()
        if self._timed:  # from the request's last mark (a parent's start, a sibling's end)
            self._ev = [req.marks[-1] if req.marks and not self._fresh else req.mark(), None]
        return self

    def __exit__(self, *exc) -> bool:
        req = self._req
        if self._timed:
            self._ev[1] = req.mark()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self.end = time.perf_counter()
        self.host_ms = (self.end - self.start) * 1e3
        if req is not None:
            s = _S
            if req.keep:
                s.stack.pop()
            if self._root:
                s.request = None
                _settle_done()  # the earlier requests, while the card runs this one
                if req.stream is None and not s.pending:
                    req.settle()
                else:  # kept in order, after the earlier ones
                    s.pending.append(req)
        return False

    def wait(self) -> None:
        """Wait for the span's end event (on the card; nothing off it),
        reading the earlier requests' events first, while the card works."""
        if self._ev is not None:
            _settle_done()
            self._ev[1].synchronize()

    @property
    def ms(self) -> float:
        """The device time on the card, else the host time. On the card only
        once the end event is done (after ``wait()`` on it or on a later
        span of the same stream)."""
        self._settle()
        return self.host_ms if self.device_ms is None else self.device_ms

    def _settle(self) -> None:
        if self._ev is not None:
            a, b = self._ev
            self.device_ms = a.elapsed_time(b)
            self._ev = None

    def row(self) -> tuple:
        """The span's values in the order of ``_FIELDS``."""
        return (self.name, self.id, self.parent, self.request, self.start, self.end,
                self.host_ms, self.device_ms)


class _NoSpan:
    """What ``span()`` returns when nothing is to be kept."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


def span(name: str, *, root: bool = False, timed: bool = False, fresh: bool = False,
         device=None):
    """A span, ``with trace.span("frame.cull"): ...`` (module doc).

    ``root=True`` opens a request on ``device`` (its current stream when
    the root opens) where none is open; inside an open request it is a plain
    span. With the record on, every span of a request is kept and timed;
    with it off, only the spans opened with ``timed=True`` are timed (read
    ``Span.ms``). Outside a request a span keeps nothing, but is an
    annotation while ``capture()`` runs.

    On the card a span's device time runs from its request's last event
    when it opens (its parent's start or its previous sibling's end, one
    event for both) to a new event when it closes; ``fresh=True``: from a
    new event, for a span that opens after work launched outside any span
    since then."""
    s = _S
    req = s.request
    if req is None and root:
        dev = torch.device(device) if device is not None else None
        return Span(name, _Request(name, s.on, dev), True, s.on)
    if req is not None and (req.keep or timed):
        return Span(name, req, False, True, fresh)
    if s.profiling:
        return Span(name, None, False, False)
    return _NO_SPAN


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the open request's counter ``name`` (no request, or the
    record off: nothing)."""
    req = _S.request
    if req is not None and req.keep:
        req.counters[name] = req.counters.get(name, 0) + n


def _settle_done() -> None:
    """Settle the closed requests whose last event is done, oldest first
    (inside ``capture()``: the annotation ``trace.settle``)."""
    p = _S.pending
    if not p:
        return
    with torch.profiler.record_function("trace.settle") if _S.profiling \
            else contextlib.nullcontext():
        while p and p[0].done():
            p.popleft().settle()


def records(last: Optional[int] = None) -> List[Dict]:
    """The closed requests kept (the last ``RING``; ``last``: only the last
    so many), oldest first (module doc). Waits for the events of requests
    not yet read."""
    p = _S.pending
    while p:
        req = p.popleft()
        if req.marks:
            req.marks[-1].synchronize()
        req.settle()
    ring = _S.ring
    start = 0 if last is None else max(len(ring) - last, 0)
    return [ring[i].as_dict() for i in range(start, len(ring))]


def enabled(on: Optional[bool] = None) -> bool:
    """The record's switch: sets it when ``on`` is given; returns the value
    it had."""
    was = _S.on
    if on is not None:
        _S.on = bool(on)
    return was


@contextlib.contextmanager
def capture(trace_dir: str, device: str = "cuda") -> Iterator[None]:
    """Capture a profiler trace of the enclosed block into
    ``trace_dir/trace.json`` (CPU and, on the card, CUDA activity), with the
    spans opened inside it as annotations."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("capture(device='cuda') needs a CUDA device; pass device='cpu'")
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    elif device != "cpu":
        raise ValueError(f"capture: device {device!r} is neither 'cuda' nor 'cpu'")
    path = Path(trace_dir) / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    outer, _S.profiling = _S.profiling, True
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        _S.profiling = outer
        prof.export_chrome_trace(str(path))


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
    """Wall-clock per-stage timing."""

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
