"""Tracing and profiling hooks (the port of ``rtvqa_tpu/obs/profiler.py``):

* ``StageTimer`` — the program's tracer: per-stage wall-clock accounting and
  the frames/sec counter, emitted as structured logs or a dict; while it is
  the active tracer (``with timer.active():``) it also keeps a record of
  every span the library opens and the counters it counts;
* ``span(name)``, ``clip()`` and ``count(name, n)`` — what library code
  calls at its layer boundaries. With no active tracer a call reads one
  global and returns: no clock, no profiler range, no allocation;
* ``device_trace`` — a ``torch.profiler`` trace of a run (behind the CLI's
  ``--trace DIR``), exported as a Chrome trace JSON.

A span record holds its name, start and end (``time.perf_counter``
seconds), its id, the id of the span it opened inside (``parent``), the
thread, and the id of the ``clip`` span it belongs to. Parent and clip
pass through ``contextvars``, so a thread started inside a span with its
context copied (``io/stream.py::prefetch``) files its spans under the clip
that started it. While a ``torch.profiler`` profile records the thread, an
active span is also a ``rtvqa.<name>`` range of that profile, so the
program's spans sit on the device trace's own clock.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import os
import threading
import time
from typing import Iterator, NamedTuple, Optional

import torch

from rtvqa_tpu_torch.obs.logging import get_logger

logger = get_logger("rtvqa_tpu_torch.profiler")

PREFIX = "rtvqa."

# The tracer that span(), clip() and count() record into; None when tracing
# is off. Set only by StageTimer.active().
_active: Optional["StageTimer"] = None
_parent: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar("rtvqa_span_parent", default=None)
_clip: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar("rtvqa_clip", default=None)
_OFF = contextlib.nullcontext()


class SpanRecord(NamedTuple):
    name: str
    start: float
    end: float
    id: int
    parent: Optional[int]
    thread: int
    clip: Optional[int]
    stage: bool       # opened by StageTimer.stage (the CLI's phases)


class _Span:
    """One open span of ``timer``; a record once it closes."""

    __slots__ = ("timer", "name", "root", "stage", "id", "parent", "clip", "t0", "tokens", "range")

    def __init__(self, timer: "StageTimer", name: str, root: bool = False, stage: bool = False):
        self.timer, self.name, self.root, self.stage = timer, name, root, stage

    def __enter__(self):
        self.id = next(self.timer._ids)
        self.parent = _parent.get()
        self.tokens = (_parent.set(self.id), _clip.set(self.id) if self.root else None)
        self.clip = _clip.get()
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(PREFIX + self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.range is not None:
            self.range.__exit__(*exc)
        if self.tokens[1] is not None:
            _clip.reset(self.tokens[1])
        _parent.reset(self.tokens[0])
        self.timer.records.append(SpanRecord(self.name, self.t0, t1, self.id, self.parent,
                                             threading.get_ident(), self.clip, self.stage))
        return False


def span(name: str):
    """A span called ``name`` in the active tracer, as a context manager."""
    timer = _active
    return _OFF if timer is None else _Span(timer, name)


def clip():
    """The root span of one clip (``clip``): the spans opened inside it, on
    any thread that inherits its context, carry its id. Inside another clip
    it is no span, so a caller may open the clip around more of the work."""
    timer = _active
    if timer is None or _clip.get() is not None:
        return _OFF
    return _Span(timer, "clip", root=True)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the active tracer's counter ``name``."""
    timer = _active
    if timer is not None:
        with timer._lock:
            timer.counters[name] = timer.counters.get(name, 0) + n


class StageTimer:
    """Accumulates wall time per named stage; supports nested use. The
    program's tracer while ``active()``: span records and counters."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self.reset()

    def reset(self) -> None:
        """Forget every stage, frame, span record and counter."""
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.frames: int = 0
        self.records: list[SpanRecord] = []
        self.counters: dict[str, int] = {}
        self._wall: Optional[list[float]] = None  # first stage's start, last stage's end

    @contextlib.contextmanager
    def active(self) -> Iterator["StageTimer"]:
        """Make this the tracer that ``span``/``clip``/``count`` record into."""
        global _active
        prev, _active = _active, self
        try:
            yield self
        finally:
            _active = prev

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        if self._wall is None:
            self._wall = [t0, t0]
        try:
            with _Span(self, name, stage=True) if _active is self else _OFF:
                yield
        finally:
            t1 = time.perf_counter()
            self._wall[1] = max(self._wall[1], t1)
            self.totals[name] = self.totals.get(name, 0.0) + (t1 - t0)
            self.counts[name] = self.counts.get(name, 0) + 1

    def add_frames(self, n: int) -> None:
        self.frames += n

    def span_totals(self) -> dict[str, dict]:
        """Seconds and calls per span name (stages left out), over every
        thread, so spans of two threads at once both count."""
        out: dict[str, dict] = {}
        for r in self.records:
            if not r.stage:
                t = out.setdefault(r.name, {"seconds": 0.0, "calls": 0})
                t["seconds"] += r.end - r.start
                t["calls"] += 1
        return out

    def summary(self) -> dict:
        total = sum(self.totals.values())
        out = {
            "stages": {
                k: {"seconds": round(v, 4), "calls": self.counts[k]}
                for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])
            },
            "total_seconds": round(total, 4),
            "frames": self.frames,
        }
        wall = self._wall[1] - self._wall[0] if self._wall else 0.0
        if wall > 0 and self.frames:
            # Over the wall clock from the first stage's start to the last
            # stage's end: nested stages overlap, so their sum is no window.
            out["frames_per_sec"] = round(self.frames / wall, 2)
        if self.records or self.counters:
            spans = sorted(self.span_totals().items(), key=lambda kv: -kv[1]["seconds"])
            out["spans"] = {k: {"seconds": round(v["seconds"], 6), "calls": v["calls"]} for k, v in spans}
            out["counters"] = dict(sorted(self.counters.items()))
        return out

    def write(self, path: str) -> None:
        """The span records as a Chrome trace JSON (every thread's spans,
        on the host's ``perf_counter`` clock in microseconds)."""
        pid = os.getpid()
        events = [{"ph": "X", "cat": "rtvqa", "name": PREFIX + r.name, "pid": pid, "tid": r.thread,
                   "ts": r.start * 1e6, "dur": (r.end - r.start) * 1e6,
                   "args": {"id": r.id, "parent": r.parent, "clip": r.clip}} for r in self.records]
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "counters": self.counters}, f)

    def log_summary(self) -> None:
        logger.info("profile: %s", self.summary())


@contextlib.contextmanager
def device_trace(log_dir: str | None, device: str | torch.device | None = None) -> Iterator[str | None]:
    """``torch.profiler`` trace of the block when ``log_dir`` is set; a no-op
    (yielding None) otherwise. CPU activity always, CUDA activity when
    ``device`` is a GPU (``None`` is the card, the port's default). Yields
    the path of the Chrome trace JSON that is written into ``log_dir`` when
    the block ends (open it in Perfetto or ``chrome://tracing``)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device("cuda" if device is None else device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"rtvqa_torch.{os.getpid()}.{time.time_ns()}.pt.trace.json")
    prof = profile(activities=activities)
    prof.start()
    try:
        yield path
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
        logger.info("device trace written to %s", path)
