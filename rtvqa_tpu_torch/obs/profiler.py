"""Tracing and profiling hooks (the port of ``rtvqa_tpu/obs/profiler.py``):

* ``StageTimer`` — per-stage wall-clock accounting and the frames/sec
  counter, emitted as structured logs or a dict;
* ``device_trace`` — a ``torch.profiler`` trace of a run (behind the CLI's
  ``--trace DIR``), exported as a Chrome trace JSON.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch

from rtvqa_tpu_torch.obs.logging import get_logger

logger = get_logger("rtvqa_tpu_torch.profiler")


class StageTimer:
    """Accumulates wall time per named stage; supports nested use."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.frames: int = 0

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def add_frames(self, n: int) -> None:
        self.frames += n

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
        if total > 0 and self.frames:
            out["frames_per_sec"] = round(self.frames / total, 2)
        return out

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
