"""Per-stage wall-clock accounting (the ``StageTimer`` half of
``rtvqa_tpu/obs/profiler.py``; the device-trace half is not ported, so the
CLI refuses ``--trace``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

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
