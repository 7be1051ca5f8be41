"""Streaming complexity analysis with bounded host and device memory
(counterpart of ``rtvqa_tpu/metrics/complexity_streaming.py``).

``calculate_average_scene_complexity`` holds every sampled frame; the
streaming driver feeds sampled-frame batches to a ``ComplexityAccumulator``
instead. Per chunk of ``chunk`` frames the accumulator prepends the carried
last frame of the previous chunk, runs ``ComplexitySuite.series`` over the
N+1 frames (the gray and block-match kernels on the card) and keeps the
seven per-frame values on the host; ``finalize`` re-indexes the series as
the suite does, smooths them (pandas ``ewm(adjust=True)`` through
``scipy.signal.lfilter``) and averages. Slot g holds sampled frame g against
g-1; framerate variation comes from the host timestamps.

The JAX accumulator pads a ragged chunk to its static size; here no padding
is needed, since every value depends only on its frame and the one before.

Spans and counters (``obs/profiler.py``): ``complexity`` around ``add``
and ``finalize``; ``suite_build`` (and ``suite_builds``) where the suite
is built, its tables' ``.to()`` counted in ``h2d_bytes`` and
``h2d_copies``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from rtvqa_tpu_torch.device import get_device
from rtvqa_tpu_torch.io.stream import VideoStream, prefetch, upload
from rtvqa_tpu_torch.metrics.complexity import METRIC_ORDER, ComplexityResult, ComplexitySuite
from rtvqa_tpu_torch.obs.profiler import count, span

# Row order of the seven device-computed values (framerate variation is
# computed on the host from timestamps).
VALUE_KEYS = ("motion", "dct", "histogram", "edge", "orb", "color", "temporal_dct")


def _chunk_values_body(suite: ComplexitySuite, y, u, v, tail_y, tail_u, tail_v) -> torch.Tensor:
    """Per-frame values of one chunk, (len(VALUE_KEYS), N) f32: the carried
    tail frame is prepended on the device and the (N+1)-frame series runs
    through ``suite.series``."""
    ext = [torch.cat([t[None], a]) for t, a in ((tail_y, y), (tail_u, u), (tail_v, v))]
    vals = suite.series(*ext)
    return torch.stack([vals[k].float() for k in VALUE_KEYS])


def _ewm_mean_host(series: np.ndarray, alpha: float) -> float:
    """pandas ``ewm(alpha, adjust=True).mean()``, then the mean, over N
    scalars: the numerator recursion s_t = (1-a) s_{t-1} + x_t as one
    ``lfilter`` call in float64, the denominator in closed form
    (1 - (1-a)^(t+1)) / a."""
    if series.size == 0:
        return 0.0
    from scipy.signal import lfilter

    q = 1.0 - alpha  # alpha in (0, 1] per config validation, so q in [0, 1)
    x = np.asarray(series, np.float64)
    s = lfilter([1.0], [1.0, -q], x)
    t = np.arange(x.size, dtype=np.float64)
    c = (1.0 - q ** (t + 1.0)) / (1.0 - q) if q else np.ones_like(t)
    return float(np.mean(s / c))


class ComplexityAccumulator:
    """Incremental streaming complexity: feed sampled-frame batches with
    ``add``, get the reference 8-tuple from ``finalize``. The combined
    quality+complexity engine (``metrics.full_reference.analyze_combined``)
    taps its decode loop into one of these, or, in its merged step, feeds
    it the values computed on the staged quality planes (``add_packed``)."""

    def __init__(
        self,
        resize_width: int,
        resize_height: int,
        smoothing_factor: float = 0.8,
        chunk: int = 32,
        block: int = 16,
        radius: int = 8,
        motion_search: str = "pyramid",
        motion_impl: Optional[str] = None,
        device: str | torch.device | None = None,
    ):
        self.device = get_device(device)
        self.resize_width = resize_width
        self.resize_height = resize_height
        self.alpha = float(smoothing_factor)
        self.chunk = chunk
        self.block = block
        self.radius = radius
        self.motion_search = motion_search
        if motion_impl is None:
            motion_impl = "kernel" if self.device.type == "cuda" else "plain"
        self.motion_impl = motion_impl
        self.values: dict[str, list[np.ndarray]] = {k: [] for k in VALUE_KEYS}
        self.timestamps: list[np.ndarray] = []
        self.n_total = 0
        self._suite: Optional[ComplexitySuite] = None  # built for the first chunk's size
        self._prev_tail: Optional[tuple] = None
        self._buf: list[tuple] = []  # pending (y, u, v) batches
        self._buf_ts: list[np.ndarray] = []
        self._buf_n = 0

    def add(self, y: np.ndarray, u: np.ndarray, v: np.ndarray, ts: np.ndarray) -> None:
        """Feed a batch of *sampled* frames ((n,H,W), (n,h,w), (n,h,w), (n,))."""
        with span("complexity"):
            if y.shape[0] == 0:
                return
            self._buf.append((y, u, v))
            self._buf_ts.append(np.asarray(ts, np.float64))
            self._buf_n += y.shape[0]
            if self._buf_n >= self.chunk:
                # Concatenate once, then flush chunk-sized views.
                self._consolidate()
                ys, us, vs = self._buf[0]
                ts_all = self._buf_ts[0]
                off = 0
                while self._buf_n - off >= self.chunk:
                    sl = slice(off, off + self.chunk)
                    self._flush_chunk(ys[sl], us[sl], vs[sl], ts_all[sl])
                    off += self.chunk
                self._buf = [(ys[off:], us[off:], vs[off:])] if off < self._buf_n else []
                self._buf_ts = [ts_all[off:]] if off < self._buf_n else []
                self._buf_n -= off

    def add_packed(self, packed: np.ndarray, ts: np.ndarray) -> None:
        """Feed pre-computed per-frame values for ``len(ts)`` frames:
        ``packed`` is (len(VALUE_KEYS), n) in ``VALUE_KEYS`` order. Must not
        be mixed with pending ``add()`` frames (the two carry chains would
        diverge)."""
        if self._buf_n:
            raise RuntimeError("add_packed cannot be mixed with pending add()")
        n = len(ts)
        if n == 0:
            return
        for row, k in enumerate(VALUE_KEYS):
            self.values[k].append(np.asarray(packed[row, :n], np.float32))
        self.timestamps.append(np.asarray(ts, np.float64))
        self.n_total += n

    def _consolidate(self) -> None:
        if len(self._buf) > 1:
            self._buf = [tuple(np.concatenate([b[i] for b in self._buf]) for i in range(3))]
            self._buf_ts = [np.concatenate(self._buf_ts)]

    def suite(self, height: int, width: int) -> ComplexitySuite:
        """The stream's suite: built for the first frame size it is asked
        for, then reused by every chunk, those ``add`` flushes and the
        merged quality+complexity steps of ``metrics.full_reference``."""
        if self._suite is None:
            with span("suite_build"):
                suite = ComplexitySuite(
                    height, width, self.resize_height, self.resize_width,
                    block=self.block, radius=self.radius, motion_impl=self.motion_impl,
                    motion_search=self.motion_search,
                )
                tables = list(suite.buffers())
                count("h2d_bytes", sum(t.nbytes for t in tables))
                count("h2d_copies", len(tables))
                count("suite_builds")
                self._suite = suite.to(self.device)
        return self._suite

    def _flush_chunk(self, y, u, v, ts) -> None:
        n = y.shape[0]
        planes = [upload(a, self.device) for a in (y, u, v)]
        # Global slot 0 has no predecessor: zeros, whose values finalize drops.
        tail = self._prev_tail or tuple(torch.zeros_like(p[0]) for p in planes)
        packed = _chunk_values_body(self.suite(y.shape[1], y.shape[2]), *planes, *tail).cpu().numpy()
        self._prev_tail = tuple(p[n - 1].clone() for p in planes)
        for row, k in enumerate(VALUE_KEYS):
            self.values[k].append(packed[row])
        self.timestamps.append(ts)
        self.n_total += n

    def finalize(self) -> ComplexityResult:
        with span("complexity"):
            if self._buf_n:
                self._consolidate()
                ys, us, vs = self._buf[0]
                self._flush_chunk(ys, us, vs, self._buf_ts[0])
                self._buf, self._buf_ts, self._buf_n = [], [], 0
            if self.n_total < 2:
                return ComplexityResult(**{k: 0.0 for k in METRIC_ORDER})

            series = {k: np.concatenate(v) for k, v in self.values.items()}
            ts = np.concatenate(self.timestamps)
            a = self.alpha
            out = {}
            for k in ("motion", "dct", "histogram", "edge", "orb", "color"):
                out[k] = _ewm_mean_host(series[k][1:], a)  # slots g = 1..N-1
            out["temporal_dct"] = _ewm_mean_host(series["temporal_dct"][2:], a)
            dt = np.diff(ts) / 1000.0
            fps = np.where(dt > 0, 1.0 / np.maximum(dt, 1e-9), 0.0)
            out["framerate"] = _ewm_mean_host(fps, a)
            return ComplexityResult(**out)


def calculate_average_scene_complexity_streaming(
    video_path: str,
    resize_width: int,
    resize_height: int,
    frame_interval: int = 10,
    smoothing_factor: float = 0.8,
    chunk: int = 32,
    block: int = 16,
    radius: int = 8,
    motion_search: str = "pyramid",
    device: str | torch.device | None = None,
) -> ComplexityResult:
    """Streaming equivalent of ``calculate_average_scene_complexity``: the
    clip is decoded at ``frame_interval`` in batches of ``chunk`` on a
    prefetch thread; ``device`` defaults to the card."""
    acc = ComplexityAccumulator(
        resize_width, resize_height, smoothing_factor, chunk, block, radius,
        motion_search, device=device,
    )
    it = prefetch(VideoStream(video_path, frame_interval, chunk), depth=1)
    try:
        for fb in it:
            acc.add(fb.y, fb.u, fb.v, fb.timestamps_ms)
    finally:
        it.close()
    return acc.finalize()
