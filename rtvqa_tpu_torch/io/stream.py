"""Streaming frame ingestion for the port: bounded-memory batches, a
background prefetcher, and device staging (the port's own copy of
``rtvqa_tpu/io/stream.py``, with a torch ``stage_to_device``).

``VideoStream`` yields fixed-size YUV420 batches from the native streaming
decoder; ``prefetch`` runs any iterator one batch ahead on a thread, so host
decode overlaps device compute; ``stage_to_device`` uploads every batch of
up to ``chunk`` frames on that thread through pinned host buffers with
``non_blocking=True``, and pads a ragged tail to ``chunk`` frames on the
device by repeating its last frame (``upload_rows``).

Spans and counters (``obs/profiler.py``): ``stage`` per staged batch,
``staged_chunks`` (every staged batch) and ``staged_tails`` (those padded
on the device) on the producer thread, ``wait`` in the consumer's
``next()`` and ``close`` when it lets go, ``h2d_bytes`` and ``h2d_copies``
at every ``upload``.
"""

from __future__ import annotations

import contextvars
import ctypes
import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from rtvqa_tpu_torch.io import video as vio
from rtvqa_tpu_torch.obs.profiler import count, span


@dataclasses.dataclass
class FrameBatch:
    y: np.ndarray            # (B, H, W) uint8
    u: np.ndarray            # (B, ceil(H/2), ceil(W/2)) uint8
    v: np.ndarray
    timestamps_ms: np.ndarray  # (B,) float64
    start_index: int         # global index of the first sampled frame


@dataclasses.dataclass(frozen=True)
class StreamInfo:
    width: int
    height: int
    chroma_w: int
    chroma_h: int
    bit_rate: int
    avg_fps: float


class VideoStream:
    """Iterator over sampled-frame batches of one clip (bounded memory)."""

    def __init__(self, path: str, frame_interval: int = 1, batch: int = 32):
        vio.validate_video_path(path)
        self._lib = vio._load()
        self._handle = self._lib.rtvqa_stream_open(path.encode(), int(frame_interval))
        if not self._handle:
            raise RuntimeError(f"stream open failed: {vio._err(self._lib)}")
        raw = (ctypes.c_int64 * 6)()
        self._lib.rtvqa_stream_info(self._handle, raw)
        w, h, cw, ch, bitrate, fps_milli = (int(x) for x in raw)
        self.info = StreamInfo(w, h, cw, ch, bitrate, fps_milli / 1000.0)
        self.batch = batch
        self._consumed = 0

    def __iter__(self) -> Iterator[FrameBatch]:
        return self

    def __next__(self) -> FrameBatch:
        if self._handle is None:
            raise StopIteration
        i = self.info
        y = np.empty((self.batch, i.height, i.width), np.uint8)
        u = np.empty((self.batch, i.chroma_h, i.chroma_w), np.uint8)
        v = np.empty((self.batch, i.chroma_h, i.chroma_w), np.uint8)
        ts = np.empty((self.batch,), np.float64)
        n = self._lib.rtvqa_stream_next(
            self._handle, vio._u8(y), vio._u8(u), vio._u8(v),
            ts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), self.batch,
        )
        if n < 0:
            self.close()
            raise RuntimeError(f"stream decode failed: {vio._err(self._lib)}")
        if n == 0:
            self.close()
            raise StopIteration
        start = self._consumed
        self._consumed += n
        return FrameBatch(y[:n], u[:n], v[:n], ts[:n], start)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.rtvqa_stream_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_SENTINEL = object()


def prefetch(iterator: Iterator, depth: int = 1) -> Iterator:
    """Run ``iterator`` in a background thread, ``depth`` items ahead.

    If the consumer abandons the generator (``break``, exception, garbage
    collection), the producer is cancelled and the iterator's ``close()`` is
    called, so decoder contexts are released at once. An exception in the
    producer is raised in the consumer. The producer runs in a copy of the
    context of the consumer's first ``next()``, so its spans belong to the
    span (and clip) the consumer was in.
    """
    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list[BaseException] = []
    cancelled = threading.Event()

    def worker():
        try:
            for item in iterator:
                while not cancelled.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if cancelled.is_set():
                    return
        except BaseException as e:  # handed to the consumer, which raises it
            err.append(e)
        finally:
            close = getattr(iterator, "close", None)
            if close is not None:
                close()
            while True:  # the sentinel must land even if the queue is full
                try:
                    q.put(_SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    if cancelled.is_set():
                        break

    t = threading.Thread(target=contextvars.copy_context().run, args=(worker,), daemon=True)
    t.start()
    try:
        while True:
            with span("wait"):
                item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        with span("close"):
            cancelled.set()
            try:  # free one slot so a producer blocked in q.put sees the flag
                q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5.0)


def stream_batches(
    path: str, frame_interval: int = 1, batch: int = 32, prefetch_depth: int = 1
) -> Iterator[FrameBatch]:
    """Sampled-frame batches of one clip, decoded ``prefetch_depth`` batches
    ahead on a background thread."""
    return prefetch(VideoStream(path, frame_interval, batch), depth=prefetch_depth)


@dataclasses.dataclass
class StagedFrameBatch:
    """A decoded batch plus its planes on the device.

    ``y/u/v`` are device tensors of ``chunk`` frames for a batch of 1 to
    ``chunk`` frames (a ragged tail's rows beyond its frames repeat its
    last frame). ``host`` carries the decoded numpy planes, unpadded.
    """

    host: FrameBatch
    y: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device``. For a card the bytes go through a
    pinned host buffer with ``non_blocking=True``: the copy is queued on the
    current stream, so work queued after it on that stream sees the data,
    and the caching host allocator keeps the pinned buffer until the copy
    has run."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    count("h2d_bytes", t.nbytes)
    count("h2d_copies")
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def repeat_last(p: torch.Tensor, n: int) -> torch.Tensor:
    """Rows ``n`` onwards of ``p`` set, in place on its device, to copies
    of row ``n - 1``; returns ``p``."""
    if n < p.shape[0]:
        p[n:] = p[n - 1]
    return p


def upload_rows(a: np.ndarray, rows: int, device: torch.device) -> torch.Tensor:
    """``a``'s ``n <= rows`` frames as a plane of ``rows`` frames on
    ``device``: the ``n`` frames go through ``upload``; for ``n < rows``
    they are copied on the device into the head of a fresh plane whose
    other rows repeat frame ``n - 1`` (``repeat_last``), and the ``n``-frame
    tensor is let go."""
    t = upload(a, device)
    n = a.shape[0]
    if n == rows:
        return t
    out = torch.empty((rows, *t.shape[1:]), dtype=t.dtype, device=device)
    out[:n] = t
    return repeat_last(out, n)


def stage_to_device(
    iterator: Iterator[FrameBatch], chunk: int, device: torch.device
) -> Iterator[StagedFrameBatch]:
    """Wrap a FrameBatch iterator, staging each batch of 1 to ``chunk``
    frames onto ``device`` as planes of ``chunk`` frames, a ragged tail
    padded there (``upload_rows``), one plane at a time. A batch of no
    frames or of more than ``chunk`` raises ``ValueError``.

    Meant to run inside ``prefetch``, so the upload and the padding are
    issued on the producer thread: ``prefetch(stage_to_device(
    VideoStream(...), chunk, dev))``.
    """
    try:
        for fb in iterator:
            n = fb.y.shape[0]
            if not 0 < n <= chunk:
                raise ValueError(f"stage_to_device takes batches of 1 to {chunk} frames, got {n}")
            with span("stage"):
                planes = tuple(upload_rows(a, chunk, device) for a in (fb.y, fb.u, fb.v))
            count("staged_chunks")
            if n < chunk:
                count("staged_tails")
            yield StagedFrameBatch(fb, *planes)
    finally:
        close = getattr(iterator, "close", None)
        if close is not None:
            close()
