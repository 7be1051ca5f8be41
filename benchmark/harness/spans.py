"""The traced run's spans and counters, taken from the benchmark's side of
the calls into each layer of the program (the program has no spans of its
own yet).

``Tracer.install`` wraps, for the traced run only:

* the two staged iterators the loop pulls chunks from (``staging_wait``:
  host time the loop waits in ``next()``);
* ``io/stream.py::upload`` where ``io/stream.py``, ``full_reference`` and
  ``complexity_streaming`` bind it (``h2d_bytes``; a lock, since the
  prefetch threads upload);
* ``full_reference.chunk_kernels`` (``quality``: a profiler range in both
  modes; ``harness/profile.py`` takes the device time of what is launched
  inside it from the profiled stretch's trace);
* ``ComplexityAccumulator.add``/``add_packed``/``finalize`` and the merged
  step's ``full_reference._chunk_values_body`` (``complexity``: host clock
  between two synchronizes);
* the pooling call (``pool``: host clock; it runs on the host).

In ``annotate`` mode (the profiled stretch) each span is only a
``torch.profiler.record_function`` range, so the trace can name what the
host was doing in a device gap without synchronizes of its own; in
``time`` mode the spans measure and the counters count.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

import torch


class TimedIter:
    """An iterator whose ``next()`` waits are a span."""

    def __init__(self, it, tracer, count_chunks: bool):
        self.it, self.tracer, self.count_chunks = it, tracer, count_chunks

    def __iter__(self):
        return self

    def __next__(self):
        with self.tracer.span("staging_wait"):
            item = next(self.it)
        if self.count_chunks and self.tracer.timing:
            self.tracer.counts["chunks"] += 1
        return item

    def close(self):
        self.it.close()


class Tracer:
    def __init__(self, prog, cuda: bool = True):
        self.prog = prog
        self.cuda = cuda  # False only where the tests drive a run on the CPU
        self.timing = False
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._lock = threading.Lock()
        self._main = threading.main_thread()
        self._saved = []

    # --- spans ----------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        if not self.timing:
            with torch.profiler.record_function(f"bench.{name}"):
                yield
            return
        if sync and self.cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync and self.cuda:
                torch.cuda.synchronize()
            self.totals[f"{name}_s"] += time.perf_counter() - t0

    def wrap_iters(self, ref_it, dis_it):
        return TimedIter(ref_it, self, True), TimedIter(dis_it, self, False)

    # --- wrappers around the program's functions ------------------------

    def _patch(self, owner, name, wrapper):
        real = getattr(owner, name)
        self._saved.append((owner, name, real))
        setattr(owner, name, wrapper(real))

    def install(self):
        fr, cs, stream = self.prog.full_reference, self.prog.complexity_streaming, self.prog.stream
        tracer = self

        def quality(real):
            def chunk_kernels(*args, **kwargs):
                with torch.profiler.record_function("bench.quality"):
                    return real(*args, **kwargs)
            return chunk_kernels

        def complexity(real):
            def call(*args, **kwargs):
                with tracer.span("complexity", sync=True):
                    return real(*args, **kwargs)
            return call

        def counted(real):
            def upload(a, device):
                if tracer.timing:
                    with tracer._lock:
                        tracer.counts["h2d_bytes"] += a.nbytes
                if threading.current_thread() is tracer._main and not tracer.timing:
                    with torch.profiler.record_function("bench.upload"):
                        return real(a, device)
                return real(a, device)
            return upload

        self._patch(fr, "chunk_kernels", quality)
        self._patch(fr, "_chunk_values_body", complexity)
        for method in ("add", "add_packed", "finalize"):
            self._patch(cs.ComplexityAccumulator, method, complexity)
        for mod in (stream, fr, cs):
            self._patch(mod, "upload", counted)

    def uninstall(self):
        while self._saved:
            owner, name, real = self._saved.pop()
            setattr(owner, name, real)
