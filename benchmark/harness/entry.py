"""The entry the window drives: one clip through what
``rtvqa_tpu_torch/metrics/full_reference.py::analyze_combined`` runs after
the streams are open, with the clip's frames handed over as decoded host
batches in place of ``VideoStream``'s.

Per clip: ``auto_chunk`` for the frame size; a ``ComplexityAccumulator``
with the configuration's keys; ref and dis each as
``prefetch(stage_to_device(<FrameBatch iterator>, chunk, dev), depth=1)``;
``combined_chunk_loop`` with ``merged=resolve_merged(None, frame_interval,
dev)`` (the program's own choice of the tap or the merged step); then
``pool_full_reference``. Staging, pinning, H2D, padding and pooling are in
the clip's time; decode is not.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import time

import numpy as np


class Program:
    """The system under test: the modules of ``rtvqa_tpu_torch`` the entry
    calls into, imported by name."""

    def __init__(self):
        from rtvqa_tpu_torch.config import schema
        from rtvqa_tpu_torch.io import stream
        from rtvqa_tpu_torch.metrics import complexity_streaming, full_reference

        self.schema, self.stream = schema, stream
        self.full_reference, self.complexity_streaming = full_reference, complexity_streaming
        # The CLI sends the program's log to a file; here it goes nowhere,
        # so the builtin-VMAF warning of every clip does not reach stderr.
        log = logging.getLogger("rtvqa_tpu_torch")
        log.addHandler(logging.NullHandler())
        log.propagate = False

    def config(self, cell_config: dict):
        """The configuration's program keys, validated as the CLI does."""
        return self.schema.Config.from_dict(cell_config["analysis"])

    def build(self) -> None:
        """Build (first run in a checkout) or load the kernel library."""
        from rtvqa_tpu_torch.kernels import _build

        _build.load_library()


@dataclasses.dataclass
class Answer:
    """What the program returned for one clip."""

    clip: object
    n_frames: int
    series: dict
    pooled: dict
    complexity: dict
    slot_lists: dict      # the accumulator's per-slot values, still in chunks
    ts_list: list
    seconds: float

    @functools.cached_property
    def slots(self) -> dict:
        return {k: np.concatenate(v) if v else np.zeros(0, np.float32) for k, v in self.slot_lists.items()}

    @functools.cached_property
    def slot_ts(self) -> np.ndarray:
        return np.concatenate(self.ts_list) if self.ts_list else np.zeros(0)


def analyze_clip(prog: Program, cfg, pool, clip, device, tracer=None) -> Answer:
    """One clip, closed loop: returns when its pooled results are on the host."""
    fr, st = prog.full_reference, prog.stream
    t0 = time.perf_counter()
    h, w = pool.ref[0].shape[1:]
    chunk = fr.auto_chunk(w, h)
    acc = prog.complexity_streaming.ComplexityAccumulator(
        cfg.resize_width, cfg.resize_height, cfg.smoothing_alpha, cfg.batch_size,
        motion_search=cfg.motion_search, device=device,
    )
    ref_it = st.prefetch(st.stage_to_device(pool.batches("ref", clip, chunk, st.FrameBatch), chunk, device), depth=1)
    dis_it = st.prefetch(st.stage_to_device(pool.batches("dis", clip, chunk, st.FrameBatch), chunk, device), depth=1)
    loop_its = tracer.wrap_iters(ref_it, dis_it) if tracer else (ref_it, dis_it)
    impl = "kernel" if device.type == "cuda" else "plain"
    try:
        series, n, comp = fr.combined_chunk_loop(
            *loop_its, chunk, acc, cfg.frame_interval, "ref" if cfg.analyze_original else "dis",
            None, None, device, impl, fr.resolve_merged(None, cfg.frame_interval, device),
        )
    finally:
        ref_it.close()
        dis_it.close()
    with tracer.span("pool") if tracer else contextlib.nullcontext():
        q = fr.pool_full_reference(series, n)
    seconds = time.perf_counter() - t0
    return Answer(clip, n, series, {k: q[k] for k in ("psnr", "ssim", "vmaf")},
                  dataclasses.asdict(comp), acc.values, acc.timestamps, seconds)
