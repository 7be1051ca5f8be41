"""Frames wider than ``FUSED_MAX_WIDTH`` (the JAX package's TPU width gate)
through the fused kernel body in the merged step, on the CPU, against the
benchmark's plain reference.

``combined_chunk_loop(..., impl="kernel", merged=True)`` with CPU tensors
runs ``chunk_kernels`` on the plain versions of kernels 3, 5, 6 and 7: 10
frames of 40x3856 and of 40x4096 (the DCI-4K cell's width) at chunk 4 (two
chunks and a 2-frame tail padded on the device, the blur carried across
chunks). The answer is held to ``benchmark/reference`` as
``benchmark/harness/check.py`` holds a run's, at the limits of the DCI-4K
cell.
"""

import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import check, entry, frames, traffic  # noqa: E402
from rtvqa_tpu_torch.io import stream  # noqa: E402
from rtvqa_tpu_torch.metrics import complexity_streaming, full_reference  # noqa: E402

BENCH = ROOT / "benchmark"
CELL = "dci4k_every_frame.longform"
N, CHUNK, H = 10, 4, 40
CPU = torch.device("cpu")


def cell_files(width: int):
    """The cell's configuration at 40 x ``width`` with a pool of N pairs, its mix and its limits."""
    cfg = json.loads((BENCH / "configs" / "dci4k_every_frame.json").read_text())
    cfg.update(width=width, height=H, frame_pool_pairs=N)
    mix = json.loads((BENCH / "traffic" / "longform.json").read_text())
    limits = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())
    return cfg, mix, limits


def run_wide_clip(pool, cfg):
    """One N-frame clip of ``pool`` through the merged step at CHUNK, as
    ``harness/entry.py`` drives it; returns the harness's ``Answer``."""
    an = cfg["analysis"]
    clip = traffic.Clip(N, 0)
    acc = complexity_streaming.ComplexityAccumulator(
        an["resize_width"], an["resize_height"], an["smoothing_alpha"], an["batch_size"],
        motion_search=an["motion_search"], device=CPU)
    its = [stream.prefetch(stream.stage_to_device(pool.batches(side, clip, CHUNK, stream.FrameBatch), CHUNK, CPU),
                           depth=1) for side in ("ref", "dis")]
    try:
        series, n, comp = full_reference.combined_chunk_loop(
            *its, CHUNK, acc, an["frame_interval"], "dis", None, None, CPU, "kernel", True)
    finally:
        for it in its:
            it.close()
    q = full_reference.pool_full_reference(series, n)
    return entry.Answer(clip, n, series, {k: q[k] for k in ("psnr", "ssim", "vmaf")},
                        dataclasses.asdict(comp), acc.values, acc.timestamps, 0.0)


@pytest.mark.parametrize("seed", [2**31 + 7, 1618033988])
@pytest.mark.parametrize("width", [3856, 4096])
def test_fused_body_in_the_merged_step_matches_the_reference(width, seed, monkeypatch):
    cfg, mix, limits = cell_files(width)
    assert cfg["width"] > full_reference.FUSED_MAX_WIDTH
    pool = frames.make_pool(cfg, mix, seed, CPU)
    assert full_reference.resolve_merged(True, cfg["analysis"]["frame_interval"], CPU)
    calls = []
    real = full_reference.quality_fused_cuda
    monkeypatch.setattr(full_reference, "quality_fused_cuda", lambda *a, **k: calls.append(1) or real(*a, **k))
    answer = run_wide_clip(pool, cfg)
    assert len(calls) == -(-N // CHUNK) == 3
    assert answer.n_frames == N and all(len(v) == N for v in answer.series.values())

    verdict = check.run_check(pool, [answer], cfg, limits, seed, CPU, CHUNK)
    assert verdict["sampled_frames"] == N and verdict["sampled_slots"] == N - 1
    for k in check.NUMBERS:
        assert verdict["numbers"][k] <= limits[k], (k, verdict["numbers"])
    assert verdict["correct"] and verdict["failed"] == 0
