"""The benchmark's plain reference against the port's plain route on the
CPU, at a tiny size: the per-frame quality series, the complexity values
per slot, the pooling and the smoothing.

    python -m pytest benchmark/tests
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark.harness import frames
from benchmark.reference import complexity as ref_complexity
from benchmark.reference import pool as ref_pool
from benchmark.reference import prec
from benchmark.reference import quality as ref_quality

from bench_toy import BENCH

N, H, W = 12, 64, 96


def pool_of(mix: str, seed: int):
    cfg = json.loads((BENCH / "configs" / "hd1080_default.json").read_text())
    cfg.update(width=W, height=H, frame_pool_pairs=N)
    tr = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    if tr.get("letterbox_aspect"):
        tr["letterbox_aspect"] = 2.4   # 6 black rows each side at 64x96
    return frames.make_pool(cfg, tr, seed, torch.device("cpu"))


def planes(pool):
    return [torch.from_numpy(a) for a in (*pool.ref, *pool.dis)]


def close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(got - want) <= rtol * np.maximum(np.abs(want), 1e-3)), (got, want)


@pytest.mark.parametrize("mix", ["shots", "scope"])
def test_quality_series_agree_with_the_ports_plain_chunk(mix):
    from rtvqa_tpu_torch.metrics.full_reference import CHUNK_KEYS, chunk_plain

    prec.exact()
    ry, ru, rv, dy, du, dv = planes(pool_of(mix, 21))
    half = N // 2
    # The port in two chunks, the blur carried; the reference per frame.
    a, blur = chunk_plain(ry[:half], ru[:half], rv[:half], dy[:half], du[:half], dv[:half],
                          torch.zeros(H, W), False)
    b, _ = chunk_plain(ry[half:], ru[half:], rv[half:], dy[half:], du[half:], dv[half:], blur, True)
    port = torch.cat([a, b], dim=1)
    prev = torch.cat([ry[:1], ry[:-1]])
    ref = ref_quality.quality_frames(ry, ru, rv, dy, du, dv, prev, torch.arange(N) > 0)
    assert tuple(ref) == CHUNK_KEYS
    for row, k in enumerate(CHUNK_KEYS):
        close(port[row].numpy(), ref[k].numpy(), 1e-6)


def test_complexity_values_agree_with_the_ports_suite():
    from rtvqa_tpu_torch.metrics.complexity import ComplexitySuite
    from rtvqa_tpu_torch.metrics.complexity_streaming import VALUE_KEYS

    prec.exact()
    pool = pool_of("shots", 22)
    y, u, v = (torch.from_numpy(a) for a in pool.dis)
    port = ComplexitySuite(H, W, 64, 64, motion_impl="plain").series(y, u, v)
    ref = ref_complexity.pair_values(y[:-1], u[:-1], v[:-1], y[1:], u[1:], v[1:], 64, 64)
    assert tuple(ref) == VALUE_KEYS
    for k in VALUE_KEYS:
        close(port[k].numpy(), ref[k].numpy(), 1e-5)


def test_pooling_and_smoothing_agree_with_the_port():
    from rtvqa_tpu_torch.metrics.complexity_streaming import ComplexityAccumulator
    from rtvqa_tpu_torch.metrics.full_reference import pool_full_reference

    rng = np.random.default_rng(3)
    series = {k: rng.uniform(0.2, 1.0, 40).astype(np.float32) for k in ref_quality.KEYS}
    series["mse_avg"] = rng.uniform(3, 9, 40).astype(np.float32)
    series["motion_sad"][0] = 0.0
    port = pool_full_reference(series, 40)
    ref = ref_pool.pool_quality(series)
    for k in ("psnr", "ssim", "vmaf"):
        close(port[k], ref[k], 1e-6)
    acc = ComplexityAccumulator(64, 64, 0.8, 8, device="cpu")
    slots = {k: rng.uniform(1, 100, 30).astype(np.float32) for k in ref_complexity.VALUE_KEYS}
    ts = np.arange(30) * 1000.0 / 24 * 10
    ts[7] = ts[6]                        # a repeated timestamp: fps 0 there
    acc.add_packed(np.stack([slots[k] for k in ref_complexity.VALUE_KEYS]), ts)
    got = acc.finalize()
    want = ref_pool.pool_complexity(slots, ts, 0.8)
    for k in ref_pool.COMPLEXITY_KEYS:
        close(getattr(got, k), want[k], 1e-9)


def test_lowered_precision_moves_the_reference():
    """The control's precision changes the values (and exact() restores)."""
    ry, ru, rv, dy, du, dv = planes(pool_of("shots", 23))
    prev = torch.cat([ry[:1], ry[:-1]])
    exact = ref_quality.quality_frames(ry, ru, rv, dy, du, dv, prev, torch.arange(N) > 0)
    with prec.lowered():
        low = ref_quality.quality_frames(ry, ru, rv, dy, du, dv, prev, torch.arange(N) > 0)
    assert prec.FLOAT is torch.float32 and not torch.backends.cuda.matmul.allow_tf32
    assert float((low["vif_scale0"].float() - exact["vif_scale0"]).abs().max()) > 1e-3


@pytest.mark.parametrize("mix", ["shots", "scope"])
def test_each_frame_reads_far_from_its_neighbour(mix):
    """The step, noise and distortion are drawn per frame, so an answer
    copied from the next frame reads far outside the check's limit."""
    from benchmark.harness import check

    prec.exact()
    ry, ru, rv, dy, du, dv = planes(pool_of(mix, 5))
    prev = torch.cat([ry[:1], ry[:-1]])
    vals = ref_quality.quality_frames(ry, ru, rv, dy, du, dv, prev, torch.arange(N) > 0)
    here = {k: v.double().numpy()[2:] for k, v in vals.items()}
    neighbour = {k: v.double().numpy()[1:-1] for k, v in vals.items()}
    limit = json.loads((BENCH / "limits" / "hd1080_default.shots.json").read_text())["quality_rel"]
    errors = check.rel_errors(neighbour, here)
    assert errors.min() > 10 * limit, errors
