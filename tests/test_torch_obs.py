"""The port's observability: ``obs/roofline.py`` against the JAX package's
byte counts and the expected H100 bounds, and ``obs/profiler.py::
device_trace``.
"""

import json
import os

import pytest
import torch

from rtvqa_tpu.obs import roofline as jax_roofline
from rtvqa_tpu_torch.obs import roofline
from rtvqa_tpu_torch.obs.profiler import device_trace

SIZES = [(1080, 1920), (2160, 3840)]


@pytest.mark.parametrize("phase", ["quality_roofline", "complexity_roofline"])
@pytest.mark.parametrize("h,w", SIZES)
def test_bytes_per_frame_match_the_jax_module(phase, h, w):
    """The port's phases move the same arrays as the TPU path."""
    got = getattr(roofline, phase)(h, w)
    assert got["bytes_per_frame"] == getattr(jax_roofline, phase)(h, w)["bytes_per_frame"]
    assert set(got) == {"bytes_per_frame", "ops_per_frame"}


@pytest.mark.parametrize("phase", ["quality_roofline", "complexity_roofline"])
def test_counts_scale_with_pixels(phase):
    """Bytes scale exactly 4x from 1080p to 2160x3840; operations within 1%
    of that (the ceil(h/2) rounding of the deeper scales)."""
    small, large = (getattr(roofline, phase)(h, w) for h, w in SIZES)
    assert large["bytes_per_frame"] == 4 * small["bytes_per_frame"]
    assert large["ops_per_frame"] == pytest.approx(4 * small["ops_per_frame"], rel=1e-2)


@pytest.mark.parametrize("phase,seconds", [("quality_roofline", 1e-3), ("complexity_roofline", 2e-4)])
def test_attach_measured_gives_shares(phase, seconds):
    counts = getattr(roofline, phase)(1080, 1920)
    out = roofline.attach_measured(counts, seconds)
    assert out["seconds_per_frame"] == seconds
    for key in ("pct_hbm_roofline", "pct_f32_roofline"):
        assert 0 < out[key] < 100, (key, out[key])
    assert out["pct_hbm_roofline"] == pytest.approx(
        100 * counts["bytes_per_frame"] / seconds / roofline.HBM_BYTES_PER_S, abs=0.01)


@pytest.mark.parametrize("work,ms,by", [
    (roofline.adm_input_work(64, 1080, 1920, 23), 0.0792, "bytes"),
    (roofline.strip_sum_work(16, 1080, 1920, 1), 0.0099, "bytes"),
    (roofline.strip_sum_work(16, 1080, 1920, 4), 0.0396, "bytes"),
    (roofline.strip_floor_work(128, 1088, 2176, 4), 0.3539, "bytes"),
    (roofline.strip_floor_work(128, 1088, 2176, 2), 0.1769, "bytes"),
    (roofline.strip_floor_work(128, 1088, 2176, 1), 0.0885, "bytes"),
    (roofline.adm_scale0_work(64, 1080, 1920), 0.1585, "bytes"),
    (roofline.quality_work(64, 1080, 1920, 540, 960), 0.8497, "operations"),
    (roofline.vif_scale_work(14, 2160, 4096), 0.7182, "operations"),
])
def test_kernel_bounds_on_the_h100(work, ms, by):
    """Kernels 6a, 8 and 9 at the probes' shapes, and three main-path
    kernels (3, 6, and 4 at scale 0 of a DCI-4K chunk) at the bounds PERF.md
    has carried since they were ported."""
    bound, bound_by = roofline.kernel_bound(*work)
    assert bound == pytest.approx(ms, abs=1e-4) and bound_by == by


@pytest.mark.parametrize("scale", [1, 2, 3])
def test_vif_scale_work_is_kernel_5s_per_scale(scale):
    """Kernel 4 at scales 1-3 of a 64-frame 1080p chunk (scale 1 is 540 x
    960) does kernel 5's operations at that scale: the 2^(4-s)+1-tap
    statistics and, below scale 3, the 2^(3-s)+1-tap decimation; it reads
    its f32 pair and writes the next scale's (none after scale 3). Summed
    over the three scales, the operations are kernel 5's."""
    b, shapes = 64, {1: (540, 960), 2: (270, 480), 3: (135, 240)}
    h, w = shapes[scale]
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    taps, dec = 2 ** (4 - scale) + 1, 2 ** (3 - scale) + 1
    ops = (3 + 10 * (2 * taps - 1) + 30) * h * w  # five moments, two passes; products, statistics
    if scale < 3:
        ops += 2 * (2 * dec - 1) * (h2 * w + h2 * w2)  # both images, even rows, then even columns
    planes = 2 * 4 * b * h2 * w2 if scale < 3 else 0
    assert roofline.vif_scale_work(b, h, w, 4, scale) == (2 * 4 * b * h * w + planes + 4 * b, b * ops)
    total = sum(roofline.vif_scale_work(b, *shapes[s], 4, s)[1] for s in shapes)
    assert total == roofline.vif_tail_work(b, 540, 960)[1]


def test_probe_windows_overlap_their_functions_bytes():
    """Kernel 8 reads its frames once (and writes one f32 per frame);
    kernel 9's windows are 22 windows of 56 rows over the 1064 rows they
    cover (1.373 GB in f32)."""
    assert roofline.strip_sum_work(16, 1080, 1920, 4) == (16 * 1080 * 1920 * 4 + 4 * 16, 16 * 1080 * 1920)
    covered = roofline.strip_floor_work(128, 1088, 2176, 4)[0] - 4
    assert covered == 128 * 1064 * 2176 * 4
    assert roofline.strip_floor_windows(128, 1088, 2176, 4) == 128 * 22 * 56 * 2176 * 4 == 1_372_585_984


def test_device_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with device_trace(str(log_dir), "cpu") as path:
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    assert os.path.dirname(path) == str(log_dir) and os.path.getsize(path) > 0
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)


def test_device_trace_without_a_directory_is_a_no_op(tmp_path):
    with device_trace(None) as path:
        torch.ones(4).sum()
    with device_trace("", "cpu") as empty:
        pass
    assert path is None and empty is None and list(tmp_path.iterdir()) == []
