"""The port's whole complexity suite vs the JAX suite on the same DecodedClip.

Tolerance: rel 1e-4 for every metric, except motion at rel 5e-3
(docs/PARITY.md motion row: f32 summation order can flip near-tie argmins).
The clips are a moving random texture, so edge and histogram decisions do
not sit on f32 rounding ties.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rtvqa_tpu.io.video import DecodedClip
from rtvqa_tpu.metrics import complexity as jcx
from rtvqa_tpu_torch.metrics import complexity as tcx

torch.set_num_threads(1)

SUITE_RTOL = 1e-4
MOTION_RTOL = 5e-3


def make_clip(n, h=64, w=96, seed=3, step=(2, -1), dt_ms=333.3):
    rng = np.random.default_rng(seed)
    tex = rng.integers(0, 256, (h + 32, w + 32))
    y = np.stack(
        [np.roll(np.roll(tex, step[0] * i, 0), step[1] * i, 1)[:h, :w] for i in range(n)]
    ).astype(np.uint8)
    u = rng.integers(60, 200, (n, -(-h // 2), -(-w // 2)), np.uint8)
    v = rng.integers(60, 200, (n, -(-h // 2), -(-w // 2)), np.uint8)
    return DecodedClip(
        y=y, u=u, v=v, timestamps_ms=np.arange(n) * dt_ms, width=w, height=h,
        n_frames_total=n, bit_rate=0, avg_fps=1000.0 / dt_ms,
    )


def assert_results_close(got, want):
    for key in tcx.METRIC_ORDER:
        tol = MOTION_RTOL if key == "motion" else SUITE_RTOL
        assert getattr(got, key) == pytest.approx(getattr(want, key), rel=tol, abs=1e-6), key


@pytest.mark.parametrize(
    "n,resize,search",
    [
        (6, (32, 32), "pyramid"),     # padded bucket: 6 real frames of 16
        (17, (32, 32), "pyramid"),    # 17 of 32
        (6, (40, 24), "full"),        # full-resolution search, non-square resize
    ],
)
def test_suite_matches_jax(n, resize, search):
    clip = make_clip(n)
    want = jcx.calculate_average_scene_complexity(
        clip, resize[1], resize[0], motion_impl="xla", motion_search=search
    )
    got = tcx.calculate_average_scene_complexity(
        clip, resize[1], resize[0], motion_search=search, device="cpu"
    )
    assert_results_close(got, want)
    assert got.motion > 0 and got.framerate == pytest.approx(1000.0 / 333.3, rel=1e-4)


def test_static_clip_motion_exactly_zero():
    clip = make_clip(5, step=(0, 0))
    clip = dataclasses.replace(clip, u=np.repeat(clip.u[:1], 5, 0), v=np.repeat(clip.v[:1], 5, 0))
    got = tcx.calculate_average_scene_complexity(clip, 32, 32, device="cpu")
    assert got.motion == 0.0 and got.temporal_dct == 0.0


def test_result_fields_match_jax():
    assert tcx.METRIC_ORDER == jcx.METRIC_ORDER
    assert [f.name for f in dataclasses.fields(tcx.ComplexityResult)] == [
        f.name for f in dataclasses.fields(jcx.ComplexityResult)
    ]
    assert [tcx._pad_bucket(n) for n in (1, 16, 17, 127, 128)] == [
        jcx._pad_bucket(n) for n in (1, 16, 17, 127, 128)
    ]


def test_suite_module_matches_functional_form():
    clip = make_clip(6)
    args = [torch.from_numpy(np.pad(a, [(0, 10)] + [(0, 0)] * (a.ndim - 1)))
            for a in (clip.y, clip.u, clip.v, clip.timestamps_ms.astype(np.float32))]
    suite = tcx.ComplexitySuite(64, 96, 32, 32)
    assert suite.rh.shape == (32, 64) and suite.rw.shape == (32, 96) and suite.dct_h.shape == (32, 32)
    a = suite(*args, 6)
    b = tcx.complexity_suite(*args, 6, resize_h=32, resize_w=32)
    for key in tcx.METRIC_ORDER:
        assert torch.equal(a[key], b[key]), key


def test_kernel_impl_on_cpu_raises():
    clip = make_clip(4)
    with pytest.raises(ValueError, match="CUDA"):
        tcx.calculate_average_scene_complexity(clip, 32, 32, motion_impl="kernel", device="cpu")
    y = torch.zeros((16, 64, 96), dtype=torch.uint8)
    c = torch.zeros((16, 32, 48), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        tcx.complexity_suite(y, c, c, torch.zeros(16), 4, resize_h=32, resize_w=32,
                             motion_impl="kernel")
    with pytest.raises(ValueError, match="motion_impl"):
        tcx.ComplexitySuite(64, 96, 32, 32, motion_impl="pallas")
