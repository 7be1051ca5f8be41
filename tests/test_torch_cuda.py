"""The CUDA kernels vs their plain PyTorch versions on the card.

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is False (the
check runs inside a fixture, never at import). On a machine with a GPU and
nvcc, and without jax, run them alone with:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: gray atol 1e-3 (FMA ULPs; the kernel rounds like the plain
ops, so it is exact in practice); motion rel 5e-3 on smooth frames
(docs/PARITY.md: near-tie argmins), exact on integer-valued frames and 0 on
a static scene.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from rtvqa_tpu_torch.device import get_device

    return get_device("cuda")


def _yuv(rng, n, h, w, dev):
    y = rng.integers(0, 256, (n, h, w), dtype=np.uint8)
    u = rng.integers(0, 256, (n, -(-h // 2), -(-w // 2)), dtype=np.uint8)
    v = rng.integers(0, 256, (n, -(-h // 2), -(-w // 2)), dtype=np.uint8)
    return tuple(torch.from_numpy(a).to(dev) for a in (y, u, v))


@pytest.mark.parametrize("shape", [(64, 96), (67, 131), (1, 1), (1080, 1920)])
def test_gray_kernel_matches_plain(dev, shape):
    from rtvqa_tpu_torch.kernels.gray import yuv420_to_gray_cuda
    from rtvqa_tpu_torch.ops.color import yuv420_to_gray

    y, u, v = _yuv(np.random.default_rng(0), 3, *shape, dev)
    before = yuv420_to_gray_cuda.launches
    got = yuv420_to_gray_cuda(y, u, v)
    torch.cuda.synchronize()
    assert yuv420_to_gray_cuda.launches == before + 1
    torch.testing.assert_close(got, yuv420_to_gray(y, u, v), rtol=0, atol=1e-3)


@pytest.mark.parametrize(
    "shape,block,radius",
    [((540, 960), 8, 4), ((75, 101), 8, 4), ((1080, 1920), 16, 8), ((48, 40), 16, 1)],
)
def test_motion_kernel_matches_plain(dev, shape, block, radius):
    from rtvqa_tpu_torch.kernels.motion import block_match_motion_cuda
    from rtvqa_tpu_torch.ops.motion import block_match_motion

    rng = np.random.default_rng(1)
    tex = torch.from_numpy(rng.integers(0, 256, (3, *shape)).astype(np.float32)).to(dev)
    prev = tex[:2].contiguous()
    curr = torch.roll(prev, shifts=(2, -3), dims=(1, 2)).contiguous()
    before = block_match_motion_cuda.launches
    got = block_match_motion_cuda(prev, curr, block, radius)
    torch.cuda.synchronize()
    assert block_match_motion_cuda.launches == before + 1
    # Integer-valued frames: every SAD is exact in f32, so equal fields.
    assert torch.equal(got, block_match_motion(prev, curr, block, radius))
    assert bool((block_match_motion_cuda(prev, prev, block, radius) == 0).all())

    smooth = torch.nn.functional.avg_pool2d(tex[:, None], 3, 1, 1)[:, 0].contiguous() / 3.0
    got = block_match_motion_cuda(smooth[:-1], smooth[1:], block, radius)
    want = block_match_motion(smooth[:-1], smooth[1:], block, radius)
    torch.testing.assert_close(got, want, rtol=5e-3, atol=0)


def test_suite_kernel_path_matches_plain(dev):
    from rtvqa_tpu.io.video import DecodedClip
    from rtvqa_tpu_torch.metrics.complexity import (
        METRIC_ORDER,
        calculate_average_scene_complexity,
    )

    rng = np.random.default_rng(2)
    n, h, w = 9, 120, 176
    tex = rng.integers(0, 256, (h + 40, w + 40))
    clip = DecodedClip(
        y=np.stack([np.roll(tex, (2 * i, -i), (0, 1))[:h, :w] for i in range(n)]).astype(np.uint8),
        u=rng.integers(60, 200, (n, h // 2, w // 2), np.uint8),
        v=rng.integers(60, 200, (n, h // 2, w // 2), np.uint8),
        timestamps_ms=np.arange(n) * 333.3, width=w, height=h, n_frames_total=n,
        bit_rate=0, avg_fps=3.0,
    )
    k = calculate_average_scene_complexity(clip, 64, 64, device=dev)
    p = calculate_average_scene_complexity(clip, 64, 64, motion_impl="plain", device=dev)
    for key in METRIC_ORDER:
        tol = 5e-3 if key == "motion" else 1e-4
        assert getattr(k, key) == pytest.approx(getattr(p, key), rel=tol, abs=1e-6), key
