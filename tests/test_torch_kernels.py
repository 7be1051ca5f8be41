"""The CUDA kernels' plain versions vs the Pallas kernels they replace.

The Pallas kernels run in interpret mode on the CPU, as in
tests/test_pallas_kernels.py. On a CPU tensor each CUDA wrapper takes its
plain version; on any other device that is not CUDA it raises, and it never
falls back. Tolerances: gray atol 1e-3 (the JAX package's own kernel-vs-XLA
bound, FMA ULPs); motion rtol 1e-5 on texture frames without near-tie SADs
(the Pallas kernel sums its block means in f32, the port in float64); the
wrappers on CPU tensors are the plain functions, so exact.
"""

import numpy as np
import pytest
import torch

from rtvqa_tpu.kernels.gray_pallas import yuv420_to_gray_pallas
from rtvqa_tpu.kernels.motion_pallas import block_match_motion_pallas
from rtvqa_tpu_torch.kernels import _build
from rtvqa_tpu_torch.kernels.gray import yuv420_to_gray_cuda
from rtvqa_tpu_torch.kernels.motion import block_match_motion_cuda
from rtvqa_tpu_torch.ops.color import yuv420_to_gray
from rtvqa_tpu_torch.ops.motion import block_match_motion

torch.set_num_threads(1)


def _yuv(rng, n, h, w):
    y = rng.integers(0, 256, (n, h, w), dtype=np.uint8)
    u = rng.integers(0, 256, (n, -(-h // 2), -(-w // 2)), dtype=np.uint8)
    v = rng.integers(0, 256, (n, -(-h // 2), -(-w // 2)), dtype=np.uint8)
    return y, u, v


def _shifted_pairs(rng, n, h, w, dy, dx):
    prev = rng.integers(0, 256, (n, h, w)).astype(np.float32)
    curr = np.roll(np.roll(prev, dy, 1), dx, 2)
    return prev, curr


@pytest.mark.parametrize("shape", [(64, 96), (67, 131), (128, 257)])
def test_gray_plain_matches_pallas(rng, shape):
    # (67, 131): odd H and W — the CUDA kernel takes them without padding.
    y, u, v = _yuv(rng, 2, *shape)
    want = np.asarray(yuv420_to_gray_pallas(y, u, v, interpret=True))
    got = yuv420_to_gray(*(torch.from_numpy(a) for a in (y, u, v))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_gray_wrapper_on_cpu_is_plain(rng):
    y, u, v = (torch.from_numpy(a) for a in _yuv(rng, 2, 33, 45))
    before = yuv420_to_gray_cuda.launches
    assert torch.equal(yuv420_to_gray_cuda(y, u, v), yuv420_to_gray(y, u, v))
    assert yuv420_to_gray_cuda.launches == before


@pytest.mark.parametrize(
    "shape,block,radius,shift",
    [
        ((64, 96), 8, 4, (2, -3)),
        ((75, 101), 8, 4, (-1, 2)),    # odd dims, ragged last block-row and column
        ((48, 64), 16, 8, (3, 5)),
        ((150, 128), 8, 4, (2, -1)),   # 18 block-rows: the Pallas grid's ragged strip
    ],
)
def test_block_match_plain_matches_pallas(rng, shape, block, radius, shift):
    prev, curr = _shifted_pairs(rng, 2, *shape, *shift)
    want = np.asarray(
        block_match_motion_pallas(prev, curr, block=block, radius=radius, interpret=True)
    )
    got = block_match_motion(torch.from_numpy(prev), torch.from_numpy(curr), block, radius).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_block_match_wrapper_on_cpu_is_plain(rng):
    prev, curr = (torch.from_numpy(a) for a in _shifted_pairs(rng, 2, 40, 56, 1, 2))
    before = block_match_motion_cuda.launches
    assert torch.equal(block_match_motion_cuda(prev, curr, 8, 4), block_match_motion(prev, curr, 8, 4))
    assert block_match_motion_cuda.launches == before


def test_plain_index_field_matches_the_kernel_digest():
    """On the card tests' smoothed, non-integer pairs the plain version
    picks, for every block, the candidate the CUDA kernel picks: its index
    fields hash to MOTION_INDEX_DIGEST, which tests/test_torch_cuda.py holds
    the kernel to."""
    import importlib.util
    from pathlib import Path

    from rtvqa_tpu_torch.ops.motion import block_match_index

    spec = importlib.util.spec_from_file_location(
        "torch_cuda_tests", Path(__file__).with_name("test_torch_cuda.py"))
    cuda_tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cuda_tests)
    digest = cuda_tests.motion_index_digest(
        lambda p, c, block, radius: block_match_index(p, c, block, radius).to(torch.int32), torch.device("cpu"))
    assert digest == cuda_tests.MOTION_INDEX_DIGEST


def test_wrappers_refuse_non_cuda_devices():
    # A tensor that is neither on the CPU nor on a card takes the kernel
    # route, which checks the device and raises instead of falling back.
    y = torch.empty((1, 8, 8), dtype=torch.uint8, device="meta")
    c = torch.empty((1, 4, 4), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        yuv420_to_gray_cuda(y, c, c)
    g = torch.empty((1, 16, 16), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        block_match_motion_cuda(g, g, 8, 4)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    # No nvcc anywhere: build() and load_library() must raise a clear error
    # rather than hand back the plain path.
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "_NVCC_CANDIDATES", ())
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    assert _build.find_nvcc() is None
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build()
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.load_library()


def test_library_name_tracks_sources():
    # The build is keyed by the sources' hash, so an edited .cu never loads
    # a stale library; every kernel source is compiled into it.
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR and path.name.startswith("librtvqa_kernels_")
    assert {p.name for p in _build._sources()} >= {"gray.cu", "motion.cu"}
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
