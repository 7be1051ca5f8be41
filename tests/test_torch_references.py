"""The port's float64 NumPy references against the JAX package's, on the CPU.

``yuv420_to_gray_np``, ``resize_bilinear_np``, ``dct2_np``,
``filter1d_sep_np``, ``filter1d_sep_axis_np`` and ``vif_features_np``: the
same seeded numpy inputs through ``rtvqa_tpu`` and ``rtvqa_tpu_torch``.
Each copy keeps the JAX function's tables, its einsum strings and its
arithmetic order in numpy float64, so every comparison is
``assert_array_equal`` (no einsum is reordered).

Then the port's plain f32 versions against those references:
``vif_features`` at rtol 3e-4 (the VIF reference tolerance of ROADMAP.md,
queue C; what ``chip_smoke.py`` holds kernels 3, 4 and 5 to on the card),
and ``yuv420_to_gray`` at atol 1e-4 (f32 rounding of values <= 255: a few
ULPs of 1.5e-5 each; ``chip_smoke.py`` holds kernel 1 to the same).
"""

import numpy as np
import pytest
import torch

from rtvqa_tpu.ops import color as jcolor
from rtvqa_tpu.ops import dct as jdct
from rtvqa_tpu.ops import resize as jresize
from rtvqa_tpu.vmaf import filters as jfilters
from rtvqa_tpu.vmaf import vif as jvif
from rtvqa_tpu_torch.ops import color as tcolor
from rtvqa_tpu_torch.ops import dct as tdct
from rtvqa_tpu_torch.ops import resize as tresize
from rtvqa_tpu_torch.vmaf import filters as tfilters
from rtvqa_tpu_torch.vmaf import vif as tvif

torch.set_num_threads(1)

VIF_RTOL = 3e-4
GRAY_ATOL = 1e-4


def luma_pair(h, w, seed):
    """A gradient + noise luma frame (the bench's recipe) and a copy with
    uniform integer noise in [-4, 4]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    ref = np.clip((xx * 3 + yy * 2) % 256 + rng.integers(0, 8, (h, w)), 0, 255).astype(np.uint8)
    dis = np.clip(ref.astype(np.int16) + rng.integers(-4, 5, (h, w)), 0, 255).astype(np.uint8)
    return ref, dis


def yuv(h, w, seed):
    rng = np.random.default_rng(seed)
    hc, wc = (h + 1) // 2, (w + 1) // 2
    return (rng.integers(0, 256, (2, h, w), np.uint8), rng.integers(0, 256, (2, hc, wc), np.uint8),
            rng.integers(0, 256, (2, hc, wc), np.uint8))


@pytest.mark.parametrize("h,w", [(36, 52), (72, 96)])
def test_vif_features_np_equals_jax(h, w):
    ref, dis = luma_pair(h, w, seed=h)
    assert tvif.vif_features_np(ref, dis) == jvif.vif_features_np(ref, dis)


@pytest.mark.parametrize("taps_n", [9, 17])
@pytest.mark.parametrize("mode", ["reflect", "edge"])
@pytest.mark.parametrize("axis", [None, -1, -2])
def test_filter1d_sep_np_equals_jax(taps_n, mode, axis):
    """Both directions at once (``axis`` None) and each axis alone, on a
    (2, 23, 31) stack: more rows and columns than either window."""
    x = np.random.default_rng(taps_n).normal(size=(2, 23, 31)) * 50.0
    taps = tfilters.gaussian_kernel(taps_n, taps_n / 5.0)
    np.testing.assert_array_equal(taps, jfilters.gaussian_kernel(taps_n, taps_n / 5.0))
    if axis is None:
        got = tfilters.filter1d_sep_np(x, taps, mode)
        want = jfilters.filter1d_sep_np(x, taps, mode)
    else:
        got = tfilters.filter1d_sep_axis_np(x, taps, axis, mode)
        want = jfilters.filter1d_sep_axis_np(x, taps, axis, mode)
    np.testing.assert_array_equal(got, want)


def test_conv_matrix_refuses_unknown_modes():
    with pytest.raises(ValueError):
        tfilters._conv_matrix(8, (0.25, 0.5, 0.25), "wrap")


@pytest.mark.parametrize("shape", [(5, 8, 8), (16, 24)])
def test_dct2_np_equals_jax(shape):
    """A stack of 8x8 blocks and a 16x24 frame."""
    x = np.random.default_rng(len(shape)).integers(0, 256, shape).astype(np.float32)
    np.testing.assert_array_equal(tdct.dct2_np(x), jdct.dct2_np(x))


@pytest.mark.parametrize("src,out", [((30, 40), (64, 72)), ((60, 80), (17, 23)), ((33, 20), (16, 41))])
def test_resize_bilinear_np_equals_jax(src, out):
    """Up in both axes, down in both, and down in one while up in the other."""
    x = np.random.default_rng(src[0]).integers(0, 256, (2, *src)).astype(np.uint8)
    np.testing.assert_array_equal(tresize.resize_bilinear_np(x, *out), jresize.resize_bilinear_np(x, *out))


@pytest.mark.parametrize("h,w", [(6, 8), (7, 9)])
def test_yuv420_to_gray_np_equals_jax(h, w):
    """Even and odd sizes (odd: the last chroma row and column cover one
    luma row or column)."""
    planes = yuv(h, w, seed=h)
    np.testing.assert_array_equal(tcolor.yuv420_to_gray_np(*planes), jcolor.yuv420_to_gray_np(*planes))


def test_plain_vif_features_match_the_float64_reference():
    """The port's f32 ``vif_features`` at 72x96 against its own
    ``vif_features_np``, per frame, every scale."""
    pairs = [luma_pair(72, 96, seed) for seed in range(3)]
    ref = torch.from_numpy(np.stack([p[0] for p in pairs]))
    dis = torch.from_numpy(np.stack([p[1] for p in pairs]))
    got = tvif.vif_features(ref, dis)
    for i, (r, d) in enumerate(pairs):
        want = tvif.vif_features_np(r, d)
        for key, value in want.items():
            assert float(got[key][i]) == pytest.approx(value, rel=VIF_RTOL), (i, key)


@pytest.mark.parametrize("h,w", [(6, 8), (7, 9), (36, 52)])
def test_plain_gray_matches_the_float64_reference(h, w):
    planes = yuv(h, w, seed=w)
    got = tcolor.yuv420_to_gray(*(torch.from_numpy(a) for a in planes)).double().numpy()
    np.testing.assert_allclose(got, tcolor.yuv420_to_gray_np(*planes), rtol=0, atol=GRAY_ATOL)
