"""The port's op helpers of the JAX package's API vs the JAX ops, on the CPU.

Scan, color, histogram, edges, resize, DCT, motion and ORB: the same seeded
numpy inputs through ``rtvqa_tpu.ops`` and ``rtvqa_tpu_torch.ops``.

Tolerances, each with its reason:
* exact — tables and patterns built by the same numpy code, counts and
  argmins on integer-valued inputs, and ops that round nothing differently
  (the pairwise pyramid against the series form; the sampled resize against
  the dense one, as the JAX docstring promises); the two-level pyramid on a
  static scene;
* rel 5e-3 — the two-level pyramid elsewhere: the pyramid motion tolerance
  of ROADMAP.md queue C (summation order in the pooling can flip a near-tie
  argmin);
* rel 1e-6 — the linear recurrences: JAX composes them in an associative
  scan, the port in a doubling scan, so sums associate differently;
* atol 1e-3 — RGB planes (FMA contraction ULPs at values <= 255, as
  tests/test_torch_ops.py holds them);
* rel 1e-5 — f32 reductions and matmuls summed in another order; DCT
  coefficients also atol 2e-3 (they pass near 0); the two-level pyramid on
  a shift that lands on the quarter-resolution grid, whose displacement
  fields are equal: the JAX mean sums f32 in XLA's order (3 ULPs above
  the float64 mean there), the port's in float64, and one block's vector
  differing would move the mean by ~1e-3;
* ORB on integer-valued frames: ``ys``, ``xs``, ``valid`` and
  ``fast_score`` exact, ``score`` rel 1e-5, ``angle`` abs 1e-5 (``atan2``
  of exact moments, last bits differ between XLA and torch), ``desc``
  exact: 0 differing bits on these frames (a rotated pattern offset within
  an ULP of .5 could flip a bit; none of these does).
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from rtvqa_tpu.ops import color as jcolor
from rtvqa_tpu.ops import dct as jdct
from rtvqa_tpu.ops import edges as jedges
from rtvqa_tpu.ops import histogram as jhist
from rtvqa_tpu.ops import motion as jmotion
from rtvqa_tpu.ops import orb as jorb
from rtvqa_tpu.ops import resize as jresize
from rtvqa_tpu.ops import scan as jscan
from rtvqa_tpu_torch.ops import color as tcolor
from rtvqa_tpu_torch.ops import dct as tdct
from rtvqa_tpu_torch.ops import edges as tedges
from rtvqa_tpu_torch.ops import histogram as thist
from rtvqa_tpu_torch.ops import motion as tmotion
from rtvqa_tpu_torch.ops import orb as torb
from rtvqa_tpu_torch.ops import resize as tresize
from rtvqa_tpu_torch.ops import scan as tscan

torch.set_num_threads(1)

SCAN_RTOL = 1e-6
RGB_ATOL = 1e-3
F32_RTOL = 1e-5
ANGLE_ATOL = 1e-5
DESC_BITS = 0


def _t(a):
    return torch.from_numpy(np.array(a))


def _yuv(rng, n, h, w):
    y = rng.integers(0, 256, (n, h, w), dtype=np.uint8)
    u = rng.integers(0, 256, (n, -(-h // 2), -(-w // 2)), dtype=np.uint8)
    v = rng.integers(0, 256, (n, -(-h // 2), -(-w // 2)), dtype=np.uint8)
    return y, u, v


def _texture_frames(rng, n, h, w, step=(2, -1)):
    """Integer-valued texture moving by ``step`` px per frame."""
    tex = rng.integers(0, 256, (h + 16, w + 16))
    return np.stack(
        [np.roll(np.roll(tex, step[0] * i, 0), step[1] * i, 1)[:h, :w] for i in range(n)]
    ).astype(np.float32)


def _corner_frames(rng, b, h, w):
    """Integer-valued gradients with random flat squares: FAST corners whose
    moments and Harris sums are exact in f32."""
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(b):
        img = ((yy * 0.37 + xx * 0.23) * (1 + i)) % 256
        for _ in range(12):
            cy, cx, s = rng.integers(8, h - 8), rng.integers(8, w - 8), rng.integers(3, 7)
            img[cy - s:cy + s, cx - s:cx + s] = rng.integers(0, 256)
        out.append(np.floor(img + rng.integers(0, 3, img.shape)))
    return np.stack(out).astype(np.float32)


# --- scan ---------------------------------------------------------------------


@pytest.mark.parametrize("n,alpha", [(1, 0.5), (7, 0.3), (128, 0.8), (300, 0.8)])
def test_linear_recurrence_and_ewm_match_jax(rng, n, alpha):
    # n = 300 at alpha 0.8 is past where 0.2**t leaves f32 (t ~ 55).
    x = rng.uniform(0, 100, (n, 3)).astype(np.float32)
    decay = np.full_like(x, 1.0 - alpha)
    want = np.asarray(jscan.linear_recurrence(jnp.asarray(decay), jnp.asarray(x)))
    got = tscan.linear_recurrence(_t(decay), _t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=SCAN_RTOL)
    want = np.asarray(jscan.ewm_mean(jnp.asarray(x), alpha))
    got = tscan.ewm_mean(_t(x), alpha).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=SCAN_RTOL)
    np.testing.assert_allclose(got[:, 0], pd.Series(x[:, 0]).ewm(alpha=alpha).mean(), rtol=F32_RTOL)


def test_ewm_mean_axis_matches_jax(rng):
    x = rng.normal(size=(5, 40)).astype(np.float32)
    want = np.asarray(jscan.ewm_mean(jnp.asarray(x), 0.8, axis=1))
    got = tscan.ewm_mean(_t(x), 0.8, axis=1).numpy()
    np.testing.assert_allclose(got, want, rtol=SCAN_RTOL, atol=1e-6)


# --- color, histogram, edges ----------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 96), (67, 131)])
def test_yuv420_to_rgb_matches_jax(rng, shape):
    y, u, v = _yuv(rng, 2, *shape)
    want = np.asarray(jcolor.yuv420_to_rgb(y, u, v))
    got = tcolor.yuv420_to_rgb(_t(y), _t(u), _t(v)).numpy()
    assert got.shape == want.shape == (2, *shape, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=RGB_ATOL)


def test_upsample_chroma_matches_jax(rng):
    c = rng.integers(0, 256, (2, 33, 48), dtype=np.uint8)
    want = np.asarray(jcolor.upsample_chroma(c))
    got = tcolor.upsample_chroma(_t(c)).numpy()
    assert got.shape == (2, 66, 96)
    np.testing.assert_array_equal(got, want)


def test_color_entropy_matches_jax(rng):
    rgb = rng.integers(0, 256, (3, 48, 64, 3)).astype(np.float32)
    rgb[1, :, :32] = 17.0  # one frame with a flat half: other bin counts
    want = np.asarray(jhist.color_entropy(jnp.asarray(rgb)))
    got = thist.color_entropy(_t(rgb)).numpy()
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=F32_RTOL)


@pytest.mark.parametrize("threshold", [200.0, 50.0])
def test_sobel_edge_density_matches_jax(rng, threshold):
    gray = rng.integers(0, 256, (3, 40, 56)).astype(np.float32)
    gray[0] = 10.0  # a flat frame counts 0
    want = np.asarray(jedges.sobel_edge_density(jnp.asarray(gray), threshold))
    got = tedges.sobel_edge_density(_t(gray), threshold).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0.0


# --- resize, DCT -----------------------------------------------------------------


@pytest.mark.parametrize(
    "shape,out", [((64, 96), (32, 32)), ((67, 131), (24, 40)), ((72, 128), (72, 64)), ((45, 70), (90, 35))]
)
def test_resize_bilinear_sampled(rng, shape, out):
    x = rng.uniform(0, 255, (3, *shape)).astype(np.float32)
    got = tresize.resize_bilinear_sampled(_t(x), *out)
    assert torch.equal(got, tresize.resize_bilinear(_t(x), *out))
    want = np.asarray(jresize.resize_bilinear_sampled(jnp.asarray(x), *out))
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_RTOL)


def test_resize_bilinear_sampled_takes_integers(rng):
    x = rng.integers(0, 256, (2, 40, 48), dtype=np.uint8)
    got = tresize.resize_bilinear_sampled(_t(x), 16, 24)
    assert got.dtype == torch.float32
    assert torch.equal(got, tresize.resize_bilinear(_t(x).float(), 16, 24))


def test_blockwise_dct8x8_matches_jax(rng):
    x = rng.uniform(0, 255, (2, 3, 32, 48)).astype(np.float32)
    want = np.asarray(jdct.blockwise_dct8x8(jnp.asarray(x)))
    got = tdct.blockwise_dct8x8(_t(x)).numpy()
    assert got.shape == (2, 3, 4, 6, 8, 8)
    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=2e-3)
    # Tile (i, j) is the 2-D DCT of x's block (i, j).
    np.testing.assert_allclose(
        got[1, 2, 3, 5], tdct.dct2(_t(x[1, 2, 24:32, 40:48])).numpy(), rtol=F32_RTOL, atol=2e-3
    )


@pytest.mark.parametrize("shape", [(30, 48), (32, 44)])
def test_blockwise_dct8x8_rejects_unaligned(shape):
    with pytest.raises(ValueError, match="multiples of 8"):
        tdct.blockwise_dct8x8(torch.zeros(shape))


# --- motion -----------------------------------------------------------------------


@pytest.mark.parametrize("shape,block,radius", [((48, 64), 16, 8), ((45, 70), 8, 4)])
def test_block_match_field_matches_jax(rng, shape, block, radius):
    g = _texture_frames(rng, 3, *shape)
    jdy, jdx = jmotion.block_match_field(jnp.asarray(g[:-1]), jnp.asarray(g[1:]), block, radius)
    tdy, tdx = tmotion.block_match_field(_t(g[:-1]), _t(g[1:]), block, radius)
    assert tdy.dtype == torch.float32 and tdy.shape == (2, shape[0] // block, shape[1] // block)
    np.testing.assert_array_equal(tdy.numpy(), np.asarray(jdy))
    np.testing.assert_array_equal(tdx.numpy(), np.asarray(jdx))


@pytest.mark.parametrize("shape,block,radius", [((64, 96), 16, 8), ((45, 70), 8, 4)])
def test_block_match_motion_pyramid_matches_jax(rng, shape, block, radius):
    g = _texture_frames(rng, 5, *shape, step=(2, -4))
    want = np.asarray(jmotion.block_match_motion_pyramid(jnp.asarray(g[:-1]), jnp.asarray(g[1:]), block, radius))
    got = tmotion.block_match_motion_pyramid(_t(g[:-1]), _t(g[1:]), block, radius)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_RTOL)
    # The pooling is per frame: the series form gives the same values.
    assert torch.equal(got, tmotion.block_match_motion_pyramid_series(_t(g), block, radius))


def test_block_match_motion_pyramid_leading_dims(rng):
    g = _texture_frames(rng, 7, 48, 64)
    prev = _t(g[:6]).reshape(2, 3, 48, 64)
    curr = _t(g[1:]).reshape(2, 3, 48, 64)
    got = tmotion.block_match_motion_pyramid(prev, curr)
    assert got.shape == (2, 3)
    assert torch.equal(got.reshape(-1), tmotion.block_match_motion_pyramid(_t(g[:6]), _t(g[1:])))
    one = tmotion.block_match_motion_pyramid(_t(g[0]), _t(g[1]))
    assert one.shape == () and float(one) == float(got[0, 0])


PYRAMID_RTOL = 5e-3


def _pyramid2(series):
    """(port, JAX) two-level pyramid motion of one f32 series."""
    got = tmotion.block_match_motion_pyramid2_series(_t(series)).numpy()
    return got, np.asarray(jmotion.block_match_motion_pyramid2_series(jnp.asarray(series)))


def test_pyramid2_static_scene(rng):
    f = rng.integers(0, 256, (1, 96, 128)).astype(np.float32)
    got, want = _pyramid2(np.repeat(f, 3, axis=0))
    assert got.dtype == np.float32 and got.shape == (2,)
    np.testing.assert_array_equal(got, 0.0)
    np.testing.assert_array_equal(got, want)


def test_pyramid2_recovers_multiple_of_4_shift(rng):
    """A multiple-of-4 shift lands on the quarter-resolution grid; the
    half-resolution refinement adds 0."""
    base = rng.integers(0, 256, (96, 128)).astype(np.float32)
    curr = np.roll(np.roll(base, 4, axis=0), 8, axis=1)
    got, want = _pyramid2(np.stack([base, curr]))
    assert float(got[0]) == pytest.approx(np.hypot(4, 8), rel=0.35)  # borders dilute
    np.testing.assert_allclose(got, want, rtol=F32_RTOL)


def test_pyramid2_documented_failure_mode(rng):
    """Why the two-level pyramid is no default: a 2-pixel shift is one
    half-resolution pixel, which the single-level pyramid finds exactly,
    but half a quarter-resolution pixel, where the coarse search guesses;
    the port drifts from the truth as the JAX function does."""
    yy, xx = np.mgrid[0:96, 0:128].astype(np.float32)
    smooth = (120 + 60 * np.sin(2 * np.pi * xx / 40.0)
              + 40 * np.cos(2 * np.pi * (xx + yy) / 56.0)).astype(np.float32)
    texture = rng.integers(0, 256, (96, 128)).astype(np.float32)
    for base in (smooth, texture):
        curr = np.roll(base, 2, axis=1)
        one_level = float(tmotion.block_match_motion_pyramid(_t(base[None]), _t(curr[None]))[0])
        assert one_level == pytest.approx(2.0, rel=1e-6)
        got, want = _pyramid2(np.stack([base, curr]))
        assert abs(float(got[0]) - 2.0) > 0.5
        np.testing.assert_allclose(got, want, rtol=PYRAMID_RTOL)


@pytest.mark.parametrize("shape,block,radius", [((96, 128), 16, 8), ((70, 90), 8, 4)])
def test_pyramid2_matches_jax(rng, shape, block, radius):
    g = _texture_frames(rng, 4, *shape, step=(3, -5))
    got = tmotion.block_match_motion_pyramid2_series(_t(g), block, radius)
    want = np.asarray(jmotion.block_match_motion_pyramid2_series(jnp.asarray(g), block, radius))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=PYRAMID_RTOL)


# --- ORB ------------------------------------------------------------------------------


def test_brief_pattern_equals_jax():
    for n_bits in (256, 128):
        np.testing.assert_array_equal(torb._brief_pattern(n_bits), jorb._brief_pattern(n_bits))


def test_harris_response_matches_jax(rng):
    g = _corner_frames(rng, 2, 48, 64)
    want = np.asarray(jorb.harris_response(jnp.asarray(g)))
    got = torb.harris_response(_t(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=F32_RTOL * np.abs(want).max())


def _check_orb(got, want):
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    assert set(got) == set(want)
    for key in ("ys", "xs", "valid", "fast_score"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["score"], want["score"], rtol=F32_RTOL)
    np.testing.assert_allclose(got["angle"], want["angle"], atol=ANGLE_ATOL)
    assert int((got["desc"] != want["desc"]).sum()) <= DESC_BITS
    return got


@pytest.mark.parametrize("k", [64, 8])
def test_orb_features_match_jax(rng, k):
    """k = 64 leaves slots past the corner count (their -inf ranks tie:
    the lower flat index first, as jax.lax.top_k orders them); k = 8 caps
    the count."""
    g = _corner_frames(rng, 3, 72, 128)
    got = _check_orb(torb.orb_features(_t(g), k=k, edge_threshold=8),
                     jorb.orb_features(jnp.asarray(g), k=k, edge_threshold=8))
    n_valid = got["valid"].sum(axis=1)
    assert (n_valid < 64).all() if k == 64 else (n_valid == k).all()
    assert not got["desc"][~got["valid"]].any()


def test_orb_features_random_and_flat_frames(rng):
    g = rng.integers(0, 256, (2, 64, 96)).astype(np.float32)
    g[1] = 40.0  # no corner: every slot invalid, indices 0..K-1 in order
    got = _check_orb(torb.orb_features(_t(g), k=32, edge_threshold=8),
                     jorb.orb_features(jnp.asarray(g), k=32, edge_threshold=8))
    assert not got["valid"][1].any()
    np.testing.assert_array_equal(got["xs"][1], np.arange(32))
