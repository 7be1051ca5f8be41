"""The port's plain-PyTorch ops vs the JAX ops on the same numpy inputs.

Tolerances, each with its reason:
* exact — tables built by the same numpy code, counts on integer-valued
  inputs, min/max/compare-only ops, and ops that round nothing differently;
* atol 1e-3 — gray / RGB planes (the JAX package's own kernel-vs-XLA bound,
  tests/test_pallas_kernels.py:96: FMA contraction ULPs at values <= 255);
* rtol 1e-5 — f32 reductions and matmuls summed in another order.
"""

import jax.numpy as jnp
import numpy as np
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

GRAY_ATOL = 1e-3
F32_RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _yuv(rng, n, h, w):
    y = rng.integers(0, 256, (n, h, w), dtype=np.uint8)
    u = rng.integers(0, 256, (n, -(-h // 2), -(-w // 2)), dtype=np.uint8)
    v = rng.integers(0, 256, (n, -(-h // 2), -(-w // 2)), dtype=np.uint8)
    return y, u, v


def _texture_frames(rng, n, h, w, step=(2, -1)):
    """Integer-valued random texture moving by ``step`` px per frame — no
    near-tie SADs or edge decisions, so results do not hinge on f32 order."""
    tex = rng.integers(0, 256, (h + 16, w + 16))
    return np.stack(
        [np.roll(np.roll(tex, step[0] * i, 0), step[1] * i, 1)[:h, :w] for i in range(n)]
    ).astype(np.float32)


# --- color -------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 96), (67, 131)])
def test_yuv420_to_gray_matches_jax(rng, shape):
    y, u, v = _yuv(rng, 3, *shape)
    want = np.asarray(jcolor.yuv420_to_gray(y, u, v))
    got = tcolor.yuv420_to_gray(_t(y), _t(u), _t(v)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=GRAY_ATOL)


def test_yuv420_to_rgb_planes_matches_jax(rng):
    y, u, v = _yuv(rng, 2, 65, 97)
    for got, want in zip(
        tcolor.yuv420_to_rgb_planes(_t(y), _t(u), _t(v)), jcolor.yuv420_to_rgb_planes(y, u, v)
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=GRAY_ATOL)
        assert float(got.min()) >= 0.0 and float(got.max()) <= 255.0


def test_yuv_rows_to_rgb_planes_matches_jax(rng):
    y, u, v = _yuv(rng, 2, 16, 33)
    y = y[:, :8]  # any 8 luma rows against any 8 chroma rows
    got = tcolor.yuv_rows_to_rgb_planes(_t(y), _t(u), _t(v))
    want = jcolor.yuv_rows_to_rgb_planes(y, u, v)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAY_ATOL)


# --- resize and DCT tables ----------------------------------------------------


@pytest.mark.parametrize("dst,src", [(32, 64), (32, 96), (64, 1080), (53, 64), (40, 17)])
def test_bilinear_tables_bitwise_equal(dst, src):
    np.testing.assert_array_equal(
        tresize._bilinear_matrix(dst, src), jresize._bilinear_matrix(dst, src)
    )
    t_idx, t_mat = tresize.bilinear_sample_plan(dst, src)
    j_idx, j_mat = jresize.bilinear_sample_plan(dst, src)
    np.testing.assert_array_equal(t_idx, j_idx)
    np.testing.assert_array_equal(t_mat, j_mat)


@pytest.mark.parametrize("n", [8, 32, 64])
def test_dct_matrix_bitwise_equal(n):
    np.testing.assert_array_equal(tdct.dct_matrix(n), jdct.dct_matrix(n))


@pytest.mark.parametrize("out", [(32, 32), (64, 64), (40, 24)])
def test_resize_bilinear_matches_jax(rng, out):
    x = rng.uniform(0, 255, (3, 64, 96)).astype(np.float32)
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(x), *out))
    got = tresize.resize_bilinear(_t(x), *out).numpy()
    np.testing.assert_allclose(got, want, rtol=F32_RTOL)


# --- scan ---------------------------------------------------------------------


def _ewm_loop(x, alpha, valid):
    """Sequential pandas adjust=True EWM over the valid slots, float64."""
    out = np.zeros(len(x))
    num = den = 0.0
    for t, (xv, ok) in enumerate(zip(x, valid)):
        if ok:
            num = (1 - alpha) * num + xv
            den = (1 - alpha) * den + 1.0
            out[t] = num / den
    return out


@pytest.mark.parametrize("n,n_valid,alpha", [(16, 6, 0.8), (128, 128, 0.8), (32, 17, 0.3)])
def test_ewm_mean_masked_matches_jax(rng, n, n_valid, alpha):
    # n=128 at alpha 0.8 is the f32 cumulative-product underflow trap
    # (0.2**128 ~ 3e-90): the port's float64 closed form must still hold.
    x = rng.uniform(0, 100, n).astype(np.float32)
    valid = np.arange(n) < n_valid
    js, jv = jscan.ewm_mean_masked(jnp.asarray(x), alpha, jnp.asarray(valid))
    ts, tv = tscan.ewm_mean_masked(_t(x), alpha, _t(valid))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=F32_RTOL)
    np.testing.assert_allclose(ts.numpy(), _ewm_loop(x, alpha, valid), rtol=F32_RTOL)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    want_mean = float(jscan.masked_mean(js, jv))
    assert float(tscan.masked_mean(ts, tv)) == pytest.approx(want_mean, rel=F32_RTOL)


def test_masked_mean_empty_is_zero():
    x = torch.ones(8)
    assert float(tscan.masked_mean(x, torch.zeros(8, dtype=torch.bool))) == 0.0
    sm, _ = tscan.ewm_mean_masked(x, 0.8, torch.zeros(8, dtype=torch.bool))
    assert float(sm.abs().sum()) == 0.0


# --- DCT ----------------------------------------------------------------------


def test_dct_ops_match_jax(rng):
    a = rng.uniform(0, 255, (4, 32, 32)).astype(np.float32)
    b = rng.uniform(0, 255, (4, 32, 32)).astype(np.float32)
    # Coefficients pass near 0, where only an absolute bound is meaningful:
    # f32 sums of 1024 terms of size ~255 carry ~1e-3 of rounding.
    np.testing.assert_allclose(
        tdct.dct2(_t(a)).numpy(), np.asarray(jdct.dct2(jnp.asarray(a))), rtol=F32_RTOL, atol=2e-3
    )
    np.testing.assert_allclose(
        tdct.dct_energy(_t(a)).numpy(), np.asarray(jdct.dct_energy(jnp.asarray(a))), rtol=F32_RTOL
    )
    np.testing.assert_allclose(
        tdct.temporal_dct_abs_diff(_t(a), _t(b)).numpy(),
        np.asarray(jdct.temporal_dct_abs_diff(jnp.asarray(a), jnp.asarray(b))),
        rtol=F32_RTOL,
    )


# --- histogram ----------------------------------------------------------------


def test_histogram_counts_exact(rng):
    # Integer-valued and half-integer inputs: counts are exact, and the
    # half-to-even rounding must agree with jnp.round.
    x = rng.integers(-3, 260, (3, 32, 32)).astype(np.float32)
    x[0, :4] += 0.5
    np.testing.assert_array_equal(
        thist.histogram_256(_t(x)).numpy(), np.asarray(jhist.histogram_256(jnp.asarray(x)))
    )


def test_gray_entropy_matches_jax(rng):
    x = rng.uniform(0, 255, (4, 32, 32)).astype(np.float32)
    x[1] = 7.0  # one-level frame: entropy 0 via the masked form
    np.testing.assert_allclose(
        thist.gray_entropy(_t(x)).numpy(), np.asarray(jhist.gray_entropy(jnp.asarray(x))),
        rtol=F32_RTOL, atol=1e-6,
    )


@pytest.mark.parametrize("shape,out", [((64, 96), (32, 32)), ((67, 131), (24, 40))])
def test_color_entropy_sampled_matches_jax(rng, shape, out):
    y, u, v = _yuv(rng, 3, *shape)
    want = np.asarray(jhist.color_entropy_sampled(y, u, v, *out))
    got = thist.color_entropy_sampled(_t(y), _t(u), _t(v), *out).numpy()
    np.testing.assert_allclose(got, want, rtol=F32_RTOL)


# --- edges --------------------------------------------------------------------


def test_sobel_and_canny_match_jax(rng):
    g = rng.integers(0, 256, (3, 32, 32)).astype(np.float32)
    for got, want in zip(tedges.sobel_gradients(_t(g)), jedges.sobel_gradients(jnp.asarray(g))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Integer-valued input: gradients are exact, so the edge maps are equal.
    np.testing.assert_array_equal(
        tedges.canny_edges(_t(g)).numpy(), np.asarray(jedges.canny_edges(jnp.asarray(g)))
    )


def test_canny_hysteresis_long_chain():
    # A weak ridge fed by one strong pixel: hysteresis must walk the whole
    # chain to its fixed point (many dilation rounds), as the JAX loop does.
    g = np.zeros((1, 24, 64), np.float32)
    g[0, 12, :] = 60.0
    g[0, 12, 5] = 200.0
    got = tedges.canny_edge_count(_t(g)).numpy()
    want = np.asarray(jedges.canny_edge_count(jnp.asarray(g)))
    np.testing.assert_array_equal(got, want)
    assert got[0] > 50


# --- ORB ----------------------------------------------------------------------


def test_fast_score_and_nms_match_jax(rng):
    g = rng.integers(0, 256, (2, 40, 48)).astype(np.float32)
    np.testing.assert_array_equal(
        torb.fast_score(_t(g)).numpy(), np.asarray(jorb.fast_score(jnp.asarray(g)))
    )
    np.testing.assert_array_equal(
        torb.fast_keypoint_map(_t(g), edge_threshold=5).numpy(),
        np.asarray(jorb.fast_keypoint_map(jnp.asarray(g), edge_threshold=5)),
    )


@pytest.mark.parametrize("size", [64, 160])
def test_orb_keypoint_count_matches_jax(rng, size):
    # 64x64 is the suite's input (only pyramid level 0 has an interior);
    # 160x160 exercises the resized pyramid levels too.
    g = rng.integers(0, 256, (2, size, size)).astype(np.float32)
    got = torb.orb_keypoint_count(_t(g)).numpy()
    want = np.asarray(jorb.orb_keypoint_count(jnp.asarray(g)))
    np.testing.assert_allclose(got, want, rtol=F32_RTOL)
    assert torb.pyramid_shapes(size, size, 8, 1.2) == jorb.pyramid_shapes(size, size, 8, 1.2)


# --- motion (plain) -----------------------------------------------------------


def test_down2_mean_bitwise_equal(rng):
    x = rng.uniform(0, 255, (3, 67, 97)).astype(np.float32)
    np.testing.assert_array_equal(
        tmotion.down2_mean(_t(x)).numpy(), np.asarray(jmotion.down2_mean(jnp.asarray(x)))
    )


@pytest.mark.parametrize("shape,block,radius", [((48, 64), 16, 8), ((45, 70), 8, 4)])
def test_block_match_field_exact_on_integer_frames(rng, shape, block, radius):
    f = _texture_frames(rng, 3, *shape)
    k = tmotion.block_match_index(_t(f[:-1]), _t(f[1:]), block, radius)
    side = 2 * radius + 1
    jdy, jdx = jmotion.block_match_field(jnp.asarray(f[:-1]), jnp.asarray(f[1:]), block, radius)
    np.testing.assert_array_equal((k // side - radius).numpy(), np.asarray(jdy))
    np.testing.assert_array_equal((k % side - radius).numpy(), np.asarray(jdx))


@pytest.mark.parametrize("shape,block,radius", [((48, 64), 16, 8), ((45, 70), 8, 4)])
def test_block_match_motion_matches_jax(rng, shape, block, radius):
    f = _texture_frames(rng, 3, *shape)
    got = tmotion.block_match_motion(_t(f[:-1]), _t(f[1:]), block, radius).numpy()
    want = np.asarray(jmotion.block_match_motion(jnp.asarray(f[:-1]), jnp.asarray(f[1:]), block, radius))
    np.testing.assert_allclose(got, want, rtol=F32_RTOL)


def test_block_match_static_scene_is_zero(rng):
    f = _texture_frames(rng, 1, 40, 56)
    f2 = np.concatenate([f, f])
    assert float(tmotion.block_match_motion(_t(f2[:1]), _t(f2[1:]), 8, 4)[0]) == 0.0


def test_pyramid_series_matches_jax(rng):
    g = _texture_frames(rng, 4, 68, 130, step=(4, -6))
    got = tmotion.block_match_motion_pyramid_series(_t(g), 16, 8).numpy()
    want = np.asarray(jmotion.block_match_motion_pyramid_series(jnp.asarray(g), 16, 8))
    np.testing.assert_allclose(got, want, rtol=F32_RTOL)


def test_fps_variation_matches_jax():
    ts = np.array([0.0, 33.3, 66.6, 66.6, 120.0, 0.0, 0.0], np.float32)
    valid = np.arange(7) < 5
    jf, jv = jmotion.fps_variation(jnp.asarray(ts), jnp.asarray(valid))
    tf, tv = tmotion.fps_variation(_t(ts), _t(valid))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=F32_RTOL)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
