"""The port's quality ops (PSNR, x264 SSIM, separable filters, VIF, ADM, the
VMAF model) vs the JAX package's on the same inputs, made with numpy from a
seed, on the CPU.

Tolerances: SSEs and SSIM block sums are integer sums in both packages, so
equal; per-frame MSE/PSNR/SSIM values rel 1e-6 (XLA may divide by a
reciprocal and contract the SSIM rational into FMAs: ULPs). Filters rel
1e-6 / abs 1e-4 (XLA contracts the tap chain into FMAs). VIF and ADM rel
1e-4, on camera-like content (a smooth texture with grain, dis = ref +
integer noise); on i.i.d. uniform noise the 3-tap scale-3 sums of a 6 x 8
frame cancel hard enough to reach ~1e-4 from FMA ULPs alone. The VMAF
prediction rel 1e-5 (f32 SVR sums in another order).
"""

import json

import numpy as np
import pytest
import torch

from rtvqa_tpu.metrics import quality as jq
from rtvqa_tpu.vmaf import adm as jadm
from rtvqa_tpu.vmaf import filters as jfilt
from rtvqa_tpu.vmaf import model as jmodel
from rtvqa_tpu.vmaf import motion as jmotion
from rtvqa_tpu.vmaf import vif as jvif
from rtvqa_tpu_torch.metrics import quality as tq
from rtvqa_tpu_torch.vmaf import adm as tadm
from rtvqa_tpu_torch.vmaf import filters as tfilt
from rtvqa_tpu_torch.vmaf import model as tmodel
from rtvqa_tpu_torch.vmaf import motion as tmotion
from rtvqa_tpu_torch.vmaf import vif as tvif

torch.set_num_threads(1)

SHAPES = [(48, 64), (50, 70)]


def yuv_pair(rng, b, h, w, noise=9):
    """Random YUV420 planes and a distorted copy (uint8)."""
    hc, wc = -(-h // 2), -(-w // 2)
    ref = [rng.integers(0, 256, s, np.uint8) for s in ((b, h, w), (b, hc, wc), (b, hc, wc))]
    dis = [
        np.clip(a.astype(np.int16) + rng.integers(-noise, noise + 1, a.shape), 0, 255).astype(np.uint8)
        for a in ref
    ]
    return (*ref, *dis)


def content_pair(rng, b, h, w):
    """Camera-like luma (smooth texture + grain) and dis = ref + noise."""
    yy, xx = np.mgrid[0:h, 0:w]
    ref = np.stack([
        128 + 60 * np.sin(xx / 5.0 + i) * np.cos(yy / 7.0) + rng.normal(0, 12, (h, w))
        for i in range(b)
    ])
    ref = np.clip(ref, 0, 255).astype(np.uint8)
    dis = np.clip(ref.astype(np.int16) + rng.integers(-4, 5, ref.shape), 0, 255).astype(np.uint8)
    return ref, dis


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("shape", SHAPES)
def test_psnr_frames_match_jax(rng, shape):
    planes = yuv_pair(rng, 3, *shape)
    want = jq.psnr_frames(*planes)
    got = tq.psnr_frames(*map(t, planes))
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-6, err_msg=key)
    # The SSEs themselves are integer sums: exact.
    n_y = shape[0] * shape[1]
    sse = ((planes[0].astype(np.int64) - planes[3]) ** 2).sum(axis=(1, 2))
    assert np.array_equal(tq.plane_sse(t(planes[0]), t(planes[3])).numpy(), sse.astype(np.float32))
    assert np.array_equal(got["mse_y"].numpy() * n_y, sse.astype(np.float32))


def test_psnr_identical_frames_is_inf():
    y = np.full((2, 16, 16), 77, np.uint8)
    c = np.full((2, 8, 8), 9, np.uint8)
    got = tq.psnr_frames(*map(t, (y, c, c, y, c, c)))
    assert torch.isinf(got["psnr_avg"]).all() and torch.isinf(got["psnr_y"]).all()
    assert torch.isinf(tq.pooled_psnr(got["mse_avg"]))


def test_pooled_psnr_matches_jax(rng):
    mse = rng.random(13).astype(np.float32) * 40
    want = float(np.asarray(jq.pooled_psnr(mse, np.ones(13, bool))))
    assert float(tq.pooled_psnr(t(mse))) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_ssim_frames_match_jax(rng, shape):
    planes = yuv_pair(rng, 3, *shape)
    want = jq.ssim_frames(*planes)
    got = tq.ssim_frames(*map(t, planes))
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-6, err_msg=key)
    # Block sums are integer-exact (int32) and equal the JAX f32 pooling.
    ref = planes[0].astype(np.int32)
    np.testing.assert_array_equal(
        tq.block_sums_4x4(t(ref)).numpy(), np.asarray(jq._block_sums_4x4(ref)).astype(np.int32)
    )


def test_ssim_identity_is_one(rng):
    y = rng.integers(0, 256, (2, 40, 56), np.uint8)
    np.testing.assert_allclose(tq.ssim_plane(t(y), t(y)).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("n", [3, 5, 9, 17])
def test_gaussian_kernel_matches_jax(n):
    np.testing.assert_array_equal(tfilt.gaussian_kernel(n, n / 5.0), jfilt.gaussian_kernel(n, n / 5.0))


@pytest.mark.parametrize(
    "taps,mode",
    [
        (jfilt.gaussian_kernel(17, 17 / 5.0), "reflect"),
        (jfilt.gaussian_kernel(3, 3 / 5.0), "reflect"),
        (jmotion.FILTER_5, "reflect"),
        (jadm.DB2_LO, "reflect"),   # 4 taps: the pad is 2 before, 1 after
        (jadm.DB2_HI, "edge"),
    ],
)
def test_filters_match_jax(rng, taps, mode):
    x = rng.integers(0, 256, (2, 23, 37)).astype(np.float32)
    want = np.asarray(jfilt.filter1d_sep(x, taps, mode))
    got = tfilt.filter1d_sep(t(x), taps, mode).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    for axis in (-1, -2):
        want = np.asarray(jfilt.filter1d_sep_axis(x, taps, axis, mode))
        got = tfilt.filter1d_sep_axis(t(x), taps, axis, mode).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    # The float64 oracle (dense band matrices) agrees too.
    np.testing.assert_allclose(
        tfilt.filter1d_sep(t(x), taps, mode).numpy(), jfilt.filter1d_sep_np(x, taps, mode),
        rtol=1e-5, atol=1e-3,
    )


@pytest.mark.parametrize("shape", [(6, 8), (7, 9), (1, 5)])
def test_decimate2_matches_jax(rng, shape):
    x = rng.random((2, *shape)).astype(np.float32)
    np.testing.assert_array_equal(tfilt.decimate2(t(x)).numpy(), np.asarray(jfilt.decimate2(x)))


def test_filter5_matches_jax():
    np.testing.assert_array_equal(tmotion.FILTER_5, jmotion.FILTER_5)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("egl", [None, 1.0])
def test_vif_features_match_jax(rng, shape, egl):
    ref, dis = (a.astype(np.float32) for a in content_pair(rng, 2, *shape))
    want = jvif.vif_features(ref, dis, enhn_gain_limit=egl)
    got = tvif.vif_features(t(ref), t(dis), enhn_gain_limit=egl)
    for key in want:
        assert rel_err(got[key].numpy(), want[key]) < 1e-4, key


def test_vif_identity_is_one(rng):
    ref, _ = content_pair(rng, 1, 48, 64)
    got = tvif.vif_features(t(ref).float(), t(ref).float())
    for key, v in got.items():
        np.testing.assert_allclose(v.numpy(), 1.0, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("egl", [None, 1.0])
def test_adm_features_match_jax(rng, shape, egl):
    ref, dis = (a.astype(np.float32) for a in content_pair(rng, 2, *shape))
    want = np.asarray(jadm.adm_features(ref, dis, enhn_gain_limit=egl)["adm2"])
    got = tadm.adm_features(t(ref), t(dis), enhn_gain_limit=egl)["adm2"].numpy()
    assert rel_err(got, want) < 1e-4


@pytest.mark.parametrize("scale", [0, 1, 2, 3])
def test_adm_one_scale_matches_jax(rng, scale):
    ref, dis = (a.astype(np.float32) for a in content_pair(rng, 2, 50, 70))
    want = jadm.adm_one_scale(ref, dis, scale)
    got = tadm.adm_one_scale(t(ref), t(dis), scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-3)
    assert tadm.csf_rfactors(scale) == jadm.csf_rfactors(scale)


def test_adm_pieces_match_jax(rng):
    x = rng.normal(0, 20, (2, 25, 33)).astype(np.float32)
    for g, w in zip(tadm._dwt_1level(t(x)), jadm._dwt_1level(x)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-4)
    bands = [rng.normal(0, 10, (2, 9, 11)).astype(np.float32) for _ in range(6)]
    for egl in (None, 1.0):
        got = tadm._decouple(*map(t, bands), enhn_gain_limit=egl)
        want = jadm._decouple(*bands, enhn_gain_limit=egl)
        for g, w in zip(got[0] + got[1], want[0] + want[1]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(
        tadm._mask_threshold(*map(t, bands[:3])).numpy(),
        np.asarray(jadm._mask_threshold(*bands[:3])), rtol=1e-6,
    )
    for h, w in ((1, 1), (9, 11), (540, 960)):
        assert tadm._center_crop_slices(h, w) == jadm._center_crop_slices(h, w)


def test_adm_identity_is_one(rng):
    ref, _ = content_pair(rng, 1, 48, 64)
    got = tadm.adm_features(t(ref).float(), t(ref).float())["adm2"]
    np.testing.assert_allclose(got.numpy(), 1.0, atol=1e-6)


def _svr_model_json(path, rng, neg=False):
    n_sv, n_feat = 7, 6
    lines = ["svm_type nu_svr", "kernel_type rbf", "gamma 0.04", "nr_class 2",
             f"total_sv {n_sv}", "rho -1.3", "SV"]
    for _ in range(n_sv):
        coef = rng.normal()
        feats = " ".join(f"{i + 1}:{rng.random():.6f}" for i in range(n_feat))
        lines.append(f"{coef:.6f} {feats}")
    md = {
        "feature_names": list(jmodel.DEFAULT_FEATURES),
        "slopes": [0.012, 2.8, 0.05, 1.1, 1.05, 1.02, 1.01],
        "intercepts": [-0.3, -1.8, 0.0, -0.1, -0.1, -0.1, -0.1],
        "score_clip": [0.0, 100.0],
        "score_transform": {"p0": 1.7, "p1": 1.05, "p2": -0.0007},
        "model": "\n".join(lines),
    }
    if neg:
        md["feature_opts_dicts"] = [{"adm_enhn_gain_limit": 1.0}, {}, {"vif_enhn_gain_limit": 1.0}]
    with open(path, "w") as f:
        json.dump({"version": "test_svr", "model_dict": md}, f)


def _features(rng, n=11):
    return {
        "adm2": rng.uniform(0.8, 1.0, n).astype(np.float32),
        "motion2": rng.uniform(0, 20, n).astype(np.float32),
        **{f"vif_scale{k}": rng.uniform(0.3, 1.0, n).astype(np.float32) for k in range(4)},
    }


@pytest.mark.parametrize("neg", [False, True])
def test_load_model_and_predict_match_jax(rng, tmp_path, neg):
    path = str(tmp_path / "model.json")
    _svr_model_json(path, rng, neg)
    jm, tm = jmodel.load_model(path), tmodel.load_model(path)
    assert tm.feature_names == jm.feature_names and tm.kind == jm.kind == "rbf_nusvr"
    np.testing.assert_array_equal(tm.sv, jm.sv)
    assert tm.feature_opts == jm.feature_opts
    assert tm.vif_enhn_gain_limit == jm.vif_enhn_gain_limit
    assert tm.adm_enhn_gain_limit == jm.adm_enhn_gain_limit
    feats = _features(rng)
    np.testing.assert_allclose(tm.predict(feats).numpy(), np.asarray(jm.predict(feats)), rtol=1e-5)


def test_model_from_numpy_carries_jax_weights(rng, tmp_path):
    """One set of weights, taken field by field from the JAX model, drives
    both predictors."""
    import dataclasses

    path = str(tmp_path / "model.json")
    _svr_model_json(path, rng)
    for jm in (jmodel.load_model(path), jmodel.builtin_model()):
        tm = tmodel.model_from_numpy(dataclasses.asdict(jm))
        feats = _features(rng)
        np.testing.assert_allclose(
            tm.predict(feats).numpy(), np.asarray(jm.predict(feats)), rtol=1e-5, atol=1e-4
        )
    with pytest.raises(ValueError, match="unknown model fields"):
        tmodel.model_from_numpy({"feature_names": (), "bogus": 1})


def test_builtin_model_matches_jax(rng):
    jm, tm = jmodel.builtin_model(), tmodel.builtin_model()
    assert tm.name == jm.name and tm.bias == jm.bias
    feats = _features(rng)
    np.testing.assert_allclose(tm.predict(feats).numpy(), np.asarray(jm.predict(feats)), rtol=1e-5)
    perfect = {k: np.ones(3, np.float32) for k in feats}
    perfect["motion2"] = np.zeros(3, np.float32)
    np.testing.assert_allclose(tm.predict(perfect).numpy(), 100.0, rtol=1e-6)
    with pytest.raises(KeyError, match="needs feature"):
        tm.predict({"adm2": np.ones(2, np.float32)})
