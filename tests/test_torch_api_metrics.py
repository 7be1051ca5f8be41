"""The port's metric entry points of the JAX package's API vs the JAX
package's, on the CPU: the scene-complexity scorer, ``compute_quality``,
VMAF motion, ``extract_features`` / ``compute_vmaf`` and ``stream_batches``.

Inputs: an 8-frame 72x128 camera-like clip encoded by the port's encoder
at CRF 12 (ref) and re-encoded at CRF 34 (dis), decoded once by the port's
decoder; both packages take the same decoded planes.

Tolerances, each with its reason:
* the scorer's constants and its arithmetic on equal inputs: exact;
* complexity values rel 1e-4, motion and edge rel 5e-3 (as
  tests/test_torch_full_reference.py holds the suite against the JAX
  package), the score within the bound those give it: the sum of weight x
  tolerance x |value| / range over the eight metrics;
* PSNR/SSIM per frame and pooled rel 1e-6 (integer sums in both; ULPs of
  the final division);
* VIF/ADM rel 1e-4 (the port's plain ops against the JAX plain ops), motion
  SADs rel 1e-5 / abs 1e-6, pooled VMAF rel 1e-5: what
  tests/test_torch_full_reference.py holds ``program_b`` and the pooled
  engine to;
* the chunk size moves no value: equal, bit for bit;
* decoded frames: equal.
"""

import dataclasses
import struct
import zlib
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from rtvqa_tpu.io import stream as jstream
from rtvqa_tpu.metrics import complexity as jcx
from rtvqa_tpu.metrics import quality as jq
from rtvqa_tpu.vmaf import motion as jmotion
from rtvqa_tpu.vmaf import predictor as jpred
from rtvqa_tpu_torch.io import stream as tstream
from rtvqa_tpu_torch.io import video as tvio
from rtvqa_tpu_torch.metrics import complexity as tcx
from rtvqa_tpu_torch.metrics import quality as tq
from rtvqa_tpu_torch.vmaf import motion as tmotion
from rtvqa_tpu_torch.vmaf import predictor as tpred
from tests.test_torch_quality import _svr_model_json, content_pair, rel_err

torch.set_num_threads(1)

N, H, W = 8, 72, 128
CX_RTOL = {"motion": 5e-3, "edge": 5e-3}
CX_RTOL_OTHER = 1e-4
PQ_RTOL = 1e-6
VQ_KEYS = ("vif_scale0", "vif_scale1", "vif_scale2", "vif_scale3", "adm2")
VQ_RTOL = 1e-4
SAD_RTOL, SAD_ATOL = 1e-5, 1e-6
VMAF_RTOL = 1e-5


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """(ref path, dis path, ref DecodedClip, dis DecodedClip)."""
    d = tmp_path_factory.mktemp("api_clip")
    rng = np.random.default_rng(31)
    y, _ = content_pair(rng, N, H, W)
    y = np.stack([np.roll(y[0], (2 * i, -3 * i), (0, 1)) for i in range(N)])
    u = rng.integers(90, 170, (N, H // 2, W // 2), np.uint8)
    v = rng.integers(90, 170, (N, H // 2, W // 2), np.uint8)
    ref, dis = str(d / "ref.mp4"), str(d / "dis.mp4")
    tvio.encode_raw_yuv420(ref, y, u, v, fps=Fraction(30, 1), crf=12, preset="veryfast")
    tvio.transcode(ref, dis, crf=34, preset="veryfast")
    return ref, dis, tvio.decode_sampled(ref, 1), tvio.decode_sampled(dis, 1)


# --- the scene-complexity scorer -------------------------------------------------


def test_score_constants_equal_jax():
    assert tcx.SCORE_WEIGHTS == jcx.SCORE_WEIGHTS
    assert tcx.SCORE_RANGES == jcx.SCORE_RANGES
    for args in ((3.0, 0.0, 10.0), (2e7, 1e6, 5e7), (1.0, 2.0, 2.0), (5.0, 3.0, 1.0)):
        assert tcx.normalize(*args) == jcx.normalize(*args)
    rng = np.random.default_rng(5)
    vals = dict(zip(tcx.METRIC_ORDER, rng.uniform(0, 1e4, 8).tolist()))
    assert tcx.scene_complexity_score(tcx.ComplexityResult(**vals)) == \
        jcx.scene_complexity_score(jcx.ComplexityResult(**vals))


def _check_result(got, want):
    for key in tcx.METRIC_ORDER:
        g, w = getattr(got, key), getattr(want, key)
        assert g == pytest.approx(w, rel=CX_RTOL.get(key, CX_RTOL_OTHER), abs=1e-6), key


def _score_bound(res) -> float:
    """The score's tolerance from its values' tolerances."""
    bound = 0.0
    for key, weight in tcx.SCORE_WEIGHTS.items():
        lo, hi = tcx.SCORE_RANGES[key]
        bound += weight * CX_RTOL.get(key, CX_RTOL_OTHER) * abs(getattr(res, key)) / (hi - lo)
    return bound + 1e-12


def test_scene_complexity_score_matches_jax(clips):
    _, _, ref, _ = clips
    res = tcx.calculate_average_scene_complexity(ref, 32, 32, device="cpu")
    _check_result(res, jcx.calculate_average_scene_complexity(ref, 32, 32))
    got = tcx.calculate_scene_complexity_score(ref, 32, 32, device="cpu")
    assert got == tcx.scene_complexity_score(res)
    want = jcx.calculate_scene_complexity_score(ref, 32, 32)
    assert abs(got - want) <= _score_bound(res)


def test_scene_complexity_score_takes_a_path(clips):
    path, _, _, _ = clips
    clip = tvio.decode_sampled(path, 2)
    by_clip = tcx.calculate_scene_complexity_score(clip, 32, 32, device="cpu")
    by_path = tcx.calculate_scene_complexity_score(
        path, 32, 32, frame_interval=2, num_workers=1, batch_size=100, device="cpu")
    assert by_path == by_clip
    res = tcx.calculate_average_scene_complexity(clip, 32, 32, device="cpu")
    assert abs(by_path - jcx.calculate_scene_complexity_score(path, 32, 32, frame_interval=2)) \
        <= _score_bound(res)


def _write_png(path, arr):
    def chunk(typ, data):
        c = struct.pack(">I", len(data)) + typ + data
        return c + struct.pack(">I", zlib.crc32(typ + data) & 0xFFFFFFFF)

    h, w = arr.shape[:2]
    raw = b"".join(b"\x00" + arr[i].tobytes() for i in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def test_scene_complexity_score_takes_a_still_image(tmp_path):
    path = str(tmp_path / "frame.png")
    _write_png(path, np.random.default_rng(3).integers(0, 255, (48, 64, 3), np.uint8))
    clip = tvio.decode_sampled(path, 1)
    assert clip.y.shape[0] == 1
    static = dataclasses.replace(
        clip, y=np.repeat(clip.y, 2, 0), u=np.repeat(clip.u, 2, 0), v=np.repeat(clip.v, 2, 0),
        timestamps_ms=np.repeat(clip.timestamps_ms, 2))
    res = tcx.calculate_average_scene_complexity(static, 32, 32, device="cpu")
    assert res.motion == res.temporal_dct == res.framerate == 0.0
    assert res.histogram > 0.0 and res.dct > 0.0
    got = tcx.calculate_scene_complexity_score(path, 32, 32, device="cpu")
    assert got == tcx.scene_complexity_score(res)
    assert abs(got - jcx.calculate_scene_complexity_score(path, 32, 32)) <= _score_bound(res)


# --- compute_quality ---------------------------------------------------------------


def test_compute_quality_matches_jax(clips):
    _, _, ref, dis = clips
    want = jq.compute_quality(ref, dis)
    got = tq.compute_quality(ref, dis, device="cpu")
    assert set(got) == set(want) and got["n_frames"] == want["n_frames"] == N
    for key in ("psnr", "ssim"):
        assert got[key] == pytest.approx(want[key], rel=PQ_RTOL), key
    for key in ("psnr_frames", "ssim_frames"):
        assert got[key].shape == (N,) and got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=PQ_RTOL, err_msg=key)
    for chunk in (1, 3):
        again = tq.compute_quality(ref, dis, chunk=chunk, device="cpu")
        for key, value in got.items():
            np.testing.assert_array_equal(again[key], value, err_msg=f"chunk {chunk} {key}")


def test_compute_quality_identical_clips(clips):
    _, _, ref, _ = clips
    got = tq.compute_quality(ref, ref, chunk=5, device="cpu")
    assert got["psnr"] == float("inf") and np.isinf(got["psnr_frames"]).all()
    assert got["ssim"] == pytest.approx(1.0)


def test_pooled_mean_matches_jax(rng):
    x = rng.uniform(0, 50, 12).astype(np.float32)
    valid = rng.random(12) < 0.6
    want = float(jq.pooled_mean(jnp.asarray(x), jnp.asarray(valid)))
    assert float(tq.pooled_mean(torch.from_numpy(x), torch.from_numpy(valid))) == \
        pytest.approx(want, rel=PQ_RTOL)
    assert float(tq.pooled_mean(torch.from_numpy(x), torch.zeros(12, dtype=torch.bool))) == 0.0


# --- VMAF ---------------------------------------------------------------------------


def test_motion_features_match_jax(clips):
    _, _, ref, _ = clips
    want = jmotion.motion_features(jnp.asarray(ref.y, jnp.float32))
    got = tmotion.motion_features(torch.from_numpy(ref.y))
    for key in ("motion", "motion2"):
        assert got[key].shape == (N,) and got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=SAD_RTOL,
                                   atol=SAD_ATOL, err_msg=key)
    assert float(got["motion"][0]) == 0.0
    for chunk in (1, 3, 5):
        again = tmotion.motion_features(torch.from_numpy(ref.y), chunk=chunk)
        for key in got:
            assert torch.equal(again[key], got[key]), (chunk, key)


def _check_features(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert g.shape == (N,) and g.dtype == np.float32, key
        if key in VQ_KEYS:
            assert rel_err(g, w) < VQ_RTOL, key
        else:
            np.testing.assert_allclose(g, np.asarray(w), rtol=SAD_RTOL, atol=SAD_ATOL, err_msg=key)


def test_extract_features_matches_jax(clips):
    _, _, ref, dis = clips
    got = tpred.extract_features(ref, dis, device="cpu")
    _check_features(got, jpred.extract_features(ref, dis))
    for chunk in (1, 3):
        again = tpred.extract_features(ref, dis, chunk=chunk, device="cpu")
        for key, value in got.items():
            np.testing.assert_array_equal(again[key], value, err_msg=f"chunk {chunk} {key}")


@pytest.mark.parametrize("model", ["builtin", "svr"])
def test_compute_vmaf_matches_jax(clips, tmp_path, model):
    _, _, ref, dis = clips
    path = None
    if model == "svr":
        path = str(tmp_path / "model.json")
        _svr_model_json(path, np.random.default_rng(7))
    want, want_d = jpred.compute_vmaf(ref, dis, model_path=path, return_details=True)
    got, got_d = tpred.compute_vmaf(ref, dis, model_path=path, return_details=True, device="cpu")
    assert got == pytest.approx(want, rel=VMAF_RTOL)
    assert got_d["model"] == want_d["model"]
    np.testing.assert_allclose(got_d["per_frame"], np.asarray(want_d["per_frame"]), rtol=VQ_RTOL)
    _check_features(got_d["features"], want_d["features"])
    assert tpred.compute_vmaf(ref, dis, model_path=path, device="cpu") == got


def test_extract_features_routes(clips):
    _, _, ref, dis = clips
    with pytest.raises(ValueError, match="needs a CUDA device"):
        tpred.extract_features(ref, dis, impl="kernel", device="cpu")
    with pytest.raises(ValueError, match="impl must be"):
        tpred.extract_features(ref, dis, impl="xla", device="cpu")
    with pytest.raises(ValueError, match="chunk must be"):
        tpred.extract_features(ref, dis, chunk=0, device="cpu")
    assert tpred.default_chunk(1080, 1920, torch.device("cpu"), "plain") >= 1
    assert tpred.default_chunk(8, 8, torch.device("cpu"), "plain") == tpred.MAX_CHUNK


def test_entry_points_default_to_the_card(clips):
    """Without a card, device=None raises: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    _, _, ref, dis = clips
    for call in (lambda: tpred.compute_vmaf(ref, dis),
                 lambda: tpred.extract_features(ref, dis),
                 lambda: tq.compute_quality(ref, dis),
                 lambda: tcx.calculate_scene_complexity_score(ref, 32, 32)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


# --- stream_batches ------------------------------------------------------------------


@pytest.mark.parametrize("interval,batch", [(1, 3), (2, 2)])
def test_stream_batches_match_jax(clips, interval, batch):
    path, _, _, _ = clips
    got = list(tstream.stream_batches(path, frame_interval=interval, batch=batch, prefetch_depth=2))
    want = list(jstream.stream_batches(path, frame_interval=interval, batch=batch, prefetch_depth=2))
    assert len(got) == len(want) == -(-(N // interval) // batch)
    for g, w in zip(got, want):
        assert g.start_index == w.start_index
        for key in ("y", "u", "v", "timestamps_ms"):
            np.testing.assert_array_equal(getattr(g, key), getattr(w, key), err_msg=key)
