"""The port's full-reference quality engine vs the JAX package's, on the CPU.

* the plain chunk body against ``_program_a`` + ``_program_b``;
* the kernel chunk body (its wrappers take their plain versions on CPU
  tensors) against ``_chunk_fused_tpu`` with the Pallas kernels in
  interpret mode and exact f32 filters;
* the streaming chunk loop over an encoded clip pair, three chunks with a
  ragged tail, against the JAX engine, and against one single chunk (the
  blur carry across chunk boundaries);
* the kernel chunk body at 3840, 3856 and 4096 wide (one body at every
  width, past the JAX package's TPU gate of 3840) against ``chunk_plain``;
* the combined engine (``analyze_combined``) and the streaming complexity
  accumulator against the JAX package's on an encoded 64x96 clip; the
  merged step (``merged=True``) against the JAX package's merged program
  and against the port's own tap, and the ``merged=None`` policy;
* pooling, precision and chunk-size rules;
* the frozen 1080p real-content goldens.

Tolerances: MSE/PSNR/SSIM rel 1e-6 (integer sums in both; ULPs of the
final division); motion SADs rel 1e-5; VIF/ADM rel 1e-4 against the JAX
plain ops and rel 3e-4 against the Pallas kernels; pooled PSNR/SSIM rel
1e-6, VMAF rel 1e-5 (per frame 1e-4, as the VIF/ADM it is made of). The
goldens are held to the JAX test's rtol 1e-5 / atol 1e-6 (vif_scale0: see
the test). Complexity against the JAX package: rel 1e-4, motion and edge
rel 5e-3, as tests/test_torch_pipeline.py holds the CSV rows (the JAX
suite's fused gray conversion rounds with FMAs, which moves gray entropy
by 4e-5 on the 64x96 clip here, in the suite as in the accumulator); the
port's accumulator against the port's own suite rel 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from rtvqa_tpu.metrics import complexity_streaming as jcs
from rtvqa_tpu.metrics import full_reference as jfr
from rtvqa_tpu.vmaf import model as jmodel
from rtvqa_tpu_torch.metrics import complexity_streaming as tcs
from rtvqa_tpu_torch.metrics.complexity import calculate_average_scene_complexity
from rtvqa_tpu_torch.metrics import full_reference as tfr
from tests.test_torch_quality import _svr_model_json, content_pair, rel_err, t

torch.set_num_threads(1)

VQ_KEYS = ("vif_scale0", "vif_scale1", "vif_scale2", "vif_scale3", "adm2")


def chunk_inputs(rng, b, h, w):
    """Camera-like luma pair, random chroma pair (uint8), and a prev blur."""
    ry, dy = content_pair(rng, b, h, w)
    hc, wc = -(-h // 2), -(-w // 2)
    ru, rv = (rng.integers(0, 256, (b, hc, wc), np.uint8) for _ in range(2))
    du, dv = (np.clip(a.astype(np.int16) + rng.integers(-6, 7, a.shape), 0, 255).astype(np.uint8)
              for a in (ru, rv))
    prev_blur = (rng.random((h, w)) * 255).astype(np.float32)
    return (ry, ru, rv, dy, du, dv), prev_blur


def check_packed(got, want, vq_rtol):
    for i, key in enumerate(tfr.CHUNK_KEYS):
        g, w = got[i], np.asarray(want[i])
        if key == "motion_sad":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=key)
        elif key in VQ_KEYS:
            assert rel_err(g, w) < vq_rtol, key
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=key)


def test_chunk_keys_match_jax():
    assert tfr.CHUNK_KEYS == jfr.CHUNK_KEYS


@pytest.mark.parametrize("shape", [(48, 64), (50, 70)])
@pytest.mark.parametrize("has_prev,egl", [(False, None), (True, 1.0)])
def test_chunk_plain_matches_jax_programs(rng, shape, has_prev, egl):
    planes, prev_blur = chunk_inputs(rng, 3, *shape)
    pa, jblur = jfr._program_a(*planes, prev_blur, jnp.asarray(has_prev))
    pb = jfr._program_b(planes[0], planes[3], vif_egl=egl, adm_egl=egl)
    want = np.concatenate([np.asarray(pa), np.asarray(pb)])
    got, blur = tfr.chunk_plain(*map(t, planes), t(prev_blur), has_prev, egl, egl)
    check_packed(got.numpy(), want, 1e-4)
    np.testing.assert_allclose(blur.numpy(), np.asarray(jblur), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", [(48, 64), (50, 70)])
@pytest.mark.parametrize("has_prev,egl", [(True, None), (False, 1.0)])
def test_chunk_kernel_body_matches_jax_fused(rng, shape, has_prev, egl):
    planes, prev_blur = chunk_inputs(rng, 2, *shape)
    want, jblur = jfr._chunk_fused_tpu(
        *planes, prev_blur, jnp.asarray(has_prev), egl, egl, fast3=False, interpret=True
    )
    got, blur = tfr.chunk_kernels(*map(t, planes), t(prev_blur), has_prev, egl, egl)
    check_packed(got.numpy(), np.asarray(want), 3e-4)
    np.testing.assert_allclose(blur.numpy(), np.asarray(jblur), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("has_prev", [True, False])
@pytest.mark.parametrize("w", [3840, 3856, 4096])
def test_fused_body_on_wide_cpu_frames_matches_plain(rng, w, has_prev):
    """``chunk_kernels`` on the kernels' plain versions equals
    ``chunk_plain`` at 40 x 3840 (the JAX package's TPU width gate), 40 x
    3856 (the card's wide-chunk test's shape) and 40 x 4096 (DCI 4K), at
    the card's wide-chunk test's tolerances: MSE/PSNR rel 1e-6, the rest
    rel 3e-4, the blur carry equal."""
    planes, prev_blur = chunk_inputs(rng, 3, 40, w)
    got, blur = tfr.chunk_kernels(*map(t, planes), t(prev_blur), has_prev)
    want, blur_p = tfr.chunk_plain(*map(t, planes), t(prev_blur), has_prev)
    for i, key in enumerate(tfr.CHUNK_KEYS):
        tol = 1e-6 if key.startswith(("mse", "psnr")) else 3e-4
        assert rel_err(got[i].numpy(), want[i].numpy()) < tol, key
    assert torch.equal(blur, blur_p)


@pytest.fixture(scope="module")
def clip_pair(tmp_path_factory):
    """An 11-frame 96x128 camera-like clip, encoded at CRF 12 (ref) and
    re-encoded at CRF 34 (dis)."""
    from fractions import Fraction

    from rtvqa_tpu_torch.io import video as vio

    d = tmp_path_factory.mktemp("fr_clip")
    rng = np.random.default_rng(21)
    n, h, w = 11, 96, 128
    y, _ = content_pair(rng, n, h, w)
    y = np.stack([np.roll(y[0], (2 * i, -3 * i), (0, 1)) for i in range(n)])
    u = rng.integers(90, 170, (n, h // 2, w // 2), np.uint8)
    v = rng.integers(90, 170, (n, h // 2, w // 2), np.uint8)
    ref, dis = str(d / "ref.mp4"), str(d / "dis.mp4")
    vio.encode_raw_yuv420(ref, y, u, v, fps=Fraction(30, 1), crf=12, preset="veryfast")
    vio.transcode(ref, dis, crf=34, preset="veryfast")
    return ref, dis, n


def test_chunk_loop_matches_jax_engine(clip_pair):
    ref, dis, n = clip_pair
    want = jfr.analyze_full_reference(ref, dis, chunk=4)
    got = tfr.analyze_full_reference(ref, dis, chunk=4, device="cpu")
    assert got["n_frames"] == want["n_frames"] == n
    for key in ("psnr", "ssim", "vmaf"):
        assert got[key] == pytest.approx(want[key], rel=1e-5), key
    assert got["vmaf_is_fallback"] and got["vmaf_model"] == want["vmaf_model"]
    for key, w in want["per_frame"].items():
        tol = 1e-4 if key in VQ_KEYS + ("vmaf",) else 1e-5  # VMAF follows VIF/ADM
        np.testing.assert_allclose(got["per_frame"][key], np.asarray(w), rtol=tol, atol=1e-6,
                                   err_msg=key)
    assert got["per_frame"]["motion2"][0] == 0.0 and got["per_frame"]["motion2"][1:].min() > 0


def test_chunk_loop_carries_blur_across_chunks(clip_pair):
    """Three chunks (4, 4, 3 padded to 4) give the series of one chunk."""
    ref, dis, n = clip_pair
    chunked = tfr.analyze_full_reference(ref, dis, chunk=4, device="cpu")["per_frame"]
    whole = tfr.analyze_full_reference(ref, dis, chunk=12, device="cpu")["per_frame"]
    for key in whole:
        assert len(chunked[key]) == n, key
        np.testing.assert_allclose(chunked[key], whole[key], rtol=1e-6, atol=1e-6, err_msg=key)


@pytest.fixture(scope="module")
def small_pair(tmp_path_factory):
    """A 13-frame 64x96 moving-texture clip, encoded at CRF 14 (ref) and
    re-encoded at CRF 36 (dis)."""
    from fractions import Fraction

    from rtvqa_tpu_torch.io import video as vio

    d = tmp_path_factory.mktemp("combined_clip")
    rng = np.random.default_rng(23)
    n, h, w = 13, 64, 96
    tex, _ = content_pair(rng, 1, h + 32, w + 32)
    y = np.stack([np.roll(tex[0], (i, -2 * i), (0, 1))[:h, :w] for i in range(n)])
    u = rng.integers(80, 180, (n, h // 2, w // 2), np.uint8)
    v = rng.integers(80, 180, (n, h // 2, w // 2), np.uint8)
    ref, dis = str(d / "ref.mp4"), str(d / "dis.mp4")
    vio.encode_raw_yuv420(ref, y, u, v, fps=Fraction(25, 1), crf=14, preset="veryfast")
    vio.transcode(ref, dis, crf=36, preset="veryfast")
    return ref, dis, n


def check_complexity(got, want, rtol=1e-4, decision_rtol=5e-3):
    for field in ("motion", "dct", "histogram", "edge", "orb", "color", "temporal_dct", "framerate"):
        tol = decision_rtol if field in ("motion", "edge") else rtol
        assert getattr(got, field) == pytest.approx(getattr(want, field), rel=tol, abs=1e-9), field
    assert got.motion > 0 and got.framerate > 0


@pytest.mark.parametrize("interval,on", [(1, "dis"), (3, "dis"), (3, "ref")])
def test_analyze_combined_matches_jax(small_pair, interval, on):
    ref, dis, n = small_pair
    kw = dict(frame_interval=interval, resize_width=32, resize_height=32, complexity_chunk=4,
              complexity_on=on, chunk=4)
    jq, jc = jfr.analyze_combined(ref, dis, **kw)
    tq, tc = tfr.analyze_combined(ref, dis, **kw, device="cpu")
    assert tq["n_frames"] == jq["n_frames"] == n
    for key in ("psnr", "ssim", "vmaf"):
        assert tq[key] == pytest.approx(jq[key], rel=1e-5), key
    for key, w in jq["per_frame"].items():
        tol = 1e-4 if key in VQ_KEYS + ("vmaf",) else 1e-5
        np.testing.assert_allclose(tq["per_frame"][key], np.asarray(w), rtol=tol, atol=1e-6, err_msg=key)
    check_complexity(tc, jc)
    # The tap leaves the quality series as they are without it.
    alone = tfr.analyze_full_reference(ref, dis, chunk=4, device="cpu")
    for key, w in alone["per_frame"].items():
        np.testing.assert_array_equal(tq["per_frame"][key], w, err_msg=key)


MERGED_KW = dict(frame_interval=1, resize_width=32, resize_height=32, complexity_chunk=4, chunk=4)


@pytest.mark.parametrize("on", ["dis", "ref"])
def test_analyze_combined_merged_matches_jax(small_pair, on):
    """The merged step on the CPU against the JAX package's merged program
    (``_program_chunk_combined`` on its CPU backend); chunk 4 over 13 frames
    runs the ragged tail and the cross-chunk tail carry."""
    ref, dis, n = small_pair
    jq, jc = jfr.analyze_combined(ref, dis, merged=True, complexity_on=on, **MERGED_KW)
    tq, tc = tfr.analyze_combined(ref, dis, merged=True, complexity_on=on, **MERGED_KW, device="cpu")
    assert tq["n_frames"] == jq["n_frames"] == n
    for key in ("psnr", "ssim", "vmaf"):
        assert tq[key] == pytest.approx(jq[key], rel=1e-5), key
    for key, w in jq["per_frame"].items():
        tol = 1e-4 if key in VQ_KEYS + ("vmaf",) else 1e-5
        np.testing.assert_allclose(tq["per_frame"][key], np.asarray(w), rtol=tol, atol=1e-6, err_msg=key)
    check_complexity(tc, jc)


@pytest.mark.parametrize("on", ["dis", "ref"])
def test_analyze_combined_merged_matches_tap(small_pair, on):
    """The port's merged step against its own tap at frame_interval 1: the
    quality series bit for bit, the complexity 8-tuple equal (the values of
    a frame do not follow the chunk they are computed in)."""
    ref, dis, _ = small_pair
    tq, tc = tfr.analyze_combined(ref, dis, merged=False, complexity_on=on, **MERGED_KW, device="cpu")
    mq, mc = tfr.analyze_combined(ref, dis, merged=True, complexity_on=on, **MERGED_KW, device="cpu")
    for key, w in tq["per_frame"].items():
        np.testing.assert_array_equal(mq["per_frame"][key], w, err_msg=key)
    assert mc == tc


def test_analyze_combined_merged_refusals(small_pair):
    ref, dis, _ = small_pair
    for mod in (jfr, tfr):
        with pytest.raises(ValueError, match="frame_interval=1"):
            mod.analyze_combined(ref, dis, frame_interval=3, merged=True)


def test_merged_policy(small_pair, monkeypatch):
    """merged=None: the tap on the CPU; on the card the merged step at
    frame_interval 1 and the tap above it (checked through the policy
    function, which asks ``get_device`` whether there is a card)."""
    ref, dis, _ = small_pair
    cpu = torch.device("cpu")
    assert tfr.resolve_merged(None, 1, cpu) is False
    assert tfr.resolve_merged(True, 1, cpu) is True
    assert tfr.resolve_merged(False, 1, "cpu") is False
    calls = []
    real_loop = tfr._quality_chunk_loop

    def spy(*args, **kw):
        calls.append(kw.get("combined"))
        return real_loop(*args, **kw)

    monkeypatch.setattr(tfr, "_quality_chunk_loop", spy)
    tfr.analyze_combined(ref, dis, **MERGED_KW, device="cpu")
    tfr.analyze_combined(ref, dis, **MERGED_KW, merged=True, device="cpu")
    assert calls[0] is None and calls[1]["complexity_on"] == "dis"  # the tap, then the merged step
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tfr.resolve_merged(None, 1, "cuda") is True
    assert tfr.resolve_merged(None, 1, None) is True
    assert tfr.resolve_merged(None, 10, "cuda") is False
    with pytest.raises(ValueError, match="frame_interval=1"):
        tfr.resolve_merged(True, 10, "cuda")


def test_chunk_loop_combined_excludes_tap_and_runner():
    acc = tcs.ComplexityAccumulator(32, 32, chunk=4, device="cpu")
    combined = {"acc": acc, "complexity_on": "dis"}
    for extra in (dict(tap=lambda *a: None), dict(runner=tfr.chunk_plain)):
        with pytest.raises(ValueError, match="excludes tap and runner"):
            tfr._quality_chunk_loop(iter(()), iter(()), 4, None, None, torch.device("cpu"), "plain",
                                    combined=combined, **extra)


@pytest.mark.parametrize("cchunk,schunk", [(5, 3), (128, 32)])
def test_streaming_complexity_matches_jax(small_pair, cchunk, schunk):
    """The port's accumulator (fed in uneven batches) and streaming driver
    against the JAX package's, each with the other chunking."""
    from rtvqa_tpu_torch.io import video as vio

    _, dis, _ = small_pair
    kw = dict(resize_width=32, resize_height=32, frame_interval=1)
    want = jcs.calculate_average_scene_complexity_streaming(dis, chunk=cchunk, **kw)
    check_complexity(tcs.calculate_average_scene_complexity_streaming(dis, chunk=schunk, **kw,
                                                                      device="cpu"), want)
    clip = vio.decode_sampled(dis, frame_interval=1)
    jacc = jcs.ComplexityAccumulator(32, 32, chunk=schunk)
    tacc = tcs.ComplexityAccumulator(32, 32, chunk=cchunk, device="cpu")
    for lo, hi in ((0, 2), (2, 9), (9, len(clip.y))):
        for acc in (jacc, tacc):
            acc.add(clip.y[lo:hi], clip.u[lo:hi], clip.v[lo:hi], clip.timestamps_ms[lo:hi])
    got = tacc.finalize()
    check_complexity(got, jacc.finalize())
    whole = calculate_average_scene_complexity(clip, 32, 32, device="cpu")
    check_complexity(got, whole, rtol=1e-6, decision_rtol=1e-6)


def test_accumulator_add_packed_rules():
    acc = tcs.ComplexityAccumulator(32, 32, chunk=4, device="cpu")
    rows = np.arange(len(tcs.VALUE_KEYS) * 3, dtype=np.float32).reshape(len(tcs.VALUE_KEYS), 3)
    acc.add_packed(rows, np.array([0.0, 40.0, 80.0]))
    assert acc.n_total == 3
    y = np.zeros((1, 16, 16), np.uint8)
    acc.add(y, y[:, :8, :8], y[:, :8, :8], np.array([120.0]))
    with pytest.raises(RuntimeError, match="mixed"):
        acc.add_packed(rows, np.array([160.0]))
    assert tcs.VALUE_KEYS == jcs.VALUE_KEYS


def test_analyze_full_reference_routes(clip_pair):
    ref, dis, _ = clip_pair
    with pytest.raises(NotImplementedError, match="fast"):
        tfr.analyze_full_reference(ref, dis, device="cpu", quality_precision="fast")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tfr.analyze_full_reference(ref, dis)


def test_resolve_precision():
    for q in (None, "auto", "exact"):
        assert tfr.resolve_precision(q) is None
    with pytest.raises(NotImplementedError, match="not ported"):
        tfr.resolve_precision("fast")
    with pytest.raises(ValueError, match="quality_precision"):
        tfr.resolve_precision("bogus")


@pytest.mark.parametrize("w,h,req", [(1920, 1080, None), (3840, 2160, None), (640, 360, None),
                                     (1920, 1080, 4), (1920, 1080, 7), (64, 48, None)])
def test_auto_chunk_matches_jax(w, h, req):
    assert tfr.auto_chunk(w, h, req) == jfr.auto_chunk(w, h, req)


@pytest.mark.parametrize("with_model", [False, True])
def test_pool_full_reference_matches_jax(rng, tmp_path, with_model):
    n = 9
    s = {k: rng.uniform(0.2, 1.0, n).astype(np.float32) for k in tfr.CHUNK_KEYS}
    s["mse_avg"] = rng.uniform(1, 30, n).astype(np.float32)
    s["motion_sad"] = rng.uniform(0, 8, n).astype(np.float32)
    s["motion_sad"][0] = 0.0
    path = None
    if with_model:
        path = str(tmp_path / "model.json")
        _svr_model_json(path, rng)
    want = jfr.pool_full_reference(s, n, path)
    got = tfr.pool_full_reference(s, n, path)
    assert got["n_frames"] == n and got["vmaf_is_fallback"] == want["vmaf_is_fallback"] == (not with_model)
    assert got["vmaf_model"] == want["vmaf_model"]
    for key in ("psnr", "ssim"):
        assert got[key] == pytest.approx(want[key], rel=1e-6), key
    assert got["vmaf"] == pytest.approx(want["vmaf"], rel=1e-5)
    np.testing.assert_array_equal(got["per_frame"]["motion2"], np.asarray(want["per_frame"]["motion2"]))
    np.testing.assert_allclose(got["per_frame"]["vmaf"], np.asarray(want["per_frame"]["vmaf"]), rtol=1e-5)


def test_pool_with_model_from_jax_weights(rng):
    import dataclasses

    from rtvqa_tpu_torch.vmaf.model import model_from_numpy

    n = 6
    s = {k: rng.uniform(0.5, 1.0, n).astype(np.float32) for k in tfr.CHUNK_KEYS}
    jm = jmodel.builtin_model()
    want = jfr.pool_full_reference(s, n, model=jm)
    got = tfr.pool_full_reference(s, n, model=model_from_numpy(dataclasses.asdict(jm)))
    assert got["vmaf"] == pytest.approx(want["vmaf"], rel=1e-5)


def test_real_content_1080p_feature_goldens(tmp_path):
    """The port's plain engine on the frozen real-content 1080p pair
    (tests/real_content.py), held to the JAX test's rtol 1e-5 / atol 1e-6,
    except vif_scale0 at rtol 5e-5 (measured 4.23e-5): the goldens carry
    the JAX CPU path's f32 reduction error over 2M pixels, and the port's
    sum agrees with a float64 accumulation of the same per-pixel terms to
    4e-8 (ROADMAP.md queue C)."""
    from tests import real_content

    golden = np.load(real_content.GOLDEN_PATH)
    ref, dis = real_content.build_pair(str(tmp_path))
    assert real_content.decoded_luma_digest(ref) == str(golden["digest_ref"])
    assert real_content.decoded_luma_digest(dis) == str(golden["digest_dis"])
    res = tfr.analyze_full_reference(ref, dis, chunk=4, device="cpu")
    assert res["n_frames"] == real_content.N_FRAMES
    for key in real_content.FEATURE_KEYS:
        got = np.asarray(res["per_frame"][key], np.float32)
        want = np.asarray(golden[key])
        finite = np.isfinite(want)
        np.testing.assert_array_equal(finite, np.isfinite(got), err_msg=key)
        rtol = 5e-5 if key == "vif_scale0" else 1e-5
        np.testing.assert_allclose(got[finite], want[finite], rtol=rtol, atol=1e-6, err_msg=key)
