"""The port's own host modules (``io/video.py``, ``io/stream.py``,
``pipeline/csv_sink.py``, ``config/schema.py``) held to the behaviours the
JAX package pins for its copies, on the CPU.

Each section ports one JAX test file: ``test_edge_cases.py``,
``test_io_robustness.py``, ``test_native_io.py``, ``test_stream.py``,
``test_csv_sink.py`` and ``test_config.py``. Behaviours a ``test_torch_*``
test already pins are not repeated here:
* ``auto_chunk`` — ``test_torch_full_reference.py::test_auto_chunk_matches_jax``;
* ``resolve_precision`` alone — ``test_torch_full_reference.py::test_resolve_precision``;
* ``stream_batches`` against whole-clip decoding, sampling, batch sizes
  and ``start_index`` — ``test_torch_api_metrics.py::test_stream_batches_match_jax``
  (equal to the JAX package's stream, which its own tests hold to the
  whole-clip decode);
* the EWM smoothing of ``test_smoothing.py`` —
  ``test_torch_api_ops.py::test_linear_recurrence_and_ewm_match_jax``,
  ``::test_ewm_mean_axis_matches_jax`` and
  ``test_torch_ops.py::test_ewm_mean_masked_matches_jax``,
  ``::test_masked_mean_empty_is_zero``;
* a missing video through the analyzer —
  ``test_torch_pipeline.py::test_analyzer_missing_video_raises``.

The one place the port differs on purpose: ``quality_precision: "fast"``
loads (the schema is shared, so one config file drives either package) but
``resolve_precision`` refuses it, where the JAX package selects its FAST3
filters (ROADMAP.md, 'Not ported (deliberate)').
"""

import csv
import dataclasses
import json
import threading
import time
from fractions import Fraction

import numpy as np
import pytest
import torch

from rtvqa_tpu.config import Config as JaxConfig
from rtvqa_tpu.pipeline.csv_sink import CSV_COLUMNS as JAX_CSV_COLUMNS
from rtvqa_tpu_torch.config import Config, ConfigError, load_config
from rtvqa_tpu_torch.io import video as vio
from rtvqa_tpu_torch.io.stream import VideoStream, prefetch
from rtvqa_tpu_torch.metrics.complexity import calculate_average_scene_complexity
from rtvqa_tpu_torch.metrics.full_reference import analyze_full_reference, resolve_precision
from rtvqa_tpu_torch.pipeline.csv_sink import CSV_COLUMNS, read_rows, update_csv

torch.set_num_threads(1)


def tiny_clip(path, n, seed=3):
    rgb = np.random.default_rng(seed).integers(0, 256, (n, 32, 48, 3), dtype=np.uint8)
    vio.encode_raw_rgb(str(path), rgb, fps=Fraction(30, 1), crf=20)
    return str(path)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Encoded clips of 1, 2, 5 and 12 random 32x48 frames, and a 25-frame
    96x128 gradient clip for the native IO checks."""
    d = tmp_path_factory.mktemp("host")
    out = {n: tiny_clip(d / f"clip{n}.mp4", n) for n in (1, 2, 5, 12)}
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:96, 0:128]
    frames = []
    for i in range(25):
        base = ((xx * 2 + yy + i * 9) % 256).astype(np.uint8)
        f = np.stack([base, np.roll(base, i, axis=1), 255 - base], axis=-1)
        noise = rng.integers(0, 12, size=(96, 128, 3), dtype=np.uint8)
        frames.append(np.clip(f.astype(np.int16) + noise, 0, 255).astype(np.uint8))
    out["gradient"] = str(d / "gradient.mp4")
    vio.encode_raw_rgb(out["gradient"], np.stack(frames), fps=Fraction(30, 1), crf=18)
    return out


# --- degenerate clips (tests/test_edge_cases.py) ------------------------------------


@pytest.mark.parametrize("n,interval", [(1, 1), (2, 1), (5, 10)])
def test_degenerate_clip_complexity(clips, n, interval):
    """One frame: no pairs, so every pair metric is 0.0. Two frames: the
    spatial metrics are defined, temporal DCT is still empty. An interval
    longer than the clip samples no frame, and every metric is 0.0."""
    clip = vio.decode_sampled(clips[n], frame_interval=interval)
    res = calculate_average_scene_complexity(clip, 16, 16, device="cpu")
    assert clip.y.shape[0] == (n if interval == 1 else 0)
    assert res.temporal_dct == 0.0
    if n == 2:
        assert res.dct > 0.0 and res.histogram > 0.0
    else:
        assert res.motion == 0.0 and res.dct == 0.0 and res.framerate == 0.0


def test_full_reference_single_frame(clips):
    out = analyze_full_reference(clips[1], clips[1], device="cpu")
    assert out["n_frames"] == 1
    assert out["ssim"] == pytest.approx(1.0, abs=1e-6)
    assert out["per_frame"]["motion2"][0] == 0.0


# --- bad inputs (tests/test_io_robustness.py) ---------------------------------------


@pytest.mark.parametrize("content", ["garbage", "empty"])
def test_unreadable_file_raises(tmp_path, content):
    """Random bytes or an empty file: every entry point raises
    RuntimeError, none crashes."""
    p = tmp_path / f"{content}.mp4"
    p.write_bytes(np.random.default_rng(0).bytes(4096) if content == "garbage" else b"")
    with pytest.raises(RuntimeError):
        vio.decode_sampled(str(p), 1)
    with pytest.raises(RuntimeError):
        vio.get_video_info(str(p))
    with pytest.raises(RuntimeError):
        VideoStream(str(p), 1)


def test_truncated_file(clips, tmp_path):
    """A valid header and half the data: the decoder yields what it can or
    raises RuntimeError, never crashes."""
    with open(clips[12], "rb") as f:
        data = f.read()
    trunc = tmp_path / "trunc.mp4"
    trunc.write_bytes(data[: len(data) // 2])
    try:
        clip = vio.decode_sampled(str(trunc), 1)
    except RuntimeError:
        return
    assert clip.y.shape[0] <= 12


def test_transcode_garbage_raises(tmp_path):
    p = tmp_path / "garbage.mp4"
    p.write_bytes(b"\x00" * 1000)
    with pytest.raises(RuntimeError):
        vio.transcode(str(p), str(tmp_path / "out.mp4"), crf=30)


@pytest.mark.parametrize("writer", ["encode", "transcode"])
def test_write_to_missing_directory_raises(clips, tmp_path, writer):
    """A muxer that never opened must raise, not crash in its trailer."""
    out = str(tmp_path / "no_such_dir" / "out.mp4")
    with pytest.raises(RuntimeError):
        if writer == "encode":
            vio.encode_raw_rgb(out, np.zeros((2, 16, 16, 3), np.uint8), fps=Fraction(30, 1))
        else:
            vio.transcode(clips[2], out)


# --- native IO (tests/test_native_io.py) --------------------------------------------


@pytest.mark.parametrize("path,kind", [("a.mp4", "video"), ("a.MKV", "video"), ("a.png", "frame"),
                                       ("a.txt", None), (123, None)])
def test_validate_video_path(path, kind):
    if kind is None:
        with pytest.raises(ValueError):
            vio.validate_video_path(path)
    else:
        assert vio.validate_video_path(path) == kind


def test_probe_and_decode(clips):
    """Probe geometry and rate; all 25 frames ~33.3 ms apart; interval 10
    keeps frames 10 and 20 (1-based) with their own timestamps; decoder
    threads change no pixel."""
    info = vio.get_video_info(clips["gradient"])
    assert (info.width, info.height, info.resolution) == (128, 96, "128x96")
    assert info.frame_rate == pytest.approx(30.0) and info.bitrate_kbps > 0
    full = vio.decode_sampled(clips["gradient"], frame_interval=1)
    assert full.y.shape == (25, 96, 128) and full.u.shape == (25, 48, 64)
    assert full.n_frames_total == 25
    np.testing.assert_allclose(np.diff(full.timestamps_ms), 1000.0 / 30.0, atol=1.0)
    sampled = vio.decode_sampled(clips["gradient"], frame_interval=10)
    np.testing.assert_array_equal(sampled.y, full.y[[9, 19]])
    np.testing.assert_allclose(sampled.timestamps_ms, full.timestamps_ms[[9, 19]])
    threaded = vio.decode_sampled(clips["gradient"], 1, threads=4)
    np.testing.assert_array_equal(threaded.y, full.y)
    np.testing.assert_array_equal(threaded.u, full.u)


def test_decode_missing_file_raises():
    with pytest.raises(FileNotFoundError):
        vio.decode_sampled("/nonexistent/clip.mp4", 1)


# --- prefetch (tests/test_stream.py) -------------------------------------------------


def test_prefetch_propagates_errors():
    def boom():
        yield 1
        raise ValueError("decode exploded")

    it = prefetch(boom(), depth=1)
    assert next(it) == 1
    with pytest.raises(ValueError, match="decode exploded"):
        list(it)


def test_prefetch_abandonment_closes_source():
    """Closing the consumer cancels the producer, which closes its source
    (an endless one here); a second close is a no-op."""
    closed = threading.Event()

    class Source:
        def __init__(self):
            self.i = 0

        def __iter__(self):
            return self

        def __next__(self):
            if closed.is_set():
                raise StopIteration
            self.i += 1
            return self.i

        def close(self):
            closed.set()

    it = prefetch(Source(), depth=1)
    assert next(it) == 1
    it.close()
    assert closed.wait(timeout=5.0), "the producer did not close the source"
    it.close()


def test_prefetch_abandonment_closes_video_stream(clips):
    vs = VideoStream(clips["gradient"], frame_interval=1, batch=4)
    it = prefetch(vs, depth=1)
    next(it)
    it.close()
    deadline = time.monotonic() + 5.0
    while vs._handle is not None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert vs._handle is None, "the VideoStream's decoder leaked after abandonment"


# --- CSV sink (tests/test_csv_sink.py) -----------------------------------------------


def test_csv_schema_is_the_reference_15_columns():
    assert CSV_COLUMNS == JAX_CSV_COLUMNS
    assert len(CSV_COLUMNS) == 15 and CSV_COLUMNS[:7] == [
        "Bitrate (kbps)", "Resolution (px)", "Frame Rate (fps)", "CRF", "PSNR", "SSIM", "VMAF"]
    assert CSV_COLUMNS[-1] == "Framerate Variation"


def test_csv_append_writes_the_header_once(tmp_path):
    f = str(tmp_path / "out.csv")
    row = {c: i for i, c in enumerate(CSV_COLUMNS)}
    update_csv(row, f)
    update_csv(row, f)
    with open(f) as fh:
        lines = fh.read().strip().splitlines()
    assert len(lines) == 3
    assert csv.DictReader(lines).fieldnames == CSV_COLUMNS


def test_csv_missing_metrics_empty_and_extra_keys_ignored(tmp_path):
    f = str(tmp_path / "out.csv")
    update_csv({"CRF": 23, "PSNR": 50.78, "internal_debug": "x"}, f)
    rows = read_rows(f)
    assert rows[0]["CRF"] == "23" and rows[0]["PSNR"] == "50.78"
    assert rows[0]["VMAF"] == ""
    assert "internal_debug" not in rows[0]


# --- config (tests/test_config.py) ---------------------------------------------------

REFERENCE_DEFAULTS = {"crf": 23, "vmaf_model_path": None, "resize_width": 64,
                      "resize_height": 64, "frame_interval": 10}


def write_cfg(tmp_path, raw):
    p = tmp_path / "config.json"
    p.write_text(json.dumps(raw))
    return str(p)


def test_config_fields_and_defaults_equal_jax():
    port = {f.name: f.default for f in dataclasses.fields(Config)}
    assert port == {f.name: f.default for f in dataclasses.fields(JaxConfig)}


def test_reference_config_loads(tmp_path):
    cfg = load_config(write_cfg(tmp_path, REFERENCE_DEFAULTS))
    assert (cfg.crf, cfg.resize_width, cfg.frame_interval) == (23, 64, 10)
    assert cfg.smoothing_alpha == 0.8


@pytest.mark.parametrize(
    "patch",
    [
        {"crf": 0}, {"crf": 52}, {"resize_width": 0}, {"resize_height": -1},
        {"frame_interval": 0}, {"num_workers": "four"}, {"batch_size": 0},
        {"smoothing_alpha": 0.0}, {"smoothing_alpha": 1.5},
        {"quality_backend": "ffmpeg_subprocess"}, {"preset": "medum"}, {"preset": ""},
        {"streaming_complexity": "yes"}, {"streaming_complexity": 1},
        {"quality_precision": "bf16"}, {"quality_precision": True},
        {"motion_search": "farneback"}, {"motion_search": 2}, {"tpyo": 1},
    ],
)
def test_invalid_configs_rejected(tmp_path, patch):
    with pytest.raises(ConfigError):
        load_config(write_cfg(tmp_path, {**REFERENCE_DEFAULTS, **patch}))


@pytest.mark.parametrize("text", [None, "{not json"])
def test_unreadable_config_rejected(tmp_path, text):
    """A missing file and a file that is not JSON both raise ConfigError."""
    p = tmp_path / "bad.json"
    if text is not None:
        p.write_text(text)
    with pytest.raises(ConfigError):
        load_config(str(p))


def test_valid_preset_and_streaming_flags(tmp_path):
    raw = dict(REFERENCE_DEFAULTS, preset="veryfast", streaming_complexity=True, motion_search="full")
    cfg = load_config(write_cfg(tmp_path, raw))
    assert (cfg.preset, cfg.streaming_complexity, cfg.motion_search) == ("veryfast", True, "full")


@pytest.mark.parametrize("value", ["auto", "exact", "fast"])
def test_quality_precision_values(tmp_path, value):
    """All three load; "auto" and "exact" run exact f32 in the port, "fast"
    is refused when a run resolves it (the JAX package's FAST3)."""
    cfg = load_config(write_cfg(tmp_path, dict(REFERENCE_DEFAULTS, quality_precision=value)))
    assert cfg.quality_precision == value
    if value == "fast":
        with pytest.raises(NotImplementedError):
            resolve_precision(value)
    else:
        assert resolve_precision(value) is None
