"""The port's observability: ``obs/roofline.py`` against the JAX package's
byte counts and the expected H100 bounds, ``obs/profiler.py::
device_trace``, and the program's tracer (``StageTimer``, ``span``,
``clip``, ``count``) over the chunk loop on the CPU.
"""

import json
import os
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from rtvqa_tpu.obs import roofline as jax_roofline
from rtvqa_tpu_torch.io import stream
from rtvqa_tpu_torch.metrics import complexity, complexity_streaming, full_reference
from rtvqa_tpu_torch.obs import profiler, roofline
from rtvqa_tpu_torch.obs.profiler import device_trace

SIZES = [(1080, 1920), (2160, 3840)]


@pytest.mark.parametrize("phase", ["quality_roofline", "complexity_roofline"])
@pytest.mark.parametrize("h,w", SIZES)
def test_bytes_per_frame_match_the_jax_module(phase, h, w):
    """The port's phases move the same arrays as the TPU path."""
    got = getattr(roofline, phase)(h, w)
    assert got["bytes_per_frame"] == getattr(jax_roofline, phase)(h, w)["bytes_per_frame"]
    assert set(got) == {"bytes_per_frame", "ops_per_frame"}


@pytest.mark.parametrize("phase", ["quality_roofline", "complexity_roofline"])
def test_counts_scale_with_pixels(phase):
    """Bytes scale exactly 4x from 1080p to 2160x3840; operations within 1%
    of that (the ceil(h/2) rounding of the deeper scales)."""
    small, large = (getattr(roofline, phase)(h, w) for h, w in SIZES)
    assert large["bytes_per_frame"] == 4 * small["bytes_per_frame"]
    assert large["ops_per_frame"] == pytest.approx(4 * small["ops_per_frame"], rel=1e-2)


@pytest.mark.parametrize("phase,seconds", [("quality_roofline", 1e-3), ("complexity_roofline", 2e-4)])
def test_attach_measured_gives_shares(phase, seconds):
    counts = getattr(roofline, phase)(1080, 1920)
    out = roofline.attach_measured(counts, seconds)
    assert out["seconds_per_frame"] == seconds
    for key in ("pct_hbm_roofline", "pct_f32_roofline"):
        assert 0 < out[key] < 100, (key, out[key])
    assert out["pct_hbm_roofline"] == pytest.approx(
        100 * counts["bytes_per_frame"] / seconds / roofline.HBM_BYTES_PER_S, abs=0.01)


@pytest.mark.parametrize("work,ms,by", [
    (roofline.adm_input_work(64, 1080, 1920, 23), 0.0792, "bytes"),
    (roofline.strip_sum_work(16, 1080, 1920, 1), 0.0099, "bytes"),
    (roofline.strip_sum_work(16, 1080, 1920, 4), 0.0396, "bytes"),
    (roofline.strip_floor_work(128, 1088, 2176, 4), 0.3539, "bytes"),
    (roofline.strip_floor_work(128, 1088, 2176, 2), 0.1769, "bytes"),
    (roofline.strip_floor_work(128, 1088, 2176, 1), 0.0885, "bytes"),
    (roofline.adm_scale0_work(64, 1080, 1920), 0.1585, "bytes"),
    (roofline.quality_work(64, 1080, 1920, 540, 960), 0.8497, "operations"),
    (roofline.vif_scale_work(14, 2160, 4096), 0.7182, "operations"),
])
def test_kernel_bounds_on_the_h100(work, ms, by):
    """Kernels 6a, 8 and 9 at the probes' shapes, and three main-path
    kernels (3, 6, and 4 at scale 0 of a DCI-4K chunk) at the bounds PERF.md
    has carried since they were ported."""
    bound, bound_by = roofline.kernel_bound(*work)
    assert bound == pytest.approx(ms, abs=1e-4) and bound_by == by


@pytest.mark.parametrize("scale", [1, 2, 3])
def test_vif_scale_work_is_kernel_5s_per_scale(scale):
    """Kernel 4 at scales 1-3 of a 64-frame 1080p chunk (scale 1 is 540 x
    960) does kernel 5's operations at that scale: the 2^(4-s)+1-tap
    statistics and, below scale 3, the 2^(3-s)+1-tap decimation; it reads
    its f32 pair and writes the next scale's (none after scale 3). Summed
    over the three scales, the operations are kernel 5's."""
    b, shapes = 64, {1: (540, 960), 2: (270, 480), 3: (135, 240)}
    h, w = shapes[scale]
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    taps, dec = 2 ** (4 - scale) + 1, 2 ** (3 - scale) + 1
    ops = (3 + 10 * (2 * taps - 1) + 30) * h * w  # five moments, two passes; products, statistics
    if scale < 3:
        ops += 2 * (2 * dec - 1) * (h2 * w + h2 * w2)  # both images, even rows, then even columns
    planes = 2 * 4 * b * h2 * w2 if scale < 3 else 0
    assert roofline.vif_scale_work(b, h, w, 4, scale) == (2 * 4 * b * h * w + planes + 4 * b, b * ops)
    total = sum(roofline.vif_scale_work(b, *shapes[s], 4, s)[1] for s in shapes)
    assert total == roofline.vif_tail_work(b, 540, 960)[1]


def test_probe_windows_overlap_their_functions_bytes():
    """Kernel 8 reads its frames once (and writes one f32 per frame);
    kernel 9's windows are 22 windows of 56 rows over the 1064 rows they
    cover (1.373 GB in f32)."""
    assert roofline.strip_sum_work(16, 1080, 1920, 4) == (16 * 1080 * 1920 * 4 + 4 * 16, 16 * 1080 * 1920)
    covered = roofline.strip_floor_work(128, 1088, 2176, 4)[0] - 4
    assert covered == 128 * 1064 * 2176 * 4
    assert roofline.strip_floor_windows(128, 1088, 2176, 4) == 128 * 22 * 56 * 2176 * 4 == 1_372_585_984


def test_device_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with device_trace(str(log_dir), "cpu") as path:
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    assert os.path.dirname(path) == str(log_dir) and os.path.getsize(path) > 0
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)


def test_device_trace_without_a_directory_is_a_no_op(tmp_path):
    with device_trace(None) as path:
        torch.ones(4).sum()
    with device_trace("", "cpu") as empty:
        pass
    assert path is None and empty is None and list(tmp_path.iterdir()) == []


# --- the program's tracer (obs/profiler.py: StageTimer, span, clip, count) ---

CHUNK, H, W = 4, 64, 96
LOOP_SPANS = {"clip", "stage", "wait", "quality", "complexity", "fetch", "suite_build", "close", "pool"}


def planes(n: int, seed: int = 0):
    """A ref/dis pair of n 64x96 YUV420 frames: ref noise, dis = ref + small noise."""
    rng = np.random.default_rng(seed)
    ry = rng.integers(0, 256, (n, H, W), np.uint8)
    ru, rv = (rng.integers(0, 256, (n, H // 2, W // 2), np.uint8) for _ in range(2))
    dy = np.clip(ry.astype(np.int16) + rng.integers(-6, 7, ry.shape), 0, 255).astype(np.uint8)
    return (ry, ru, rv), (dy, ru, rv)


def frame_batches(side, chunk=CHUNK):
    """The side's frames in batches of ``chunk``, as ``VideoStream`` would
    hand them over (the last may be shorter)."""
    y, u, v = side
    for s in range(0, y.shape[0], chunk):
        n = min(chunk, y.shape[0] - s)
        yield stream.FrameBatch(y[s:s + n], u[s:s + n], v[s:s + n], (s + np.arange(n)) * 40.0, s)


def staged(side, chunk=CHUNK):
    """``prefetch(stage_to_device(...))`` over the side's frame batches."""
    return stream.prefetch(stream.stage_to_device(frame_batches(side, chunk), chunk, torch.device("cpu")),
                           depth=1)


def host_padded(side, chunk=CHUNK):
    """The side's frame batches with planes repeat-padded to ``chunk``
    frames on the host (``np.repeat`` of the last frame) and handed over as
    staged: the chunks the loop computed before ragged tails were padded on
    the device."""
    for fb in frame_batches(side, chunk):
        pad = chunk - fb.y.shape[0]
        yield stream.StagedFrameBatch(fb, *(torch.from_numpy(np.concatenate([a, np.repeat(a[-1:], pad, 0)]))
                                            for a in (fb.y, fb.u, fb.v)))


def run_clip(n: int, merged: bool, stage=staged):
    """One clip of ``n`` frames through ``run_pair``."""
    return run_pair(*planes(n), merged, stage)


def run_pair(ref, dis, merged: bool, stage=staged):
    """One clip through ``combined_chunk_loop`` (plain ops; the tap at
    interval 2, or the merged step at 1) and ``pool_full_reference``,
    inside one ``clip()``, each side's batches handed over by ``stage``.
    Returns (series, complexity, pooled)."""
    acc = complexity_streaming.ComplexityAccumulator(32, 32, 0.8, 4, device="cpu")
    ref_it, dis_it = stage(ref), stage(dis)
    try:
        with profiler.clip():
            series, n_frames, comp = full_reference.combined_chunk_loop(
                ref_it, dis_it, CHUNK, acc, 1 if merged else 2, "dis", None, None, torch.device("cpu"),
                "plain", merged)
            pooled = full_reference.pool_full_reference(series, n_frames)
    finally:
        ref_it.close()
        dis_it.close()
    return series, comp, pooled


@pytest.fixture
def counted_ranges(monkeypatch):
    """Every ``torch.profiler.record_function`` the tracer opens, and every
    clock read of the profiler module, counted."""
    seen = {"ranges": [], "clock": 0}
    real_rf, real_clock = torch.profiler.record_function, time.perf_counter

    def rf(name, *a, **k):
        seen["ranges"].append(name)
        return real_rf(name, *a, **k)

    def clock():
        seen["clock"] += 1
        return real_clock()

    monkeypatch.setattr(torch.profiler, "record_function", rf)
    monkeypatch.setattr(profiler, "time", types.SimpleNamespace(perf_counter=clock, time_ns=time.time_ns))
    return seen


def assert_bit_equal(want, got):
    """Two ``run_pair`` results: every series, the complexity result and
    the pooled numbers equal, bit for bit."""
    assert want[0].keys() == got[0].keys()
    for k in want[0]:
        np.testing.assert_array_equal(want[0][k], got[0][k], err_msg=k)
    assert want[1] == got[1]
    for k in ("psnr", "ssim", "vmaf"):
        assert want[2][k] == got[2][k], k


@pytest.mark.parametrize("merged", [False, True])
def test_tracing_leaves_the_results_bit_equal(merged):
    off = run_clip(11, merged)
    timer = profiler.StageTimer()
    with timer.active():
        on = run_clip(11, merged)
    assert timer.records
    assert_bit_equal(off, on)


@pytest.mark.parametrize("merged", [False, True])
@pytest.mark.parametrize("n", [8, 9, 11, 13])
def test_tails_padded_on_the_device_equal_tails_padded_on_the_host(n, merged):
    """Tails staged and repeat-padded on the device give the series,
    complexity and pooled numbers of chunks repeat-padded on the host."""
    assert_bit_equal(run_clip(n, merged, host_padded), run_clip(n, merged))


@pytest.mark.parametrize("n", [1, 3, CHUNK])
def test_a_staged_ragged_batch_is_its_frames_then_its_last_repeated(n):
    """Each of the six planes of a staged ragged batch (ref and dis) holds
    the batch's frames then copies of its last, byte for byte, in a
    ``CHUNK``-frame plane; only the frames crossed to the device. A full
    batch crosses as it is and counts no ``staged_tails``."""
    frame = H * W + 2 * (H // 2) * (W // 2)
    timer = profiler.StageTimer()
    with timer.active():
        got = [(side, *stream.stage_to_device(frame_batches(side), CHUNK, torch.device("cpu")))
               for side in planes(n)]
    for side, sb in got:
        assert sb.host.y.shape == side[0].shape and np.shares_memory(sb.host.y, side[0])  # the host batch unpadded
        for a, p in zip(side, (sb.y, sb.u, sb.v)):
            want = np.concatenate([a, np.repeat(a[-1:], CHUNK - n, 0)])
            assert p.dtype == torch.uint8 and tuple(p.shape) == want.shape
            assert p.numpy().tobytes() == want.tobytes()
    tails = {"staged_tails": 2} if n < CHUNK else {}
    assert timer.counters == {"staged_chunks": 2, **tails, "h2d_bytes": 2 * n * frame, "h2d_copies": 6}
    assert timer.span_totals()["stage"]["calls"] == 2


def test_stage_to_device_refuses_a_batch_longer_than_chunk():
    """A batch of more than ``chunk`` frames, or of none, is the caller's
    fault: ``ValueError`` before anything is uploaded or counted, also
    through ``prefetch`` to its consumer."""
    side = planes(CHUNK + 1)[0]
    empty = stream.FrameBatch(*(a[:0] for a in side), np.zeros(0), 0)
    timer = profiler.StageTimer()
    with timer.active():
        with pytest.raises(ValueError, match=f"1 to {CHUNK} frames, got {CHUNK + 1}"):
            next(stream.stage_to_device(frame_batches(side, CHUNK + 1), CHUNK, torch.device("cpu")))
        with pytest.raises(ValueError, match="got 0"):
            next(stream.stage_to_device(iter([empty]), CHUNK, torch.device("cpu")))
        with pytest.raises(ValueError, match=f"got {CHUNK + 1}"):
            list(stream.prefetch(stream.stage_to_device(frame_batches(side, CHUNK + 1), CHUNK,
                                                        torch.device("cpu"))))
    assert timer.counters == {} and "stage" not in timer.span_totals()


@pytest.mark.parametrize("merged", [False, True])
def test_unequal_streams_give_the_common_prefix(merged):
    """ref 13 frames, dis 11: the loop stops at the common prefix, padding
    the ref's third chunk again from its third frame, and gives what the
    11-frame pair gives; the caller's host frames stay as they were."""
    ref, dis = planes(13)
    dis = tuple(a[:11] for a in dis)
    kept = tuple(a.copy() for a in ref)
    timer = profiler.StageTimer()
    with timer.active():
        got = run_pair(ref, dis, merged)
    assert_bit_equal(run_pair(tuple(a[:11] for a in ref), dis, merged), got)
    assert len(got[0]["psnr_y"]) == 11
    assert timer.span_totals()["pad"]["calls"] == 1 and timer.counters["padded_frames"] == 1
    for a, b in zip(ref, kept):
        np.testing.assert_array_equal(a, b)


def test_with_no_active_tracer_a_span_site_does_nothing(counted_ranges, tmp_path):
    """Off, even under a running profiler: no record, no range, no clock
    read; every span site hands back one shared no-op context."""
    timer = profiler.StageTimer()
    with device_trace(str(tmp_path), "cpu") as path:
        run_clip(11, merged=False)
    assert counted_ranges == {"ranges": [], "clock": 0}
    assert timer.records == [] and timer.counters == {}
    assert profiler.span("quality") is profiler.clip() is profiler.span("fetch")
    profiler.count("h2d_bytes", 5)
    with open(path) as f:
        assert not [e for e in json.load(f)["traceEvents"] if str(e.get("name", "")).startswith("rtvqa.")]


@pytest.mark.parametrize("merged", [False, True])
def test_spans_of_one_clip_nest_under_it(merged):
    timer = profiler.StageTimer()
    with timer.active():
        run_clip(11, merged)
    recs = timer.records
    names = {r.name for r in recs}
    assert names == LOOP_SPANS | ({"complexity"} if merged else {"tap"})
    main = threading.main_thread().ident
    assert {r.thread for r in recs if r.name == "stage"} and all(
        r.thread != main for r in recs if r.name == "stage")
    assert all(r.thread == main for r in recs if r.name != "stage")
    (root,) = [r for r in recs if r.name == "clip"]
    assert root.parent is None and {r.clip for r in recs} == {root.id}
    by_id = {r.id: r for r in recs}
    for r in recs:
        if r is not root:
            p = by_id[r.parent]
            assert p.start <= r.start <= r.end <= p.end, (r, p)
    # The producers started inside the clip: their spans are its children.
    assert {r.parent for r in recs if r.name == "stage"} == {root.id}
    sums = timer.span_totals()
    # 11 frames at CHUNK 4: each producer stages 2 chunks and the tail (padded on the device, in
    # ``stage``); the main thread pads nothing.
    assert sums["fetch"]["calls"] == 3 and "pad" not in sums and sums["stage"]["calls"] == 6
    assert timer.counters["staged_chunks"] == 6 and timer.counters["staged_tails"] == 2


@pytest.mark.parametrize("n", [8, 9, 11, 13])
def test_padded_frames_count_the_ragged_tail(n):
    timer = profiler.StageTimer()
    with timer.active():
        series, _, _ = run_clip(n, merged=False)
    assert len(series["psnr_y"]) == n
    pad = -n % CHUNK
    assert timer.counters.get("padded_frames", 0) == pad
    # The producers stage the tail too and pad it on the device: no ``pad`` span on the main thread.
    assert timer.counters["staged_chunks"] == 2 * -(-n // CHUNK)
    assert timer.counters.get("staged_tails", 0) == (2 if pad else 0)
    assert "pad" not in timer.span_totals()


@pytest.mark.parametrize("merged", [False, True])
def test_h2d_bytes_are_the_uploaded_planes_and_the_suite_tables(merged):
    n = 11
    timer = profiler.StageTimer()
    with timer.active():
        run_clip(n, merged)
    frame = H * W + 2 * (H // 2) * (W // 2)
    full, tail = n // CHUNK, n % CHUNK
    planes_bytes = 2 * (full * CHUNK + tail) * frame  # a tail's frames only: its padding is made on the device
    copies = 2 * 3 * full + (6 if tail else 0)
    if not merged:  # the tap re-uploads its sampled frames (interval 2: frames 1, 3, 5, ...) at each flush
        sampled = n // 2
        flushes = -(-sampled // 4)
        planes_bytes += sampled * frame
        copies += 3 * flushes
    suite = complexity.ComplexitySuite(H, W, 32, 32)
    tables = list(suite.buffers())
    assert timer.counters["suite_builds"] == 1
    assert timer.counters["h2d_bytes"] == planes_bytes + sum(t.nbytes for t in tables)
    assert timer.counters["h2d_copies"] == copies + len(tables)


def test_rtvqa_ranges_reach_the_chrome_trace(counted_ranges, tmp_path):
    """On, under ``device_trace``: the main thread's spans are ``rtvqa.*``
    ranges of the trace; the producer thread is not profiled there, its
    spans are in the tracer's own records."""
    timer = profiler.StageTimer()
    with timer.active(), device_trace(str(tmp_path), "cpu") as path:
        run_clip(11, merged=True)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = {e["name"] for e in events if str(e.get("name", "")).startswith("rtvqa.")}
    assert ranges >= {f"rtvqa.{n}" for n in LOOP_SPANS - {"stage"}}
    assert set(counted_ranges["ranges"]) == ranges
    out = tmp_path / "spans.json"
    timer.write(str(out))
    with open(out) as f:
        written = json.load(f)
    assert len(written["traceEvents"]) == len(timer.records)
    assert {e["name"] for e in written["traceEvents"]} == {f"rtvqa.{n}" for n in LOOP_SPANS}
    assert written["counters"] == timer.counters


def test_clip_inside_a_clip_and_nested_activation():
    outer, inner = profiler.StageTimer(), profiler.StageTimer()
    with outer.active():
        with profiler.clip():
            with profiler.clip():
                with profiler.span("quality"):
                    pass
        with inner.active():
            profiler.count("h2d_bytes", 3)
        profiler.count("h2d_bytes", 4)
    profiler.count("h2d_bytes", 5)
    assert [r.name for r in outer.records] == ["quality", "clip"]
    assert outer.records[0].parent == outer.records[0].clip == outer.records[1].id
    assert inner.counters == {"h2d_bytes": 3} and outer.counters == {"h2d_bytes": 4}
    outer.reset()
    assert outer.records == [] and outer.counters == {}


def test_counters_lose_no_update_across_threads():
    """Sixteen threads counting at once, with a short switch interval."""
    timer, per = profiler.StageTimer(), 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with timer.active():
            threads = [threading.Thread(target=lambda: [profiler.count("n") for _ in range(per)])
                       for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert timer.counters["n"] == 16 * per


def test_frames_per_sec_is_over_the_wall_clock_of_the_stages(monkeypatch):
    """Nested stages: 10 frames over a 2 s window (0 to 2), not over the 3 s
    the stage times sum to."""
    ticks = iter([0.0, 0.5, 1.5, 2.0])
    monkeypatch.setattr(profiler, "time", types.SimpleNamespace(perf_counter=lambda: next(ticks)))
    timer = profiler.StageTimer()
    with timer.stage("quality+complexity"):
        with timer.stage("quality"):
            pass
    timer.add_frames(10)
    s = timer.summary()
    assert s["total_seconds"] == 3.0
    assert s["frames_per_sec"] == 5.0
    assert "spans" not in s


def test_active_stages_are_spans_but_not_span_totals():
    timer = profiler.StageTimer()
    with timer.active(), timer.stage("quality"):
        with profiler.span("quality"):
            profiler.count("padded_frames", 2)
    s = timer.summary()
    assert s["stages"]["quality"]["calls"] == 1
    assert s["spans"] == {"quality": {"seconds": pytest.approx(s["spans"]["quality"]["seconds"]), "calls": 1}}
    assert s["counters"] == {"padded_frames": 2}
    stage_rec, = [r for r in timer.records if r.stage]
    assert [r.parent for r in timer.records if not r.stage] == [stage_rec.id]


def run_kernel_route(width: int, merged: bool, n: int = 6):
    """One clip of ``n`` 40 x ``width`` frames through ``combined_chunk_loop``
    on the kernels' route (their plain versions on the CPU) at CHUNK: the
    tap at interval 2, or the merged step at 1. Returns (series, complexity)."""
    rng = np.random.default_rng(width)
    ry = rng.integers(0, 256, (n, 40, width), np.uint8)
    ru, rv = (rng.integers(0, 256, (n, 20, width // 2), np.uint8) for _ in range(2))
    dy = np.clip(ry.astype(np.int16) + rng.integers(-6, 7, ry.shape), 0, 255).astype(np.uint8)
    acc = complexity_streaming.ComplexityAccumulator(32, 32, 0.8, 4, device="cpu")
    ref_it, dis_it = staged((ry, ru, rv)), staged((dy, ru, rv))
    try:
        series, _, comp = full_reference.combined_chunk_loop(
            ref_it, dis_it, CHUNK, acc, 1 if merged else 2, "dis", None, None, torch.device("cpu"),
            "kernel", merged)
    finally:
        ref_it.close()
        dis_it.close()
    return series, comp


@pytest.mark.parametrize("width,merged", [(3856, False), (3856, True), (3840, True)])
def test_quality_is_the_only_span_inside_a_chunk_at_every_width(width, merged):
    """On either side of ``FUSED_MAX_WIDTH`` (the JAX package's TPU width
    gate) the kernels' body opens no span of its own: each chunk's
    ``quality`` has no child, and nothing is counted beyond staging,
    padding and the suite's build. The series are bit-equal with the
    tracer off and on."""
    off = run_kernel_route(width, merged)
    timer = profiler.StageTimer()
    with timer.active():
        on = run_kernel_route(width, merged)
    for k in off[0]:
        np.testing.assert_array_equal(off[0][k], on[0][k], err_msg=k)
    assert off[1] == on[1]
    quality = {r.id for r in timer.records if r.name == "quality"}
    assert len(quality) == 2  # 6 frames at CHUNK 4: a chunk and a padded tail
    assert [r for r in timer.records if r.parent in quality] == []
    assert set(timer.counters) == {"staged_chunks", "staged_tails", "h2d_bytes", "h2d_copies", "padded_frames",
                                   "suite_builds"}
