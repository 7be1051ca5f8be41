"""CPU tests of the benchmark's harness: traffic, metric arithmetic, the
frozen roofline, discovery by name, the trace summary, the import rules
and the exits without a card.

    python -m pytest benchmark/tests
"""

from __future__ import annotations

import ast
import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.harness import bench, profile, roofline, traffic
from benchmark.harness.bench import Run
from benchmark.harness.spec import metric_reader

from bench_toy import BENCH, ROOT, make_cell

SHOTS = json.loads((BENCH / "traffic" / "shots.json").read_text())
LONGFORM = json.loads((BENCH / "traffic" / "longform.json").read_text())


def take(it, n):
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 5])
def test_traffic_is_deterministic_per_seed(seed):
    a = take(traffic.clips(SHOTS, seed, 384), 300)
    b = take(traffic.clips(SHOTS, seed, 384), 300)
    assert a == b
    assert a != take(traffic.clips(SHOTS, seed + 1, 384), 300)
    assert all(0 <= c.offset < 384 for c in a)
    aligned = take(traffic.clips(SHOTS, seed, 384, 64), 300)
    assert [c.frames for c in aligned] == [c.frames for c in a]
    assert all(c.offset % 64 == 0 and c.offset < 384 for c in aligned)


def test_every_seed_deals_the_same_lengths():
    """Each deal of the deck is the same set of lengths in another order."""
    d = sorted(traffic.deck(SHOTS))
    for seed in (1, 2, 3):
        clips = take(traffic.clips(SHOTS, seed, 384), 3 * len(d))
        for k in range(3):
            assert sorted(c.frames for c in clips[k * len(d):(k + 1) * len(d)]) == d


def test_shots_lengths_have_the_stated_median_and_range():
    d = traffic.deck(SHOTS)
    assert len(d) == 48
    assert 96 <= np.median(d) <= 98                  # quantiles 23.5/48 and 24.5/48 about the median 96
    assert d.min() == 24 and d.max() <= 720
    assert d.max() == 610                            # the quantile 47.5/48: 96 * exp(0.8 * 2.31)
    assert 340 <= np.percentile(np.repeat(d, 10), 95) <= 380    # the lognormal's p95: 358
    assert list(traffic.deck(LONGFORM)) == [1440]


def test_the_warm_up_takes_one_clip_an_octave_cut_to_cover():
    d = traffic.deck(SHOTS)
    warm = [c.frames for c in traffic.warmup_clips(SHOTS, 1344)]
    assert warm == [610, 426, 251, 127, 63, 30]
    assert {n.bit_length() for n in warm} == {int(n).bit_length() for n in d}
    assert all(max(n for n in d if int(n).bit_length() == w.bit_length()) == w for w in warm)
    assert [c.frames for c in traffic.warmup_clips(LONGFORM, 144)] == [144]
    assert [c.frames for c in traffic.warmup_clips(SHOTS, 200)] == [200, 127, 63, 30]


def answers(seconds, frames):
    return [types.SimpleNamespace(seconds=s, clip=types.SimpleNamespace(frames=f))
            for s, f in zip(seconds, frames)]


def test_rate_is_over_the_whole_window():
    run = Run(answers([0.5, 1.0, 0.5], [100, 300, 100]), 2.5, 1.0, 2**30, 64, 96, None)
    assert metric_reader("frames_per_s")(run) == pytest.approx(500 / 2.5)
    assert metric_reader("peak_gib")(run) == 1.0
    assert metric_reader("setup_s")(run) == 1.0


def test_p95_is_over_all_clips():
    secs = list(np.linspace(0.1, 2.0, 200))
    run = Run(answers(secs, [10] * 200), 30.0, 1.0, 1, 64, 96, None)
    assert metric_reader("clip_s_p95")(run) == pytest.approx(np.percentile(secs, 95))
    assert metric_reader("clip_s_p95")(run) > 1.85


def test_per_layer_readers():
    trace = {"frames": 1000, "clips": 10, "chunks": 20, "h2d_bytes": 6_220_800_000,
             "staging_wait_s": 0.2, "complexity_s": 1.0, "pool_s": 0.05, "stretch_frames": 200,
             "device": {"busy_s": 0.75, "window_s": 3.0, "quality_s": 0.8}}
    run = Run([], 40.0, 1.0, 1, 1080, 1920, trace)
    assert metric_reader("staging_wait_ms")(run) == pytest.approx(10.0)
    assert metric_reader("h2d_bytes_per_frame")(run) == pytest.approx(6_220_800)
    assert metric_reader("quality_ms_per_frame")(run) == pytest.approx(4.0)      # 0.8 s over 200 frames
    assert metric_reader("complexity_ms_per_frame")(run) == pytest.approx(1.0)
    assert metric_reader("pool_ms_per_clip")(run) == pytest.approx(5.0)
    assert metric_reader("device_idle_pct")(run) == pytest.approx(75.0)
    least = roofline.bound_seconds(roofline.quality_roofline(1080, 1920))
    assert metric_reader("quality_roofline_pct")(run) == pytest.approx(100 * least / 4e-3)
    empty = Run([], 40.0, 1.0, 1, 1080, 1920, None)
    for name in ("staging_wait_ms", "quality_roofline_pct", "device_idle_pct", "pool_ms_per_clip"):
        assert metric_reader(name)(empty) is None


@pytest.mark.parametrize("name", ["staging_wait_ms", "h2d_bytes_per_frame", "quality_ms_per_frame",
                                  "complexity_ms_per_frame", "quality_roofline_pct", "device_idle_pct"])
def test_shots_readers_read_as_their_base(name):
    trace = {"frames": 1000, "clips": 10, "chunks": 20, "h2d_bytes": 6_220_800_000,
             "staging_wait_s": 0.2, "complexity_s": 1.0, "pool_s": 0.05, "stretch_frames": 200,
             "device": {"busy_s": 0.75, "window_s": 3.0, "quality_s": 0.8}}
    run = Run([], 40.0, 1.0, 1, 1080, 1920, trace)
    assert metric_reader(f"{name}.shots")(run) == metric_reader(name)(run) is not None
    assert metric_reader(f"{name}.shots")(Run([], 40.0, 1.0, 1, 1080, 1920, None)) is None


def test_shots_rate_is_over_the_traced_window_alone():
    """The stretch's clips are in ``answers`` but not in the window."""
    stretch = [types.SimpleNamespace(clip=traffic.Clip(300, 0), seconds=1.0)]
    run = Run(stretch, 2.5, 1.0, 1, 1080, 1920, {"frames": 500})
    assert metric_reader("frames_per_s.shots")(run) == pytest.approx(500 / 2.5)
    assert metric_reader("frames_per_s.shots")(Run(stretch, 2.5, 1.0, 1, 1080, 1920, None)) is None


def test_every_metric_of_the_benchmark_has_its_reader():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(metric_reader(m["name"])), m["name"]


@pytest.mark.parametrize("hw", [(1080, 1920), (2160, 3840), (64, 96), (2160, 4096)])
def test_frozen_roofline_equals_the_programs(hw):
    from rtvqa_tpu_torch.obs import roofline as program_roofline

    assert roofline.quality_roofline(*hw) == program_roofline.quality_roofline(*hw)


def launch(ts, tid, corr):
    return {"ph": "X", "name": "cudaLaunchKernel", "ts": ts, "dur": 1, "tid": tid, "cat": "cuda_runtime",
            "args": {"correlation": corr}}


def test_trace_summary_unions_device_time_and_names_gaps():
    ev = [
        {"ph": "X", "name": "bench.stretch", "ts": 0, "dur": 100, "tid": 1, "cat": "user_annotation"},
        {"ph": "X", "name": "bench.quality", "ts": 2, "dur": 6, "tid": 1, "cat": "user_annotation"},
        {"ph": "X", "name": "bench.pool", "ts": 60, "dur": 30, "tid": 1, "cat": "user_annotation"},
        {"ph": "X", "name": "bench.upload", "ts": 5, "dur": 2, "tid": 2, "cat": "user_annotation"},
        launch(3, 1, 11), launch(6, 2, 12), launch(7, 1, 13), launch(9, 1, 14),
        {"ph": "X", "name": "k1", "ts": 10, "dur": 20, "cat": "kernel", "args": {"correlation": 11}},
        {"ph": "X", "name": "Memcpy HtoD", "ts": 30, "dur": 5, "cat": "gpu_memcpy", "args": {"correlation": 12}},
        {"ph": "X", "name": "k2", "ts": 20, "dur": 20, "cat": "kernel", "args": {"correlation": 13}},
        {"ph": "X", "name": "k3", "ts": 50, "dur": 5, "cat": "kernel", "args": {"correlation": 14}},
        {"ph": "X", "name": "Memcpy HtoD", "ts": 95, "dur": 10, "cat": "gpu_memcpy"},
    ]
    s = profile.summarize(ev)
    assert s["busy_s"] == pytest.approx(40e-6)      # [10, 40], [50, 55] and [95, 100]
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["device_ops"][0] == ["k1", pytest.approx(20e-6)]
    assert s["idle_gaps"][0] == ["pool", pytest.approx(40e-6)]
    assert ["loop", pytest.approx(10e-6)] in s["idle_gaps"]
    # The quality step: k1 and k2, launched by the main thread inside its
    # range; not the copy another thread launched meanwhile, nor k3.
    assert s["quality_s"] == pytest.approx(30e-6)
    assert s["quality_launches"] == 2
    assert profile.summarize(ev[1:]) is None


def test_a_new_cell_mix_and_metric_are_found_by_name(tmp_path):
    """A configuration, a mix, limits and a metric reader added as files,
    with entries in their BENCHMARK.json, run with no edit to the harness."""
    cell = make_cell(tmp_path, extra_metrics={"toy_clips": "def read(run):\n    return len(run.answers)\n"})
    out = bench.run(cell, 2**33 + 1, 1.0, False, torch.device("cpu"), 0.0)
    assert out["metrics"]["toy_clips"]["value"] == out["attempted"] >= 1
    assert set(out["metrics"]) >= {"frames_per_s", "clip_s_p95", "setup_s", "toy_clips"}
    assert out["correct"] is True
    assert list(out)[-1] == "checks"


def imports_of(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {n.split(".")[0] for n in imports_of(path)}
        assert not tops & {"jax", "jaxlib", "flax", "rtvqa_tpu"}, path


def test_the_reference_imports_nothing_of_the_program():
    for path in [*(BENCH / "reference").rglob("*.py"), BENCH / "control.py"]:
        tops = {n.split(".")[0] for n in imports_of(path)}
        assert "rtvqa_tpu_torch" not in tops, path
        assert tops <= {"__future__", "contextlib", "functools", "math", "numpy", "torch", "argparse",
                        "json", "sys", "pathlib", "benchmark"}, (path, tops)
    for path in (BENCH / "harness").rglob("*.py"):
        if path.name != "entry.py":
            assert not any(n.startswith("rtvqa_tpu_torch") for n in imports_of(path)), path


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "rtvqa_tpu_torch_extra", types.ModuleType("x"))
    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "rtvqa_tpu.metrics", types.ModuleType("x"))
    assert bench.forbidden_modules() == ["rtvqa_tpu"]


def test_without_a_card_the_run_exits_non_zero_and_prints_no_result():
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "hd1080_default.shots",
                           "--seed", "3", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
