"""The port's CLI, analyzer and sweep vs the JAX package's on the same
encoded clip, plus the routes the port still refuses, the device rule (the
card unless the CPU is asked for) and proof that it never imports jax or
the JAX package.

The CSV rows must agree column by column: the identity columns exactly, the
complexity columns within the suite tolerances (rel 1e-4; motion rel 5e-3,
docs/PARITY.md motion row), the quality cells empty in both on the
``"none"`` route and within rel 1e-4 on the ``"native"`` routes (VMAF from
the builtin model, as ``allow_builtin_vmaf`` asks). The edge column
is an integer count of per-pixel decisions on f32 gray: inside its fused
program XLA contracts the gray conversion into FMAs (on this clip 8.5k of
the 37k sampled gray pixels move by <= 3e-5), which flips a few edge pixels
in ~1750. The port equals the unfused JAX ops bitwise, so edge gets the same
integer-decision bound as motion, rel 5e-3.
"""

import json
import os
import pathlib
import subprocess
import sys
from fractions import Fraction

import numpy as np
import pytest
import torch

from rtvqa_tpu.io import video as vio
from rtvqa_tpu.config import Config as JaxConfig
from rtvqa_tpu.pipeline.csv_sink import CSV_COLUMNS, read_rows
from rtvqa_tpu_torch.config import Config

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
QUALITY_COLUMNS = ("PSNR", "SSIM", "VMAF")
IDENTITY_COLUMNS = ("Bitrate (kbps)", "Resolution (px)", "Frame Rate (fps)", "CRF")


def make_clip(path, n=18, h=64, w=96, seed=11):
    rng = np.random.default_rng(seed)
    tex = rng.integers(0, 256, (h + 48, w + 48, 3))
    frames = np.stack(
        [np.roll(np.roll(tex, 2 * i, 0), -i, 1)[:h, :w] for i in range(n)]
    ).astype(np.uint8)
    vio.encode_raw_rgb(path, frames, fps=Fraction(30, 1), crf=18)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_e2e")
    clip = str(d / "clip.mp4")
    make_clip(clip)
    cfg = {"crf": 20, "resize_width": 32, "resize_height": 32, "frame_interval": 3,
           "quality_backend": "none"}
    native = {"quality_backend": "native", "streaming_complexity": False,
              "allow_builtin_vmaf": True}
    paths = {}
    for name, extra in (("jax", {}), ("torch", {}), ("jax_native", native),
                        ("torch_native", native)):
        paths[name] = str(d / f"{name}.csv")
        with open(d / f"{name}.json", "w") as f:
            json.dump({**cfg, **extra, "csv_file": paths[name]}, f)
    return {"clip": clip, "dir": d, "csv": paths}


def _compare_rows(jrow, trow, quality=False):
    assert list(trow) == CSV_COLUMNS
    for col in QUALITY_COLUMNS:
        if quality:
            assert jrow[col] != "", col
            assert float(trow[col]) == pytest.approx(float(jrow[col]), rel=1e-4), col
        else:
            assert trow[col] == jrow[col] == "", col
    for col in IDENTITY_COLUMNS:
        assert trow[col] == jrow[col], col
    decision_counts = ("Advanced Motion Complexity", "Edge Detection Complexity")
    for col in CSV_COLUMNS[7:]:
        tol = 5e-3 if col in decision_counts else 1e-4
        assert float(trow[col]) == pytest.approx(float(jrow[col]), rel=tol, abs=1e-6), col
    assert float(trow["Advanced Motion Complexity"]) > 0


def test_cli_row_matches_jax_cli(env):
    from rtvqa_tpu.cli import main as jax_main
    from rtvqa_tpu_torch.cli import main as torch_main

    d = env["dir"]
    assert jax_main([str(d / "jax.json"), env["clip"]]) == 0
    assert torch_main([str(d / "torch.json"), env["clip"], "--device", "cpu"]) == 0
    (jrow,), (trow,) = read_rows(env["csv"]["jax"]), read_rows(env["csv"]["torch"])
    _compare_rows(jrow, trow)


def test_cli_native_row_matches_jax_cli(env):
    """``"quality_backend": "native"`` with ``"streaming_complexity": false``:
    PSNR/SSIM/VMAF over every frame, then the complexity pass."""
    from rtvqa_tpu.cli import main as jax_main
    from rtvqa_tpu_torch.cli import main as torch_main

    d = env["dir"]
    assert jax_main([str(d / "jax_native.json"), env["clip"]]) == 0
    assert torch_main([str(d / "torch_native.json"), env["clip"], "--device", "cpu"]) == 0
    (jrow,), (trow,) = read_rows(env["csv"]["jax_native"]), read_rows(env["csv"]["torch_native"])
    assert 20 < float(trow["PSNR"]) < 60 and 0.5 < float(trow["SSIM"]) <= 1.0
    _compare_rows(jrow, trow, quality=True)


def test_cli_json_line(env, capsys):
    from rtvqa_tpu_torch.cli import main as torch_main

    assert torch_main([str(env["dir"] / "torch.json"), env["clip"], "--json", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"metrics", "profile"}
    assert {"encode", "decode", "complexity"} <= set(out["profile"]["stages"])


def test_cli_trace_and_json_carry_the_programs_spans(env, tmp_path, capsys):
    """On the default route (``analyze_combined``), ``--trace DIR --json``
    make the run's timer the tracer: ``"profile"`` carries each span name's
    seconds and calls and the counters, the profiler's trace has the main
    thread's ``rtvqa.*`` ranges, and DIR has every thread's span records."""
    from rtvqa_tpu_torch.cli import main as torch_main

    cfg = {"crf": 20, "resize_width": 32, "resize_height": 32, "frame_interval": 3,
           "allow_builtin_vmaf": True, "csv_file": str(tmp_path / "default.csv")}
    with open(tmp_path / "default.json", "w") as f:
        json.dump(cfg, f)
    trace_dir = tmp_path / "trace"
    argv = [str(tmp_path / "default.json"), env["clip"], "--trace", str(trace_dir), "--json", "--device", "cpu"]
    assert torch_main(argv) == 0
    prof = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["profile"]
    # 18 frames, one chunk of 128: each producer stages the 18 frames and pads them to 128 on the
    # device, in ``stage``; the main thread pads nothing, so there is no ``pad`` span.
    assert set(prof["spans"]) == {"clip", "stage", "wait", "quality", "tap", "complexity", "fetch", "suite_build",
                                  "close", "pool"}
    assert prof["counters"]["padded_frames"] == 128 - 18
    assert prof["counters"]["staged_chunks"] == 2 and prof["counters"]["staged_tails"] == 2
    assert prof["spans"]["stage"]["calls"] == 2
    assert prof["spans"]["clip"]["calls"] == 1 and prof["counters"]["suite_builds"] == 1
    assert prof["counters"]["h2d_bytes"] > 0
    assert "quality+complexity" in prof["stages"] and "quality+complexity" not in prof["spans"]
    (spans_file,) = trace_dir.glob("rtvqa_spans.*.json")
    (chrome,) = trace_dir.glob("rtvqa_torch.*.pt.trace.json")
    with open(spans_file) as f:
        records = json.load(f)["traceEvents"]
    assert {e["name"] for e in records} >= {"rtvqa.clip", "rtvqa.stage", "rtvqa.quality+complexity"}
    with open(chrome) as f:
        ranges = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"rtvqa.clip", "rtvqa.quality", "rtvqa.fetch", "rtvqa.encode"} <= ranges


@pytest.mark.parametrize("flag", [["--sweep"], ["--sweep", "18", "28"], ["--sweep", "30", "--sharded"],
                                  ["--trace", "t"]])
def test_cli_refuses_unported_modes(env, tmp_path, capsys, flag):
    """Every CLI mode runs on the port (the name stays from when some were
    refused). ``--trace DIR`` writes a non-empty trace directory and the
    same CSV row as the run without it. ``--sweep`` runs the CRF ladder
    (the default one when bare): its rows and manifest equal
    ``rtvqa_tpu.pipeline.sweep.run_sweep``'s, and a rerun skips every item.
    ``--sweep --sharded`` runs the device-parallel sweep in a world of one
    (gloo on the CPU): its rows and manifest equal the port's ``run_sweep``'s,
    and it leaves no process group behind."""
    import torch.distributed as dist

    from rtvqa_tpu.pipeline.sweep import DEFAULT_CRF_LADDER, run_sweep
    from rtvqa_tpu_torch.cli import main as torch_main

    if "--sharded" in flag:
        from rtvqa_tpu_torch.pipeline.sweep import run_sweep as torch_run_sweep

        cfg = {"resize_width": 32, "resize_height": 32, "frame_interval": 3,
               "allow_builtin_vmaf": True, "preset": "ultrafast"}
        t_csv, s_csv = str(tmp_path / "sharded.csv"), str(tmp_path / "seq.csv")
        with open(tmp_path / "sharded.json", "w") as f:
            json.dump({**cfg, "csv_file": s_csv}, f)
        argv = [str(tmp_path / "sharded.json"), env["clip"], *flag, "--device", "cpu", "--json"]
        assert torch_main(argv) == 0
        assert not dist.is_initialized()
        stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["metrics"]
        assert stats == {"done": 1, "failed": 0, "skipped": 0}
        assert torch_run_sweep([env["clip"]], Config(**cfg, csv_file=t_csv), crf_ladder=[30],
                               device="cpu") == stats
        (srow,), (trow,) = read_rows(s_csv), read_rows(t_csv)
        assert srow.keys() == trow.keys() and srow["VMAF"] != ""
        for col, val in trow.items():
            if col in IDENTITY_COLUMNS:
                assert srow[col] == val, col
            else:
                assert float(srow[col]) == pytest.approx(float(val), rel=2e-3, abs=1e-5), col
        with open(s_csv + ".manifest.jsonl") as f, open(t_csv + ".manifest.jsonl") as g:
            assert f.read() == g.read()
        return
    if flag[0] == "--trace":
        trace_dir = tmp_path / flag[1]
        rows = {}
        for name, extra in (("traced", [*flag[:1], str(trace_dir)]), ("plain", [])):
            cfg = {"crf": 20, "resize_width": 32, "resize_height": 32, "frame_interval": 3,
                   "quality_backend": "none", "csv_file": str(tmp_path / f"{name}.csv")}
            with open(tmp_path / f"{name}.json", "w") as f:
                json.dump(cfg, f)
            assert torch_main([str(tmp_path / f"{name}.json"), env["clip"], *extra, "--device", "cpu"]) == 0
            (rows[name],) = read_rows(cfg["csv_file"])
        assert rows["traced"] == rows["plain"]
        found = [f for _, _, fs in os.walk(trace_dir) for f in fs]
        assert found and all(os.path.getsize(trace_dir / f) > 0 for f in found)
        with open(trace_dir / found[0]) as f:
            assert json.load(f)["traceEvents"]
        return
    ladder = tuple(int(c) for c in flag[1:]) or DEFAULT_CRF_LADDER
    cfg = {"resize_width": 32, "resize_height": 32, "frame_interval": 3, "quality_backend": "none",
           "preset": "ultrafast"}
    t_csv, j_csv = str(tmp_path / "torch.csv"), str(tmp_path / "jax.csv")
    with open(tmp_path / "sweep.json", "w") as f:
        json.dump({**cfg, "csv_file": t_csv}, f)
    argv = [str(tmp_path / "sweep.json"), env["clip"], *flag, "--device", "cpu", "--json"]
    assert torch_main(argv) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["metrics"]
    assert stats == run_sweep([env["clip"]], JaxConfig(**cfg, csv_file=j_csv), crf_ladder=ladder)
    assert stats == {"done": len(ladder), "failed": 0, "skipped": 0}
    trows, jrows = read_rows(t_csv), read_rows(j_csv)
    assert [r["CRF"] for r in trows] == [str(c) for c in ladder]
    for jrow, trow in zip(jrows, trows, strict=True):
        _compare_rows(jrow, trow)

    def manifest(path):
        with open(path + ".manifest.jsonl") as f:
            return [json.loads(line) for line in f]

    assert manifest(t_csv) == manifest(j_csv)
    assert torch_main(argv) == 0  # resume: every item is done already
    rerun = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["metrics"]
    assert rerun == {"done": 0, "failed": 0, "skipped": len(ladder)}
    assert len(read_rows(t_csv)) == len(ladder) and manifest(t_csv) == manifest(j_csv)


@pytest.mark.parametrize(
    "overrides",
    [
        {},  # the default config: the combined engine
        {"quality_backend": "native", "streaming_complexity": True},  # combined
        {"quality_backend": "none", "streaming_complexity": True},  # streaming pass
        {"quality_backend": "none", "streaming_complexity": True, "analyze_original": True},
    ],
)
def test_analyzer_refuses_unported_routes_before_encoding(env, tmp_path, overrides):
    """Every analyzer route runs on the port: for each of these configs the
    port's CSV row equals the JAX analyzer's."""
    from rtvqa_tpu.pipeline import analyzer as janalyzer
    from rtvqa_tpu_torch.pipeline import analyzer

    base = {"crf": 20, "resize_width": 32, "resize_height": 32, "frame_interval": 3,
            "allow_builtin_vmaf": True, "preset": "ultrafast", **overrides}
    t_csv, j_csv = str(tmp_path / "torch.csv"), str(tmp_path / "jax.csv")
    janalyzer.process_video_and_extract_metrics(env["clip"], JaxConfig(**base, csv_file=j_csv))
    analyzer.process_video_and_extract_metrics(env["clip"], Config(**base, csv_file=t_csv), device="cpu")
    (jrow,), (trow,) = read_rows(j_csv), read_rows(t_csv)
    _compare_rows(jrow, trow, quality=base.get("quality_backend", "native") == "native")


def test_analyzer_refuses_auto_streaming_on_large_files(env, tmp_path, monkeypatch):
    """Auto streaming (``streaming_complexity`` null on a file over the
    threshold) takes the streaming pass, whose row equals the JAX
    analyzer's streaming row."""
    from rtvqa_tpu.pipeline import analyzer as janalyzer
    from rtvqa_tpu_torch.pipeline import analyzer

    calls = []
    real = analyzer.calculate_average_scene_complexity_streaming
    monkeypatch.setattr(analyzer, "STREAMING_AUTO_BYTES", 16)
    monkeypatch.setattr(analyzer, "calculate_average_scene_complexity_streaming",
                        lambda *a, **k: calls.append(a[0]) or real(*a, **k))
    base = {"crf": 20, "resize_width": 32, "resize_height": 32, "frame_interval": 3,
            "quality_backend": "none", "preset": "ultrafast"}
    t_csv, j_csv = str(tmp_path / "torch.csv"), str(tmp_path / "jax.csv")
    analyzer.process_video_and_extract_metrics(env["clip"], Config(**base, csv_file=t_csv), device="cpu")
    assert len(calls) == 1
    janalyzer.process_video_and_extract_metrics(
        env["clip"], JaxConfig(**base, streaming_complexity=True, csv_file=j_csv))
    (jrow,), (trow,) = read_rows(j_csv), read_rows(t_csv)
    _compare_rows(jrow, trow)


def test_device_defaults_to_the_card(env, monkeypatch):
    """Without a card, the default device raises; the CPU runs only when
    asked for."""
    from rtvqa_tpu_torch.cli import main as torch_main
    from rtvqa_tpu_torch.device import get_device
    from rtvqa_tpu_torch.pipeline import analyzer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        get_device(None)
    with pytest.raises(RuntimeError, match="is_available"):
        get_device("cuda")
    assert get_device("cpu") == torch.device("cpu")

    def no_encode(*a, **k):
        raise AssertionError("transcode must not run without a device")

    monkeypatch.setattr(analyzer.vio, "transcode", no_encode)
    with pytest.raises(RuntimeError, match="--device cpu"):
        torch_main([str(env["dir"] / "torch.json"), env["clip"]])


def test_analyzer_missing_video_raises():
    from rtvqa_tpu_torch.pipeline.analyzer import analyze_video

    with pytest.raises(FileNotFoundError):
        analyze_video("/nonexistent/clip.mp4", Config(quality_backend="none"))


_NO_JAX = r"""
import sys
sys.modules["jax"] = None        # any `import jax` now raises ImportError,
sys.modules["rtvqa_tpu"] = None  # and so does any import of the JAX package
import importlib, pathlib, numpy as np, torch
torch.set_num_threads(1)
pkg = pathlib.Path(sys.argv[1]) / "rtvqa_tpu_torch"
for f in sorted(pkg.rglob("*.py")):
    mod = ".".join(f.relative_to(pkg.parent).with_suffix("").parts)
    importlib.import_module(mod.removesuffix(".__init__"))
from rtvqa_tpu_torch.io.video import DecodedClip
from rtvqa_tpu_torch.metrics.complexity import calculate_average_scene_complexity
from rtvqa_tpu_torch.metrics.full_reference import CHUNK_KEYS, chunk_kernels
rng = np.random.default_rng(0)
n, h, w = 5, 48, 64
clip = DecodedClip(
    y=rng.integers(0, 256, (n, h, w), np.uint8),
    u=rng.integers(0, 256, (n, h // 2, w // 2), np.uint8),
    v=rng.integers(0, 256, (n, h // 2, w // 2), np.uint8),
    timestamps_ms=np.arange(n) * 100.0, width=w, height=h, n_frames_total=n,
    bit_rate=0, avg_fps=10.0)
res = calculate_average_scene_complexity(clip, 32, 32, device="cpu")
assert all(np.isfinite(res.as_tuple())), res
planes = [torch.from_numpy(a) for a in (clip.y, clip.u, clip.v, np.roll(clip.y, 1, 0), clip.v, clip.u)]
packed, blur = chunk_kernels(*planes, torch.zeros(h, w), False)
assert packed.shape == (len(CHUNK_KEYS), n) and bool(torch.isfinite(packed[:-5]).all())
from rtvqa_tpu_torch.kernels.vif import vif_features_cuda
from rtvqa_tpu_torch.metrics.complexity_streaming import ComplexityAccumulator
vif = vif_features_cuda(planes[0], planes[3])
assert all(bool(torch.isfinite(x).all()) for x in vif.values())
acc = ComplexityAccumulator(32, 32, chunk=2, device="cpu")
acc.add(clip.y, clip.u, clip.v, clip.timestamps_ms)
assert np.allclose(acc.finalize().as_tuple(), res.as_tuple(), rtol=1e-5)
from rtvqa_tpu_torch.metrics.complexity import METRIC_ORDER
from rtvqa_tpu_torch.parallel.launch import world
from rtvqa_tpu_torch.parallel.sharding import make_mesh, sharded_complexity_suite
with world("cpu") as dev:
    fn = sharded_complexity_suite(make_mesh(device=dev), resize_h=32, resize_w=32)
    one = [torch.from_numpy(a)[None] for a in (clip.y, clip.u, clip.v, clip.timestamps_ms.astype(np.float32))]
    out = fn(*one, torch.tensor([n]))
assert np.allclose([float(out[k][0]) for k in METRIC_ORDER], res.as_tuple(), rtol=1e-5)
assert sys.modules["jax"] is None and sys.modules["rtvqa_tpu"] is None
print("OK", res.motion)
"""


def test_port_never_imports_jax():
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX, str(REPO)], env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")


def test_port_sources_have_no_jax_import():
    """Neither the port nor chip_smoke.py imports jax or anything of the JAX
    package, not even its jax-free modules: the port keeps its own copies."""
    import re

    banned = re.compile(r"^\s*(from|import)\s+(jax|rtvqa_tpu)(\.|\s|$)")
    files = [*(REPO / "rtvqa_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]
    for module in ("vmaf/predictor.py", "parallel/launch.py", "parallel/sharding.py",
                   "pipeline/quality_sharded.py", "pipeline/batch_analyzer.py"):
        assert REPO / "rtvqa_tpu_torch" / module in files, module
    for f in files:
        for line in f.read_text().splitlines():
            assert not banned.match(line), f"{f}: {line}"
