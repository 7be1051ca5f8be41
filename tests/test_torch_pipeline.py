"""The port's CLI and analyzer vs the JAX package's on the same encoded clip,
plus the routes the port refuses and proof that it never imports jax.

The CSV rows must agree column by column: the identity columns exactly, the
complexity columns within the suite tolerances (rel 1e-4; motion rel 5e-3,
docs/PARITY.md motion row), the quality cells empty in both. The edge column
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

from rtvqa_tpu.config import Config
from rtvqa_tpu.io import video as vio
from rtvqa_tpu.pipeline.csv_sink import CSV_COLUMNS, read_rows

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
    paths = {}
    for name in ("jax", "torch"):
        paths[name] = str(d / f"{name}.csv")
        with open(d / f"{name}.json", "w") as f:
            json.dump({**cfg, "csv_file": paths[name]}, f)
    return {"clip": clip, "dir": d, "csv": paths}


def test_cli_row_matches_jax_cli(env):
    from rtvqa_tpu.cli import main as jax_main
    from rtvqa_tpu_torch.cli import main as torch_main

    d = env["dir"]
    assert jax_main([str(d / "jax.json"), env["clip"]]) == 0
    assert torch_main([str(d / "torch.json"), env["clip"]]) == 0
    (jrow,), (trow,) = read_rows(env["csv"]["jax"]), read_rows(env["csv"]["torch"])
    assert list(trow) == CSV_COLUMNS
    for col in IDENTITY_COLUMNS:
        assert trow[col] == jrow[col], col
    for col in QUALITY_COLUMNS:
        assert trow[col] == jrow[col] == "", col
    decision_counts = ("Advanced Motion Complexity", "Edge Detection Complexity")
    for col in CSV_COLUMNS[7:]:
        tol = 5e-3 if col in decision_counts else 1e-4
        assert float(trow[col]) == pytest.approx(float(jrow[col]), rel=tol, abs=1e-6), col
    assert float(trow["Advanced Motion Complexity"]) > 0


def test_cli_json_line(env, capsys):
    from rtvqa_tpu_torch.cli import main as torch_main

    assert torch_main([str(env["dir"] / "torch.json"), env["clip"], "--json"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"metrics", "profile"}
    assert {"encode", "decode", "complexity"} <= set(out["profile"]["stages"])


@pytest.mark.parametrize("flag", [["--sweep"], ["--sweep", "18", "28"], ["--sharded"], ["--trace", "t"]])
def test_cli_refuses_unported_modes(env, flag):
    from rtvqa_tpu_torch.cli import main as torch_main

    with pytest.raises(NotImplementedError, match="not ported"):
        torch_main([str(env["dir"] / "torch.json"), env["clip"], *flag])


@pytest.mark.parametrize(
    "overrides,match",
    [
        ({}, "quality_backend 'native'"),            # the default config
        ({"quality_backend": "none", "streaming_complexity": True}, "streaming"),
        ({"quality_backend": "none", "streaming_complexity": True,
          "analyze_original": True}, "streaming"),
    ],
)
def test_analyzer_refuses_unported_routes_before_encoding(env, monkeypatch, overrides, match):
    from rtvqa_tpu_torch.pipeline import analyzer

    def no_encode(*a, **k):
        raise AssertionError("transcode must not run for a refused route")

    monkeypatch.setattr(analyzer.vio, "transcode", no_encode)
    with pytest.raises(NotImplementedError, match=match):
        analyzer.analyze_video(env["clip"], Config(**overrides))


def test_analyzer_refuses_auto_streaming_on_large_files(env, monkeypatch):
    from rtvqa_tpu_torch.pipeline import analyzer

    monkeypatch.setattr(analyzer, "STREAMING_AUTO_BYTES", 16)
    with pytest.raises(NotImplementedError, match="streaming"):
        analyzer.analyze_video(env["clip"], Config(quality_backend="none"))


def test_analyzer_missing_video_raises():
    from rtvqa_tpu_torch.pipeline.analyzer import analyze_video

    with pytest.raises(FileNotFoundError):
        analyze_video("/nonexistent/clip.mp4", Config(quality_backend="none"))


_NO_JAX = r"""
import sys
sys.modules["jax"] = None   # any `import jax` now raises ImportError
import importlib, pathlib, numpy as np, torch
torch.set_num_threads(1)
pkg = pathlib.Path(sys.argv[1]) / "rtvqa_tpu_torch"
for f in sorted(pkg.rglob("*.py")):
    mod = ".".join(f.relative_to(pkg.parent).with_suffix("").parts)
    importlib.import_module(mod.removesuffix(".__init__"))
from rtvqa_tpu.io.video import DecodedClip
from rtvqa_tpu_torch.metrics.complexity import calculate_average_scene_complexity
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
assert sys.modules["jax"] is None
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
    for f in (REPO / "rtvqa_tpu_torch").rglob("*.py"):
        for line in f.read_text().splitlines():
            stripped = line.strip()
            assert not stripped.startswith(("import jax", "from jax")), f"{f}: {line}"
    for line in (REPO / "chip_smoke.py").read_text().splitlines():
        assert not line.strip().startswith(("import jax", "from jax", "from rtvqa_tpu.ops")), line
