"""A toy cell for the CPU tests: the real configuration, mix and limits
files, cut to 64x96 frames, short clips and a small pool, written with a
``BENCHMARK.json`` of its own into a temporary directory, with the metric
readers beside them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark.harness import spec

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def make_cell(tmp, config: str = "hd1080_default", mix: str = "shots", limits: str = "hd1080_default.shots",
              lengths=(20, 140), extra_metrics: dict | None = None) -> spec.Cell:
    """The toy cell ``toy.toy`` from the named files, in ``tmp``."""
    tmp = Path(tmp)
    for d in ("configs", "traffic", "limits"):
        (tmp / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH / "metrics", tmp / "metrics", dirs_exist_ok=True)
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    cfg.update(width=96, height=64, frame_pool_pairs=48, check={"frames": 64, "slots": 64, "block": 16})
    (tmp / "configs" / "toy.json").write_text(json.dumps(cfg))
    tr = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    tr["clip_frames"] = {"kind": "lognormal", "median": 60, "sigma": 0.8, "min": lengths[0],
                         "max": lengths[1], "deck": 8}
    (tmp / "traffic" / "toy.json").write_text(json.dumps(tr))
    shutil.copy(BENCH / "limits" / f"{limits}.json", tmp / "limits" / "toy.toy.json")
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    b["configs"] = [{"name": "toy", "source": "test", "file": "benchmark/configs/toy.json", "reduced": [],
                     "why": "test"}]
    b["workloads"] = [{"name": "toy.toy", "config": "toy", "traffic": "toy", "chips": 1, "why": "test"}]
    for m in b["per_layer"] + b["end_to_end"]:
        m.pop("workloads", None)
    for name, source in (extra_metrics or {}).items():
        (tmp / "metrics" / f"{name}.py").write_text(source)
        b["end_to_end"].append({"name": name, "unit": "1", "better": "lower", "bound": 0.25,
                                "source": "host_clock"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(b))
    return spec.load_cell("toy.toy", tmp / "BENCHMARK.json", tmp)
