"""What a run is told by name: the cell's entry in ``BENCHMARK.json``, its
configuration (``configs/<name>.json``), its traffic mix
(``traffic/<name>.json``), its limits (``limits/<cell>.json``) and the
reader of each per-layer metric (``metrics/<name>.py``). A new cell, mix,
configuration or metric is a new file and a new entry; nothing here names
one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list
    bench_dir: Path = BENCH_DIR


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_file: Path = ROOT / "BENCHMARK.json", bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``bench_file`` with its files under ``bench_dir``."""
    spec = _load_json(bench_file)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; {bench_file.name} has {sorted(cells)}")
    w = cells[name]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=_load_json(bench_dir / "configs" / f"{w['config']}.json"),
        traffic=_load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        limits=_load_json(bench_dir / "limits" / f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)],
        bench_dir=bench_dir,
    )


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
