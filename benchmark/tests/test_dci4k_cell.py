"""The DCI-4K cell (``dci4k_every_frame.longform``): found by name, its
pool in whole chunks, and its reader of the quality step's launches.

    python -m pytest benchmark/tests
"""

from __future__ import annotations

from benchmark.harness import spec
from benchmark.harness.bench import Run
from benchmark.harness.spec import metric_reader

CELL = "dci4k_every_frame.longform"


def test_the_cell_loads_with_its_files():
    cell = spec.load_cell(CELL)
    assert cell.chips == 1
    assert (cell.config["width"], cell.config["height"]) == (4096, 2160)
    assert cell.config["analysis"]["frame_interval"] == 1 and cell.config["reduced"] == []
    assert cell.traffic["clip_frames"] == {"kind": "fixed", "frames": 1440}
    assert cell.limits == spec.load_cell("uhd2160_every_frame.longform").limits
    assert {m["name"] for m in cell.end_to_end} == {"frames_per_s", "peak_gib", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "staging_wait_ms", "h2d_bytes_per_frame", "quality_ms_per_frame", "complexity_ms_per_frame",
        "quality_roofline_pct", "device_idle_pct", "quality_launches_per_frame"}


def test_the_pool_holds_whole_chunks_of_the_wide_route():
    from rtvqa_tpu_torch.metrics.full_reference import FUSED_MAX_WIDTH, auto_chunk

    cfg = spec.load_cell(CELL).config
    chunk = auto_chunk(cfg["width"], cfg["height"])
    assert chunk == 14 and cfg["frame_pool_pairs"] % chunk == 0
    assert cfg["width"] > FUSED_MAX_WIDTH
    assert 1440 % chunk == 12  # each clip ends in a ragged tail, padded on the card


def test_launches_per_frame_reader():
    read = metric_reader("quality_launches_per_frame")
    trace = {"stretch_frames": 1440, "device": {"quality_launches": 36000}}
    assert read(Run([], 51.0, 1.0, 1, 2160, 4096, trace)) == 25.0
    assert read(Run([], 51.0, 1.0, 1, 2160, 4096, None)) is None
    assert read(Run([], 51.0, 1.0, 1, 2160, 4096, {"stretch_frames": 1440, "device": None})) is None
    assert read(Run([], 51.0, 1.0, 1, 2160, 4096, {"stretch_frames": 0, "device": {"quality_launches": 9}})) is None
    assert read(Run([], 51.0, 1.0, 1, 2160, 4096, {"stretch_frames": 9, "device": {"quality_launches": 0}})) is None
