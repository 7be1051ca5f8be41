"""The control and the faults must come out as not correct.

* The control (``benchmark/control.py``): the reference one precision step
  lower in the program's place fails each cell's limits, here at a toy
  size; on the card it runs at the cell's own size.
* Faults planted under a toy run on the CPU (the harness's look for a card
  skipped): a chunk step that returns its carried state unchanged; half of
  each clip's frames left out, the means taken over the rest, both with the
  series cut short and with a full-length series whose every other frame is
  a copy of its neighbour, and with the series intact but pooled over half
  the clip; a value altered where the chunk step produces it; a complexity
  metric altered where the accumulator produces it; the sampled frames'
  timestamps altered where the accumulator takes them. Each run must read
  ``correct`` false. (The exchange between
  chips has no fault to plant: every cell runs on one card.)

    python -m pytest benchmark/tests
"""

from __future__ import annotations

import pytest
import torch

from benchmark import control
from benchmark.harness import bench, check, entry

from bench_toy import make_cell

CELLS = [("hd1080_default", "shots", "hd1080_default.shots"),
         ("uhd2160_every_frame", "longform", "uhd2160_every_frame.longform"),
         ("uhd2160_every_frame", "scope", "uhd2160_every_frame.scope")]


@pytest.mark.parametrize("config,mix,limits", CELLS)
def test_the_control_fails_each_cells_limits(tmp_path, config, mix, limits):
    cell = make_cell(tmp_path, config, mix, limits, lengths=(20, 140))
    for seed in (31, 2**35 + 2):
        numbers = control.control_numbers(cell, seed, 500, torch.device("cpu"))
        assert not check.judge(numbers, cell.limits), numbers


def toy_run(tmp_path, monkeypatch, plant) -> dict:
    # Every clip crosses a chunk boundary (128 frames at this size).
    cell = make_cell(tmp_path, lengths=(130, 140))
    prog = entry.Program()
    plant(monkeypatch, prog)
    return bench.run(cell, 2**32 + 9, 1.0, False, torch.device("cpu"), 0.0, prog=prog)


def unchanged_state(monkeypatch, prog):
    fr = prog.full_reference
    real = fr.chunk_plain

    def step(*args, **kwargs):
        packed, _ = real(*args, **kwargs)
        return packed, args[6]          # the blur carry handed in, not the new one
    monkeypatch.setattr(fr, "chunk_plain", step)


def half_left_out(monkeypatch, prog):
    fr = prog.full_reference
    real = fr.combined_chunk_loop

    def loop(*args, **kwargs):
        series, n, comp = real(*args, **kwargs)
        half = max(n // 2, 1)
        return {k: v[:half] for k, v in series.items()}, n, comp
    monkeypatch.setattr(fr, "combined_chunk_loop", loop)


def neighbour_copied(monkeypatch, prog):
    fr = prog.full_reference
    real = fr.combined_chunk_loop

    def loop(*args, **kwargs):
        series, n, comp = real(*args, **kwargs)
        out = {}
        for k, v in series.items():
            v = v.copy()
            v[1::2] = v[0::2][:v[1::2].size]    # half the frames computed, each copied once
            out[k] = v
        return out, n, comp
    monkeypatch.setattr(fr, "combined_chunk_loop", loop)


def pooled_over_half(monkeypatch, prog):
    fr = prog.full_reference
    real = fr.pool_full_reference

    def pool(series, n, *args, **kwargs):
        half = max(n // 2, 1)
        return real({k: v[:half] for k, v in series.items()}, half, *args, **kwargs)
    monkeypatch.setattr(fr, "pool_full_reference", pool)


def timestamps_altered(monkeypatch, prog):
    acc = prog.complexity_streaming.ComplexityAccumulator
    real = acc.add

    def add(self, y, u, v, ts):
        return real(self, y, u, v, ts * 1.001)
    monkeypatch.setattr(acc, "add", add)


def value_altered(monkeypatch, prog):
    fr = prog.full_reference
    real = fr.chunk_plain
    row = fr.CHUNK_KEYS.index("vif_scale0")

    def step(*args, **kwargs):
        packed, blur = real(*args, **kwargs)
        packed = packed.clone()
        packed[row, 0] *= 1.01
        return packed, blur
    monkeypatch.setattr(fr, "chunk_plain", step)


def metric_altered(monkeypatch, prog):
    import dataclasses

    acc = prog.complexity_streaming.ComplexityAccumulator
    real = acc.finalize

    def finalize(self):
        res = real(self)
        return dataclasses.replace(res, edge=res.edge * 1.01 + 1.0)
    monkeypatch.setattr(acc, "finalize", finalize)


@pytest.mark.parametrize("plant,number", [
    (unchanged_state, "quality_rel"), (half_left_out, "frames_mismatch"), (neighbour_copied, "quality_rel"),
    (pooled_over_half, "pooled_rel"), (value_altered, "quality_rel"), (metric_altered, "pooled_rel"),
    (timestamps_altered, "frames_mismatch")])
def test_a_planted_fault_reads_not_correct(tmp_path, monkeypatch, plant, number):
    out = toy_run(tmp_path, monkeypatch, plant)
    assert out["correct"] is False
    assert out["failed"] >= 1
    assert not out["checks"][number]["value"] <= out["checks"][number]["limit"], out["checks"]
