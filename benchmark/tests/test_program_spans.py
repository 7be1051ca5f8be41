"""CPU test of ``benchmark/program_spans.py`` on the toy cell: the windows
in turns, the program's spans and counters read into its numbers, and the
padded share equal to the one the dealt clips' lengths give.

    python -m pytest benchmark/tests/test_program_spans.py
"""

from __future__ import annotations

import pytest
import torch

from benchmark import program_spans
from benchmark.harness import profile

from bench_toy import make_cell


def test_program_spans_reads_the_programs_tracer(tmp_path):
    cell = make_cell(tmp_path)
    out = program_spans.run(cell, 2**33 + 5, 0.5, torch.device("cpu"))
    assert out["correct"] is True
    assert [w["traced"] for w in out["windows"]] == [False, True, True, False]
    assert out["tracing_cost"] is not None
    m = out["metrics"]
    assert m["padded_frame_pct"] == pytest.approx(m["padded_frame_pct_host"], abs=0) and m["padded_frame_pct"] > 0
    assert m["fetch_wait_ms"] > 0 and m["pad_ms_per_clip"] > 0 and m["h2d_bytes_per_frame"] > 0
    assert out["lockstep_chunks"]["fetch_calls"] == out["lockstep_chunks"]["from_lengths"]
    assert {"clip", "pad", "quality", "fetch", "wait", "close", "pool"} <= set(out["spans"])
    assert out["breakdown"] is None and m["idle_untraced_ms_per_frame"] is None  # no device trace on the CPU
    assert out["copies"]["program_h2d_copies"] > 0
    assert out["span_cost"]["on_us"] > out["span_cost"]["off_us"] > 0 and out["spans_per_clip"] > 0


def launch(ts, tid, corr):
    return {"ph": "X", "name": "cudaLaunchKernel", "ts": ts, "dur": 1, "tid": tid, "cat": "cuda_runtime",
            "args": {"correlation": corr}}


TRACE = [
    {"ph": "X", "name": "bench.stretch", "ts": 0, "dur": 100, "tid": 1, "cat": "user_annotation"},
    {"ph": "X", "name": "bench.quality", "ts": 2, "dur": 6, "tid": 1, "cat": "user_annotation"},
    launch(3, 1, 11), launch(6, 2, 12), launch(7, 1, 13), launch(9, 1, 14),
    {"ph": "X", "name": "k1", "ts": 10, "dur": 20, "cat": "kernel", "args": {"correlation": 11}},
    {"ph": "X", "name": "Memcpy HtoD", "ts": 30, "dur": 5, "cat": "gpu_memcpy",
     "args": {"correlation": 12, "bytes": 4 << 20}},
    {"ph": "X", "name": "k2", "ts": 20, "dur": 20, "cat": "kernel", "args": {"correlation": 13}},
    {"ph": "X", "name": "k3", "ts": 50, "dur": 5, "cat": "kernel", "args": {"correlation": 14}},
    {"ph": "X", "name": "Memcpy HtoD", "ts": 95, "dur": 10, "cat": "gpu_memcpy", "args": {"bytes": 64}},
]
PROGRAM = [  # the main thread's spans (tid 1) and a producer's (tid 2)
    {"ph": "X", "name": "rtvqa.clip", "ts": 1, "dur": 98, "tid": 1, "cat": "user_annotation"},
    {"ph": "X", "name": "rtvqa.quality", "ts": 2, "dur": 7, "tid": 1, "cat": "user_annotation"},
    {"ph": "X", "name": "rtvqa.pad", "ts": 56, "dur": 38, "tid": 1, "cat": "user_annotation"},
    {"ph": "X", "name": "aten::cat", "ts": 44, "dur": 3, "tid": 1, "cat": "cpu_op"},
    {"ph": "X", "name": "rtvqa.stage", "ts": 41, "dur": 9, "tid": 2, "cat": "user_annotation"},
]


def test_the_programs_ranges_leave_the_harness_summary_as_it_was():
    """``harness/profile.py`` reads the same numbers from a trace with the
    program's ``rtvqa.*`` ranges as without them: they are no ``bench.*``
    range, no device activity and no launch."""
    assert profile.summarize(TRACE + PROGRAM) == profile.summarize(TRACE)


def test_gaps_are_named_by_the_programs_ranges():
    """Gaps [0, 10], [40, 50] and [55, 95]: the first in ``rtvqa.quality``
    at its middle, the second in ``rtvqa.clip`` alone with ``aten::cat`` at
    its middle, the third in ``rtvqa.pad``; the producer's range names
    nothing. Without the program's ranges every gap is ``loop``."""
    g = program_spans.named_gaps(TRACE + PROGRAM)
    assert g["gaps"][0] == ("pad", pytest.approx(40e-6))
    assert ("clip", pytest.approx(10e-6)) in g["gaps"] and ("quality", pytest.approx(10e-6)) in g["gaps"]
    assert g["untraced_s"] == pytest.approx(10e-6)
    assert g["untraced_by_op_s"] == {"aten::cat": pytest.approx(10e-6)}
    bare = program_spans.named_gaps(TRACE)
    assert {n for n, _ in bare["gaps"]} == {"loop"} and bare["untraced_s"] == pytest.approx(60e-6)


def test_copies_are_counted_by_the_thread_that_issued_them():
    assert program_spans.copy_counts(TRACE, 1)["trace_htod"] == {"other_large": 1, "unlinked_small": 1}
