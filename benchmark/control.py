"""The control of ``correct``: the reference put in the program's place and
computed one precision step lower (bfloat16 floats, TF32 matrix products;
``reference/prec.py``), judged by the same numbers against the reference
at the configuration's precision.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 --frames <n>

For each seed it makes the cell's frame pool, deals the cell's clips until
they hold ``--frames`` frames (a window's worth), samples frames and slots
as a run does, and prints each number; then, per number, the smallest over
the seeds (the upper reading its limit must stay below). A number the
control does not move reads 0. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.harness import check, frames, spec, traffic  # noqa: E402
from benchmark.reference import pool as ref_pool  # noqa: E402
from benchmark.reference import prec  # noqa: E402


class Stub:
    """A clip of the window as the control sees it: no program answer."""

    def __init__(self, clip):
        self.clip = clip


def control_numbers(cell, seed: int, n_frames: int, device) -> dict:
    pool = frames.make_pool(cell.config, cell.traffic, seed, device)
    an = cell.config["analysis"]
    interval, alpha = int(an["frame_interval"]), float(an["smoothing_alpha"])
    chunk = chunk_size(cell.config["width"], cell.config["height"])
    stubs, total = [], 0
    for clip in traffic.clips(cell.traffic, seed, pool.frames, chunk):
        stubs.append(Stub(clip))
        total += clip.frames
        if total >= n_frames:
            break
    chk = cell.config["check"]
    fr, sl = check.plan(stubs, seed, int(chk["frames"]), int(chk["slots"]), chunk, interval)
    block = int(chk["block"])
    with torch.no_grad():
        prec.exact()
        exact_q = check.reference_quality(pool, stubs, fr, device, block)
        exact_c = check.reference_complexity(pool, stubs, sl, device, block, cell.config)
        with prec.lowered():
            low_q = check.reference_quality(pool, stubs, fr, device, block)
            low_c = check.reference_complexity(pool, stubs, sl, device, block, cell.config)
    pooled = []
    for i in range(len(stubs)):
        qi = [j for j, (c, _) in enumerate(fr) if c == i]
        ci = [j for j, (c, _) in enumerate(sl) if c == i]
        if len(qi) < 2 or len(ci) < 3:
            continue
        series = {k: v[qi] for k, v in low_q.items()}
        slots = {k: v[ci] for k, v in low_c.items()}
        ts = np.array([sl[j][1] for j in ci], np.float64) * interval * 1000.0 / float(cell.config["fps"])
        want = {**ref_pool.pool_quality(series), **ref_pool.pool_complexity(slots, ts, alpha)}
        got = {**ref_pool.pool_quality(series, torch.bfloat16),
               **ref_pool.pool_complexity(slots, ts, alpha, torch.bfloat16)}
        pooled.append(max(abs(got[k] - w) / max(abs(w), 1e-12) for k, w in want.items()))
    return {
        "quality_rel": float(check.rel_errors(low_q, exact_q).max()),
        "complexity_rel": float(check.rel_errors(low_c, exact_c).max()),
        "pooled_rel": float(max(pooled)) if pooled else 0.0,
        "frames_mismatch": 0.0,
        "clips": len(stubs), "frames": len(fr), "slots": len(sl),
    }


def chunk_size(width: int, height: int) -> int:
    """``auto_chunk``'s rule for the frame size (64 at 1080p, at most 128,
    even, at least 2), so the sample holds the same chunk boundaries as a
    run's."""
    budget = min(max(2, int(64 * (1080 * 1920) / max(width * height, 1))), 128)
    return max(2, (budget // 2) * 2)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--frames", type=int, required=True)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    readings = []
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers = control_numbers(cell, seed, args.frames, device)
        readings.append(numbers)
        print(json.dumps({"workload": args.workload, "seed": seed, **numbers}), flush=True)
    upper = {k: min(r[k] for r in readings) for k in check.NUMBERS}
    print(json.dumps({"workload": args.workload, "upper": upper, "device": str(device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
