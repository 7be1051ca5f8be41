"""The benchmark of ``rtvqa_tpu_torch`` on one card per cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs the cell of ``BENCHMARK.json`` named ``--workload``: makes the frame
pool from the seed, warms the cell's shapes (set-up, ``setup_s``), analyses
clips of the cell's traffic one at a time for ``--seconds`` through the
program's combined quality + complexity route, checks a seeded sample of
the answers against the plain reference in ``benchmark/reference``, and
prints one JSON line last on stdout: the end-to-end metrics with
``--trace 0``, the per-layer metrics, the device's busy time and a
breakdown with ``--trace 1``. The numbers compared, each beside its limit,
are the last lines on stderr and the last key of the JSON line.

Exits non-zero without a result when no card is visible (or fewer than the
cell asks for), and when JAX or the JAX package is loaded once the window
has closed. Build outputs and kernel caches stay under ``build/`` in the
checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "bench_cache"
# Fixed directories inside the checkout, so a second run finds what the
# first built.
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
sys.path.insert(0, str(ROOT))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark.harness import bench, spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        bench.log(f"needs {cell.chips} CUDA device(s); torch.cuda.is_available() is "
                  f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}")
        return 2
    torch.cuda.set_device(0)
    result = bench.run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T_START)
    found = bench.forbidden_modules()
    if found:
        bench.log(f"JAX or the JAX package was loaded: {', '.join(found)}")
        return 3
    for name, c in result["checks"].items():
        bench.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
