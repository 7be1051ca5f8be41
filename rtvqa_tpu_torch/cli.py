"""CLI entry point of the PyTorch port — the same UX as ``rtvqa_tpu.cli``:

    python -m rtvqa_tpu_torch.cli <config.json> <input_video> [--sweep [CRF ...]] [--sharded] [--json]
    rtvqa-torch <config.json> <input_video> [--sweep [CRF ...]] [--sharded] [--json]
    torchrun --nproc-per-node N -m rtvqa_tpu_torch.cli <config.json> <input_video> --sweep [CRF ...]

Runs on the card (``--device cuda``, the default; it raises without one);
``--device cpu`` runs the plain PyTorch ops on the CPU. ``--sweep`` runs the
CRF ladder: on one device, or with ``--sharded`` as the device-parallel
sweep (``pipeline/sweep.py::run_sweep_sharded``) over the process group's
ranks, one per card (NCCL; gloo with ``--device cpu``). Under plain
``python`` the group is a world of one; under ``torchrun`` it is torchrun's
N processes, and a sweep shards whether or not ``--sharded`` is given, as
the JAX CLI shards when it sees more than one device.
``config.data_parallel_devices`` bounds the mesh. Without ``--sweep`` the
single-clip path runs (``--sharded`` changes nothing there, as in the JAX
CLI), on rank 0 only under torchrun. ``--trace DIR`` wraps the run in a
``torch.profiler`` trace written to DIR as a Chrome trace JSON
(``obs/profiler.py::device_trace``), in which the program's spans are
``rtvqa.*`` ranges, and writes every thread's span records beside it
(``rtvqa_spans.<pid>.json``). ``--trace`` and ``--json`` make the run's
``StageTimer`` the active tracer; ``--json``'s ``"profile"`` then carries
the seconds and calls of each span name (``"spans"``) and the counters
(``"counters"``: bytes and copies to the device, staged chunks, padded
frames, suite builds).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

from rtvqa_tpu_torch.config import load_config
from rtvqa_tpu_torch.obs.logging import get_logger, setup_logging, stop_logging
from rtvqa_tpu_torch.obs.profiler import StageTimer, device_trace


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Process a video, extract metrics, and update CSV (PyTorch port)."
    )
    parser.add_argument("config_file", type=str, help="Path to the configuration JSON file.")
    parser.add_argument("input_video", type=str, help="Path to the input video file.")
    parser.add_argument("--sweep", type=int, nargs="*", default=None, metavar="CRF",
                        help="Run a CRF-ladder sweep instead of the single configured CRF. "
                        "With no values, sweeps the default ladder (18/23/28/33).")
    parser.add_argument("--sharded", action="store_true",
                        help="Run a sweep as the device-parallel sweep (frames sharded over "
                        "the ranks). Default: sharded under torchrun with more than one rank.")
    parser.add_argument("--trace", type=str, default=None, metavar="DIR",
                        help="Write a torch.profiler trace of the run (Chrome trace JSON) and the "
                        "program's span records into DIR.")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="Where the metrics run (default: cuda; cpu only when asked).")
    parser.add_argument("--json", action="store_true",
                        help="Emit one JSON line with the metrics row (or the sweep stats) "
                        "and the stage profile.")
    args = parser.parse_args(argv)
    world_size = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))

    setup_logging()
    logger = get_logger("rtvqa_tpu_torch.cli")
    config = load_config(args.config_file)
    timer = StageTimer()
    tracing = timer.active() if args.trace or args.json else contextlib.nullcontext()
    try:
        with tracing, device_trace(args.trace, args.device):
            if args.sweep is not None:
                from rtvqa_tpu_torch.pipeline.sweep import (
                    DEFAULT_CRF_LADDER,
                    run_sweep,
                    run_sweep_sharded,
                )

                # A bare --sweep means the default ladder, not a single-CRF run.
                ladder = tuple(args.sweep) or DEFAULT_CRF_LADDER
                sweep = run_sweep_sharded if args.sharded or world_size > 1 else run_sweep
                result = sweep([args.input_video], config, crf_ladder=ladder, device=args.device)
            elif rank != 0:
                logger.info("Single-clip mode runs on rank 0; rank %d has nothing to do", rank)
                return 0
            else:
                from rtvqa_tpu_torch.pipeline.analyzer import process_video_and_extract_metrics

                result = process_video_and_extract_metrics(
                    args.input_video, config, timer=timer, device=args.device
                )
        if args.trace:
            timer.write(os.path.join(args.trace, f"rtvqa_spans.{os.getpid()}.json"))
        if timer.totals:
            timer.log_summary()
        if args.json and rank == 0:
            print(json.dumps({"metrics": result, "profile": timer.summary()}, default=float))
        logger.info("Processing completed successfully.")
        return 0
    except Exception as e:
        logger.error("An error occurred during processing: %s", e)
        raise
    finally:
        stop_logging()


if __name__ == "__main__":
    sys.exit(main())
