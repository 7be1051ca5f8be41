"""CLI entry point of the PyTorch port — the same UX as ``rtvqa_tpu.cli``:

    python -m rtvqa_tpu_torch.cli <config.json> <input_video> [--sweep [CRF ...]] [--json]
    rtvqa-torch <config.json> <input_video> [--sweep [CRF ...]] [--json]

Runs on the card (``--device cuda``, the default; it raises without one);
``--device cpu`` runs the plain PyTorch ops on the CPU. ``--sweep`` runs the
CRF ladder on that one device. ``--trace DIR`` wraps the run in a
``torch.profiler`` trace written to DIR as a Chrome trace JSON
(``obs/profiler.py::device_trace``). ``--sharded`` (multi-GPU) is accepted
for parity with the JAX CLI and refused, as it is not ported yet.
"""

from __future__ import annotations

import argparse
import json
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
                        help="Device-parallel sweep driver (not ported yet).")
    parser.add_argument("--trace", type=str, default=None, metavar="DIR",
                        help="Write a torch.profiler trace of the run (Chrome trace JSON) into DIR.")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="Where the metrics run (default: cuda; cpu only when asked).")
    parser.add_argument("--json", action="store_true",
                        help="Emit one JSON line with the metrics row (or the sweep stats) "
                        "and the stage profile.")
    args = parser.parse_args(argv)
    if args.sharded:
        raise NotImplementedError("--sharded is not ported to rtvqa_tpu_torch yet")

    setup_logging()
    logger = get_logger("rtvqa_tpu_torch.cli")
    config = load_config(args.config_file)
    timer = StageTimer()
    try:
        with device_trace(args.trace, args.device):
            if args.sweep is not None:
                from rtvqa_tpu_torch.pipeline.sweep import DEFAULT_CRF_LADDER, run_sweep

                # A bare --sweep means the default ladder, not a single-CRF run.
                ladder = tuple(args.sweep) or DEFAULT_CRF_LADDER
                result = run_sweep([args.input_video], config, crf_ladder=ladder, device=args.device)
            else:
                from rtvqa_tpu_torch.pipeline.analyzer import process_video_and_extract_metrics

                result = process_video_and_extract_metrics(
                    args.input_video, config, timer=timer, device=args.device
                )
        if timer.totals:
            timer.log_summary()
        if args.json:
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
