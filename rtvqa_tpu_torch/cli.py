"""CLI entry point of the PyTorch port — the same UX as ``rtvqa_tpu.cli``:

    python -m rtvqa_tpu_torch.cli <config.json> <input_video> [--json]
    rtvqa-torch <config.json> <input_video> [--json]

Runs on the GPU when one is present, else on the CPU. Single-clip mode only:
``--sweep``, ``--sharded`` and ``--trace`` are accepted for parity with the
JAX CLI and refused, as they are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import sys

from rtvqa_tpu.config import load_config
from rtvqa_tpu.obs.logging import get_logger, setup_logging, stop_logging
from rtvqa_tpu.obs.profiler import StageTimer


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Process a video, extract metrics, and update CSV (PyTorch port)."
    )
    parser.add_argument("config_file", type=str, help="Path to the configuration JSON file.")
    parser.add_argument("input_video", type=str, help="Path to the input video file.")
    parser.add_argument("--sweep", type=int, nargs="*", default=None, metavar="CRF",
                        help="CRF-ladder sweep (not ported yet).")
    parser.add_argument("--sharded", action="store_true",
                        help="Device-parallel sweep driver (not ported yet).")
    parser.add_argument("--trace", type=str, default=None, metavar="DIR",
                        help="Device trace of the run (not ported yet).")
    parser.add_argument("--json", action="store_true",
                        help="Emit one JSON line with the metrics row and the stage profile.")
    args = parser.parse_args(argv)
    for flag, given in (("--sweep", args.sweep is not None), ("--sharded", args.sharded),
                        ("--trace", args.trace is not None)):
        if given:
            raise NotImplementedError(f"{flag} is not ported to rtvqa_tpu_torch yet")

    setup_logging()
    logger = get_logger("rtvqa_tpu.torch.cli")
    config = load_config(args.config_file)
    timer = StageTimer()
    try:
        from rtvqa_tpu_torch.pipeline.analyzer import process_video_and_extract_metrics

        result = process_video_and_extract_metrics(args.input_video, config, timer=timer)
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
