"""Single-clip orchestrator: encode → probe → quality → complexity → CSV row
(counterpart of ``rtvqa_tpu/pipeline/analyzer.py``).

The clip is transcoded at the configured CRF/preset and the original is
probed. Then, as in the JAX package:

* ``quality_backend: "native"`` with ``streaming_complexity`` null or true
  (the default config): the combined engine
  (``metrics.full_reference.analyze_combined``) decodes both streams once in
  lockstep, runs PSNR/SSIM/VMAF over every frame at full resolution and
  taps every ``frame_interval``-th frame of the analyzed clip (the encoded
  one, or the original with ``analyze_original``) into the streaming
  complexity accumulator;
* otherwise (``"none"``, or ``"native"`` with ``streaming_complexity:
  false``: quality first) the complexity pass runs on its own, streaming
  when ``streaming_complexity`` is true or null on a file over 256 MB, else
  on the whole sampled clip. It also runs when the combined engine saw no
  frame pair.

The CSV row carries the same 15 columns as the JAX package's. Unlike the
JAX package, a quality failure is not downgraded to a warning and empty
cells: a kernel that fails to build or launch fails the run.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any

import torch

from rtvqa_tpu_torch.config import Config
from rtvqa_tpu_torch.device import get_device
from rtvqa_tpu_torch.io import video as vio
from rtvqa_tpu_torch.metrics.complexity import calculate_average_scene_complexity
from rtvqa_tpu_torch.metrics.complexity_streaming import (
    calculate_average_scene_complexity_streaming,
)
from rtvqa_tpu_torch.metrics.full_reference import analyze_combined, analyze_full_reference
from rtvqa_tpu_torch.obs.logging import get_logger
from rtvqa_tpu_torch.obs.profiler import StageTimer
from rtvqa_tpu_torch.pipeline.csv_sink import update_csv

logger = get_logger("rtvqa_tpu_torch.pipeline")

STREAMING_AUTO_BYTES = 256 * 1024 * 1024


def analyze_video(
    input_video: str,
    config: Config,
    timer: StageTimer | None = None,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """Run the pipeline for one clip on ``device`` (default: the card);
    returns the CSV-row metrics dict."""
    if not os.path.isfile(input_video):
        raise FileNotFoundError(f"The input video file {input_video} does not exist.")
    dev = get_device(device)

    own_timer = timer is None
    timer = timer or StageTimer()
    temp_dir = tempfile.mkdtemp(prefix="rtvqa_")
    try:
        encoded_video = os.path.join(temp_dir, "encoded_video.mp4")
        logger.info("Encoding %s at CRF %d (%s)", input_video, config.crf, config.preset)
        with timer.stage("encode"):
            vio.transcode(input_video, encoded_video, crf=config.crf, preset=config.preset)
        with timer.stage("probe"):
            info = vio.get_video_info(input_video)
        metrics: dict[str, Any] = {
            "Bitrate (kbps)": info.bitrate_kbps,
            "Resolution (px)": info.resolution,
            "Frame Rate (fps)": info.frame_rate,
            "CRF": config.crf,
        }

        comp = None
        if config.quality_backend == "native":
            logger.info("Computing native PSNR/SSIM/VMAF (full-res, every frame)")
            if config.streaming_complexity is not False:
                with timer.stage("quality+complexity"):
                    qual, comp = analyze_combined(
                        input_video,
                        encoded_video,
                        frame_interval=config.frame_interval,
                        resize_width=config.resize_width,
                        resize_height=config.resize_height,
                        smoothing_factor=config.smoothing_alpha,
                        complexity_chunk=config.batch_size,
                        complexity_on="ref" if config.analyze_original else "dis",
                        vmaf_model_path=config.vmaf_model_path,
                        quality_precision=config.quality_precision,
                        motion_search=config.motion_search,
                        device=dev,
                    )
            else:
                with timer.stage("quality"):
                    qual = analyze_full_reference(
                        input_video,
                        encoded_video,
                        vmaf_model_path=config.vmaf_model_path,
                        quality_precision=config.quality_precision,
                        device=dev,
                    )
            timer.add_frames(int(qual["n_frames"]))
            if qual["n_frames"] == 0:
                comp = None  # no frame pair: the separate complexity pass below
            else:
                metrics["PSNR"] = qual["psnr"]
                metrics["SSIM"] = qual["ssim"]
                if not qual["vmaf_is_fallback"] or config.allow_builtin_vmaf:
                    metrics["VMAF"] = qual["vmaf"]
                else:
                    logger.warning(
                        "VMAF cell left empty: no model file. Set vmaf_model_path "
                        "(libvmaf JSON) for parity scores or allow_builtin_vmaf=true "
                        "for the qualitative builtin fallback."
                    )

        if comp is None:
            target = input_video if config.analyze_original else encoded_video
            logger.info("Calculating scene complexity after encoding...")
            use_streaming = config.streaming_complexity
            if use_streaming is None:  # auto: stream when the file is large
                use_streaming = os.path.getsize(target) > STREAMING_AUTO_BYTES
            if use_streaming:
                with timer.stage("complexity"):
                    comp = calculate_average_scene_complexity_streaming(
                        target,
                        resize_width=config.resize_width,
                        resize_height=config.resize_height,
                        frame_interval=config.frame_interval,
                        smoothing_factor=config.smoothing_alpha,
                        chunk=config.batch_size,
                        motion_search=config.motion_search,
                        device=dev,
                    )
            else:
                with timer.stage("decode"):
                    clip = vio.decode_sampled(
                        target, frame_interval=config.frame_interval, threads=config.num_workers
                    )
                timer.add_frames(int(clip.y.shape[0]))
                with timer.stage("complexity"):
                    comp = calculate_average_scene_complexity(
                        clip,
                        resize_width=config.resize_width,
                        resize_height=config.resize_height,
                        smoothing_factor=config.smoothing_alpha,
                        motion_search=config.motion_search,
                        device=dev,
                    )

        metrics.update(complexity_columns(comp))
        logger.info("Metrics extracted: %s", metrics)
        if own_timer:
            timer.log_summary()
        return metrics
    finally:
        shutil.rmtree(temp_dir, ignore_errors=True)


def complexity_columns(comp) -> dict[str, float]:
    """The eight complexity cells of a CSV row from a ``ComplexityResult``:
    each column holds the metric its header names."""
    return {
        "Advanced Motion Complexity": comp.motion,
        "DCT Complexity": comp.dct,
        "Temporal DCT Complexity": comp.temporal_dct,
        "Histogram Complexity": comp.histogram,
        "Edge Detection Complexity": comp.edge,
        "ORB Feature Complexity": comp.orb,
        "Color Histogram Complexity": comp.color,
        "Framerate Variation": comp.framerate,
    }


def process_video_and_extract_metrics(
    input_video: str,
    config: Config,
    timer: StageTimer | None = None,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """analyze + CSV append."""
    metrics = analyze_video(input_video, config, timer=timer, device=device)
    update_csv(metrics, csv_file=config.csv_file)
    return metrics
