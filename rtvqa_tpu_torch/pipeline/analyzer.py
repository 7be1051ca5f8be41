"""Single-clip orchestrator: encode → probe → quality → complexity → CSV row
(counterpart of ``rtvqa_tpu/pipeline/analyzer.py``).

The clip is transcoded at the configured CRF/preset and the original is
probed. With ``quality_backend: "native"`` both streams are decoded once in
lockstep and PSNR/SSIM/VMAF run over every frame at full resolution
(``metrics.full_reference.analyze_full_reference``). Then the analyzed clip
(the encoded one, or the original with ``analyze_original``) is decoded at
``frame_interval`` and the eight-metric complexity suite runs. The CSV row
carries the same 15 columns as the JAX package's.

Ported routes: ``quality_backend: "none"``, and ``"native"`` with
``"streaming_complexity": false`` (quality, then the separate complexity
pass). Refused before any work rather than silently degraded: the combined
quality+complexity engine that ``"native"`` takes when
``streaming_complexity`` is null or true (ROADMAP.md queue A, item 3), and
streaming complexity on its own.

Unlike the JAX package, a quality failure is not downgraded to a warning
and empty cells: a kernel that fails to build or launch fails the run.
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
from rtvqa_tpu_torch.obs.logging import get_logger
from rtvqa_tpu_torch.obs.profiler import StageTimer
from rtvqa_tpu_torch.pipeline.csv_sink import update_csv

logger = get_logger("rtvqa_tpu_torch.pipeline")

STREAMING_AUTO_BYTES = 256 * 1024 * 1024


def _refuse_combined(config: Config) -> None:
    """Raise if this run would take the combined quality+complexity engine."""
    if config.quality_backend == "native" and config.streaming_complexity is not False:
        raise NotImplementedError(
            "quality_backend 'native' with streaming_complexity null or true runs the "
            "combined quality+complexity engine (analyze_combined), not ported to "
            "rtvqa_tpu_torch yet: ROADMAP.md queue A, item 3. Set "
            "\"streaming_complexity\": false for the quality pass followed by the "
            "complexity pass, or \"quality_backend\": \"none\"."
        )


def _refuse_streaming(path: str, config: Config) -> None:
    """Raise if the complexity pass over ``path`` would stream."""
    use = config.streaming_complexity
    if use is None:
        use = os.path.getsize(path) > STREAMING_AUTO_BYTES
    if use:
        raise NotImplementedError(
            "streaming complexity (streaming_complexity=true, or auto on a file "
            "over 256 MB) is not ported to rtvqa_tpu_torch yet: ROADMAP.md queue "
            "A, item 3 (chunk drivers / streaming)"
        )


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
    _refuse_combined(config)
    if config.streaming_complexity is True or config.analyze_original:
        _refuse_streaming(input_video, config)
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

        if config.quality_backend == "native":
            from rtvqa_tpu_torch.metrics.full_reference import analyze_full_reference

            logger.info("Computing native PSNR/SSIM/VMAF (full-res, every frame)")
            with timer.stage("quality"):
                qual = analyze_full_reference(
                    input_video,
                    encoded_video,
                    vmaf_model_path=config.vmaf_model_path,
                    quality_precision=config.quality_precision,
                    device=dev,
                )
            timer.add_frames(int(qual["n_frames"]))
            if qual["n_frames"] > 0:
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

        target = input_video if config.analyze_original else encoded_video
        _refuse_streaming(target, config)
        logger.info("Calculating scene complexity after encoding...")
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

        # Each complexity column holds the metric its header names.
        metrics.update(
            {
                "Advanced Motion Complexity": comp.motion,
                "DCT Complexity": comp.dct,
                "Temporal DCT Complexity": comp.temporal_dct,
                "Histogram Complexity": comp.histogram,
                "Edge Detection Complexity": comp.edge,
                "ORB Feature Complexity": comp.orb,
                "Color Histogram Complexity": comp.color,
                "Framerate Variation": comp.framerate,
            }
        )
        logger.info("Metrics extracted: %s", metrics)
        if own_timer:
            timer.log_summary()
        return metrics
    finally:
        shutil.rmtree(temp_dir, ignore_errors=True)


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
