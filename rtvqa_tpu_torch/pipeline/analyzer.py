"""Single-clip orchestrator: encode → probe → decode → complexity → CSV row
(counterpart of ``rtvqa_tpu/pipeline/analyzer.py``).

Ported route: ``quality_backend: "none"``. The clip is transcoded at the
configured CRF/preset, the original is probed, the analyzed clip (the
encoded one, or the original with ``analyze_original``) is decoded once at
``frame_interval``, and the eight-metric complexity suite runs on the device.
The CSV row carries the same 15 columns as the JAX package's, with the
PSNR/SSIM/VMAF cells left empty.

Not ported yet, and refused before any work rather than silently degraded:
the native quality route (``quality_backend: "native"``: PSNR/SSIM/VMAF
kernels and the native route, ROADMAP queue A items 2 and 4) and streaming
complexity (item 3). Encode, probe and decode are the framework-free native IO of
``rtvqa_tpu.io.video``, reused by import.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any

from rtvqa_tpu.config import Config
from rtvqa_tpu.io import video as vio
from rtvqa_tpu.obs.logging import get_logger
from rtvqa_tpu.obs.profiler import StageTimer
from rtvqa_tpu.pipeline.csv_sink import update_csv
from rtvqa_tpu_torch.metrics.complexity import calculate_average_scene_complexity

logger = get_logger("rtvqa_tpu.torch.pipeline")

STREAMING_AUTO_BYTES = 256 * 1024 * 1024


def _refuse_streaming(path: str, config: Config) -> None:
    """Raise if this run would take the streaming complexity route."""
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
) -> dict[str, Any]:
    """Run the pipeline for one clip; returns the CSV-row metrics dict."""
    if not os.path.isfile(input_video):
        raise FileNotFoundError(f"The input video file {input_video} does not exist.")
    if config.quality_backend == "native":
        raise NotImplementedError(
            "quality_backend 'native' (PSNR/SSIM/VMAF) is not ported to "
            "rtvqa_tpu_torch yet: ROADMAP.md queue A, items 2 and 4 (quality "
            "chunk, analyzer native route). "
            "Set \"quality_backend\": \"none\" to run the complexity path."
        )
    if config.streaming_complexity is True or config.analyze_original:
        _refuse_streaming(input_video, config)

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
) -> dict[str, Any]:
    """analyze + CSV append."""
    metrics = analyze_video(input_video, config, timer=timer)
    update_csv(metrics, csv_file=config.csv_file)
    return metrics
