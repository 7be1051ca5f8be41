"""Multi-clip CRF-ladder sweep with a resumable manifest (counterpart of
``rtvqa_tpu/pipeline/sweep.py``). Two functions share the manifest and CSV:

* ``run_sweep``: every (clip, crf) item goes through the single-clip
  pipeline (``pipeline.analyzer``) on one device and appends one CSV row;
* ``run_sweep_sharded``: the device-parallel sweep over the process
  group's ranks (one per card, ``parallel/launch.py``): quality with each
  item's frame axis sharded over the ranks (``pipeline.quality_sharded``),
  complexity for all encoded items as batched programs over a clip x frame
  mesh (``pipeline.batch_analyzer``).

Items that the manifest already records as done are skipped, so an
interrupted sweep resumes; a failing item is recorded as failed and the
sweep goes on.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from typing import Iterable, Optional, Sequence

import torch
import torch.distributed as dist

from rtvqa_tpu_torch.config import Config
from rtvqa_tpu_torch.device import get_device
from rtvqa_tpu_torch.obs.logging import get_logger

logger = get_logger("rtvqa_tpu_torch.sweep")

DEFAULT_CRF_LADDER = (18, 23, 28, 33)


@dataclasses.dataclass
class SweepManifest:
    """Append-only JSONL manifest keyed by (video, crf)."""

    path: str

    def done_keys(self) -> set[tuple[str, int]]:
        keys = set()
        if os.path.isfile(self.path):
            with open(self.path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if rec.get("status") == "done":
                        keys.add((rec["video"], int(rec["crf"])))
        return keys

    def record(self, video: str, crf: int, status: str, error: Optional[str] = None) -> None:
        rec = {"video": video, "crf": crf, "status": status}
        if error:
            rec["error"] = error
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def run_sweep(
    videos: Sequence[str],
    config: Config,
    crf_ladder: Iterable[int] = DEFAULT_CRF_LADDER,
    manifest_path: Optional[str] = None,
    device: str | torch.device | None = None,
) -> dict[str, int]:
    """Analyze every (video, crf) pair on ``device`` (default: the card,
    resolved before the first item, so a missing card raises instead of
    failing every item); returns {'done': n, 'failed': m, 'skipped': k}."""
    from rtvqa_tpu_torch.pipeline.analyzer import process_video_and_extract_metrics

    dev = get_device(device)
    manifest = SweepManifest(manifest_path or config.csv_file + ".manifest.jsonl")
    done = manifest.done_keys()
    stats = {"done": 0, "failed": 0, "skipped": 0}

    for video in videos:
        for crf in crf_ladder:
            if (video, int(crf)) in done:
                stats["skipped"] += 1
                continue
            cfg = dataclasses.replace(config, crf=int(crf))
            try:
                process_video_and_extract_metrics(video, cfg, device=dev)
                manifest.record(video, int(crf), "done")
                stats["done"] += 1
            except Exception as e:  # per-item isolation, as the JAX sweep
                logger.error("Sweep item (%s, crf=%d) failed: %s", video, crf, e)
                manifest.record(video, int(crf), "failed", error=str(e))
                stats["failed"] += 1
    return stats


def _encode_and_probe(items, config: Config, tmp: str):
    """Rank 0's host work: encode every item into ``tmp`` and probe its
    original. Returns (encoded paths, failures, row heads), keyed by item."""
    from rtvqa_tpu_torch.io import video as vio

    encoded, failed, rows = {}, {}, {}
    for i, (video, crf) in enumerate(items):
        out = os.path.join(tmp, f"enc_{i}_{crf}.mp4")
        try:
            vio.transcode(video, out, crf=crf, preset=config.preset)
            encoded[(video, crf)] = out
            info = vio.get_video_info(video)
        except Exception as e:
            failed[(video, crf)] = f"{'probe' if (video, crf) in encoded else 'encode'}: {e}"
            continue
        rows[(video, crf)] = {
            "Bitrate (kbps)": info.bitrate_kbps,
            "Resolution (px)": info.resolution,
            "Frame Rate (fps)": info.frame_rate,
            "CRF": crf,
        }
    return encoded, failed, rows


def run_sweep_sharded(
    videos: Sequence[str],
    config: Config,
    crf_ladder: Iterable[int] = DEFAULT_CRF_LADDER,
    manifest_path: Optional[str] = None,
    ranks: Optional[int] = None,
    device: str | torch.device | None = None,
) -> dict[str, int]:
    """Device-parallel sweep (BASELINE.json configs[4]) with the rows and
    manifest of ``run_sweep``. Every rank of the process group calls it (a
    world of one on ``device``, the card by default, when there is no
    group) and gets the same {'done', 'failed', 'skipped'} counts.

    Rank 0 reads the manifest, encodes every pending item, probes the
    originals and decodes; the other ranks get what they need by broadcast
    and scatter. Quality runs per item over a 1 x n mesh; complexity runs
    as one batched program per resolution group over a 2 x n/2 mesh (1 x n
    for odd n), falling back to each item alone on rank 0 if the batch
    fails. Rank 0 writes the rows and the manifest in ``run_sweep``'s order.
    ``ranks`` (default ``config.data_parallel_devices``, else the whole
    world) bounds both meshes to the first ranks; the others wait for the
    counts. As in ``run_sweep``, an item whose quality fails is recorded as
    failed (the JAX package's sharded sweep leaves its quality cells empty).

    Every rank takes every collective step whatever an item's outcome: the
    outcomes come from rank 0 (``launch.share``), and a failure on any rank
    of a step raises on all of them (``launch.agree``)."""
    from rtvqa_tpu_torch.io import video as vio
    from rtvqa_tpu_torch.metrics.complexity import calculate_average_scene_complexity
    from rtvqa_tpu_torch.parallel.launch import share, world
    from rtvqa_tpu_torch.parallel.sharding import make_mesh
    from rtvqa_tpu_torch.pipeline.analyzer import complexity_columns
    from rtvqa_tpu_torch.pipeline.batch_analyzer import analyze_clips_sharded
    from rtvqa_tpu_torch.pipeline.csv_sink import update_csv
    from rtvqa_tpu_torch.pipeline.quality_sharded import analyze_full_reference_sharded

    with world(device) as dev:
        rank0 = dist.get_rank() == 0
        manifest = SweepManifest(manifest_path or config.csv_file + ".manifest.jsonl")

        def plan():
            done = manifest.done_keys()
            every = [(video, int(crf)) for video in videos for crf in crf_ladder]
            return [it for it in every if it not in done], sum(it in done for it in every)

        items, skipped = share(plan, rank0)
        stats = {"done": 0, "failed": 0, "skipped": skipped}
        if not items:
            return stats
        n = min(ranks or config.data_parallel_devices or dist.get_world_size(), dist.get_world_size())
        n_clip = 2 if n % 2 == 0 and n > 1 else 1
        quality_mesh = make_mesh(n_clip=1, n_frame=n, ranks=n, device=dev)
        comp_mesh = make_mesh(n_clip=n_clip, n_frame=n // n_clip, ranks=n, device=dev)
        logger.info("Sharded sweep: %d item(s) over %d rank(s) (complexity mesh %d x %d)",
                    len(items), n, n_clip, n // n_clip)

        tmp = tempfile.mkdtemp(prefix="rtvqa_sweep_") if rank0 else ""
        try:
            encoded, failed, rows = share(lambda: _encode_and_probe(items, config, tmp), rank0)
            live = [it for it in items if it in rows]
            # Every rank walks the same steps; the rows and failures that count are rank 0's.
            if config.quality_backend == "native":
                for it in live:
                    try:
                        qual = analyze_full_reference_sharded(
                            it[0], encoded[it], mesh=quality_mesh,
                            vmaf_model_path=config.vmaf_model_path,
                            quality_precision=config.quality_precision,
                        )
                    except Exception as e:
                        failed[it] = f"quality: {e}"
                        continue
                    if qual["n_frames"] > 0:
                        rows[it].update({"PSNR": qual["psnr"], "SSIM": qual["ssim"]})
                        if not qual["vmaf_is_fallback"] or config.allow_builtin_vmaf:
                            rows[it]["VMAF"] = qual["vmaf"]

            def size_groups():
                """(item, complexity target) pairs of the live items, by frame size."""
                groups: dict[tuple[int, int], list] = {}
                for it in live:
                    if it in failed:
                        continue
                    path = it[0] if config.analyze_original else encoded[it]
                    try:
                        info = vio.get_video_info(path)
                    except Exception as e:
                        failed[it] = f"probe encoded: {e}"
                        continue
                    groups.setdefault((info.width, info.height), []).append((it, path))
                return list(groups.values())

            for group in share(size_groups, rank0):
                try:
                    results = analyze_clips_sharded(
                        [path for _, path in group], config.resize_width, config.resize_height,
                        frame_interval=config.frame_interval,
                        smoothing_factor=config.smoothing_alpha, mesh=comp_mesh,
                        motion_search=config.motion_search,
                    )
                except Exception as e:
                    logger.warning("Batched complexity failed for %d item(s): %s", len(group), e)
                    results = [None] * len(group)
                    for i, (it, path) in enumerate(group if rank0 else ()):
                        try:  # each item alone, on rank 0
                            clip = vio.decode_sampled(path, frame_interval=config.frame_interval)
                            results[i] = calculate_average_scene_complexity(
                                clip, config.resize_width, config.resize_height,
                                smoothing_factor=config.smoothing_alpha,
                                motion_search=config.motion_search, device=dev,
                            )
                        except Exception as e2:
                            failed[it] = f"complexity: {e2}"
                for (it, _), comp in zip(group, results):
                    if comp is not None:
                        rows[it].update(complexity_columns(comp))

            def emit():
                for video, crf in items:
                    it = (video, crf)
                    if it in rows and it not in failed:
                        update_csv(rows[it], csv_file=config.csv_file)
                        manifest.record(video, crf, "done")
                        stats["done"] += 1
                    else:
                        err = failed.get(it, "unknown failure")
                        logger.error("Sweep item (%s, crf=%d) failed: %s", video, crf, err)
                        manifest.record(video, crf, "failed", error=err)
                        stats["failed"] += 1
                return stats

            return share(emit, rank0)
        finally:
            if tmp:
                shutil.rmtree(tmp, ignore_errors=True)
