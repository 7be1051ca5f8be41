"""Multi-clip CRF-ladder sweep with a resumable manifest (counterpart of
``rtvqa_tpu/pipeline/sweep.py::run_sweep``; the device-parallel
``run_sweep_sharded`` is not ported, ROADMAP.md queue A, item 5).

Every (clip, crf) item goes through the single-clip pipeline
(``pipeline.analyzer``) on one device and appends one CSV row. Items that
the manifest already records as done are skipped, so an interrupted sweep
resumes; a failing item is recorded as failed and the sweep goes on.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterable, Optional, Sequence

import torch

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
