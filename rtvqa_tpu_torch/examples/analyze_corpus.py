"""Example: batched CRF-ladder sweep over a corpus (BASELINE.json configs[4]),
the port's counterpart of ``examples/analyze_corpus.py``.

Rank 0 makes a small synthetic corpus with the port's own encoder; then
every rank of the process group:

1. runs the resumable device-parallel CRF-ladder sweep (one CSV row per
   (clip, crf): quality with each item's frames sharded over the ranks,
   complexity batched over every item on a clip x frame mesh, failures
   isolated; a rerun skips the done items);
2. runs the batched complexity analysis over the whole corpus at once.

Usage:

    python -m rtvqa_tpu_torch.examples.analyze_corpus [workdir] --device cpu   # a world of one, gloo
    python -m rtvqa_tpu_torch.examples.analyze_corpus [workdir]                # one card, NCCL
    torchrun --nproc-per-node N -m rtvqa_tpu_torch.examples.analyze_corpus workdir   # N cards

Under torchrun give a ``workdir`` that every rank can read.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
from fractions import Fraction

import numpy as np
import torch.distributed as dist

from rtvqa_tpu_torch.config import Config
from rtvqa_tpu_torch.io import video as vio
from rtvqa_tpu_torch.obs.profiler import StageTimer
from rtvqa_tpu_torch.parallel.launch import share, world
from rtvqa_tpu_torch.pipeline.batch_analyzer import analyze_clips_sharded
from rtvqa_tpu_torch.pipeline.sweep import run_sweep_sharded


def make_corpus(workdir: str, n_clips: int = 3, frames: int = 48) -> list[str]:
    """``n_clips`` moving-gradient clips of ``frames`` 144x192 frames."""
    rng = np.random.default_rng(0)
    paths = []
    h, w = 144, 192
    yy, xx = np.mgrid[0:h, 0:w]
    for c in range(n_clips):
        clip = []
        for i in range(frames):
            g = np.clip(((xx * (2 + c) + yy + (3 + c) * i) % 256) + rng.integers(0, 16, (h, w)),
                        0, 255).astype(np.uint8)
            clip.append(np.stack([g, 255 - g, (g.astype(np.int16) + 64) % 256], -1).astype(np.uint8))
        path = os.path.join(workdir, f"clip{c}.mp4")
        vio.encode_raw_rgb(path, np.stack(clip), fps=Fraction(30, 1), crf=18)
        paths.append(path)
    return paths


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("workdir", nargs="?", default=None,
                        help="Where the corpus, CSV and manifest go (default: a new temp dir).")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--clips", type=int, default=3)
    parser.add_argument("--frames", type=int, default=48)
    args = parser.parse_args(argv)
    timer = StageTimer()
    with world(args.device) as dev:
        rank0 = dist.get_rank() == 0

        def prepare():
            workdir = args.workdir or tempfile.mkdtemp(prefix="rtvqa_corpus_")
            os.makedirs(workdir, exist_ok=True)
            with timer.stage("make_corpus"):
                return workdir, make_corpus(workdir, args.clips, args.frames)

        workdir, corpus = share(prepare, rank0)
        cfg = Config(crf=23, resize_width=64, resize_height=64, frame_interval=4,
                     csv_file=os.path.join(workdir, "corpus.csv"))
        with timer.stage("crf_ladder_sweep_sharded"):
            stats = run_sweep_sharded(corpus, cfg, crf_ladder=(23, 33),
                                      manifest_path=os.path.join(workdir, "manifest.jsonl"), device=dev)
        with timer.stage("sharded_batch_analysis"):
            results = analyze_clips_sharded(corpus, 64, 64, frame_interval=4, device=dev)
        if rank0:
            print(f"corpus: {corpus}")
            print(f"sweep: {stats}  (rerun me: already-done items are skipped)")
            for path, res in zip(corpus, results):
                print(json.dumps({"clip": path, **dataclasses.asdict(res)}))
            print(json.dumps(timer.summary(), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
