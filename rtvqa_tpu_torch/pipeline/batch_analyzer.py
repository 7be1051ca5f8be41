"""Batched complexity over a same-resolution corpus of clips, sharded over a
("clip", "frame") mesh (counterpart of ``rtvqa_tpu/pipeline/batch_analyzer.py``).

Rank 0 decodes every clip's sampled frames, stacks them into (C, N, H, W)
batches and scatters each rank its block: clips over the mesh's "clip"
dimension, each clip's frames over its "frame" dimension. Every rank runs
``parallel/sharding.py::sharded_complexity_suite`` on its block. Clips of
differing lengths are zero-padded to a bucket of the corpus maximum with a
per-clip valid count, which the masked EWM makes exact; padded clips fill
the last clip shard and are dropped from the result.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from rtvqa_tpu_torch.io import video as vio
from rtvqa_tpu_torch.metrics.complexity import METRIC_ORDER, ComplexityResult, _pad_bucket
from rtvqa_tpu_torch.obs.logging import get_logger
from rtvqa_tpu_torch.parallel.launch import (
    ShardFailure,
    broadcast_object,
    comm_device,
    scatter,
    share,
    world,
)
from rtvqa_tpu_torch.parallel.sharding import (
    Mesh,
    make_mesh,
    sharded_complexity_suite,
)

logger = get_logger("rtvqa_tpu_torch.batch")


def _stack_corpus(video_paths: Sequence[str], frame_interval: int, mesh: Mesh):
    """Decode and pad the corpus (rank 0): ``(planes, header)`` with planes
    (y, u, v, ts) of (C_pad, N_pad, ...) and header (shapes, n_valid, C)."""
    clips = [vio.decode_sampled(p, frame_interval) for p in video_paths]
    shapes = {(c.height, c.width) for c in clips}
    if len(shapes) != 1:
        raise ValueError(f"corpus must share one resolution, got {shapes}")
    clip_shards, frame_shards = mesh.shape
    c_pad = -(-len(clips) // clip_shards) * clip_shards
    n_max = max(c.y.shape[0] for c in clips)
    n_pad = _pad_bucket(n_max, bucket=max(16, frame_shards))
    n_pad = -(-n_pad // frame_shards) * frame_shards  # the frame axis divides evenly
    h, w = clips[0].y.shape[1:]
    ch, cw = clips[0].u.shape[1:]
    y = np.zeros((c_pad, n_pad, h, w), np.uint8)
    u = np.zeros((c_pad, n_pad, ch, cw), np.uint8)
    v = np.zeros((c_pad, n_pad, ch, cw), np.uint8)
    ts = np.zeros((c_pad, n_pad), np.float32)
    n_valid = [0] * c_pad
    for i, c in enumerate(clips):
        n = c.y.shape[0]
        y[i, :n], u[i, :n], v[i, :n] = c.y, c.u, c.v
        ts[i, :n] = c.timestamps_ms
        n_valid[i] = n
    planes = (y, u, v, ts)
    return planes, ([a.shape for a in planes], n_valid, len(clips))


def _scatter_corpus(mesh: Mesh, planes, header):
    """Each rank's block of (y, u, v, ts) on its device; rank 0 passes the
    stacked ``planes``, the others None."""
    shapes, n_valid, _ = header
    n_clip, n_frame = mesh.shape
    local = [(s[0] // n_clip, s[1] // n_frame, *s[2:]) for s in shapes]
    sizes = [int(np.prod(s)) * (4 if len(s) == 2 else 1) for s in local]  # ts is f32
    parts = None
    if planes is not None:
        stage = comm_device(mesh.group)
        parts = []
        for r in range(n_clip * n_frame):
            c, f = divmod(r, n_frame)
            blocks = [a[c * s[0]:(c + 1) * s[0], f * s[1]:(f + 1) * s[1]]
                      for a, s in zip(planes, local)]
            flat = np.concatenate([np.ascontiguousarray(b).view(np.uint8).reshape(-1) for b in blocks])
            parts.append(torch.from_numpy(flat).to(stage))
    flat = scatter(parts, sum(sizes), 0, mesh.group, mesh.device)
    y, u, v, ts = torch.split(flat, sizes)
    # ts's bytes start at an offset that need not be 4-aligned: copy before the f32 view.
    y, u, v, ts = (a.view(s) for a, s in zip((y, u, v, ts.clone().view(torch.float32)), local))
    c0 = mesh.rank("clip") * local[0][0]
    return y, u, v, ts, n_valid[c0:c0 + local[0][0]]


def analyze_clips_sharded(
    video_paths: Sequence[str],
    resize_width: int,
    resize_height: int,
    frame_interval: int = 10,
    smoothing_factor: float = 0.8,
    mesh: Optional[Mesh] = None,
    n_clip_shards: Optional[int] = None,
    motion_search: str = "pyramid",
    device: str | torch.device | None = None,
) -> list[ComplexityResult]:
    """The complexity suite for a same-resolution corpus, sharded over
    ``mesh`` (default: 2 x n/2 over the whole world when its size n is even
    and above 1, else 1 x n, or ``n_clip_shards`` x n/``n_clip_shards``;
    without a process group, a world of one on ``device``, the card by
    default). Every rank of the world calls it and gets one
    ``ComplexityResult`` per input clip, in order. A corpus of mixed
    resolutions raises ``ValueError`` on rank 0 (``ShardFailure`` on the
    others)."""
    with world(device if mesh is None else mesh.device) as dev:
        if mesh is None:
            n = dist.get_world_size()
            n_clip = n_clip_shards or (2 if n % 2 == 0 and n > 1 else 1)
            mesh = make_mesh(n_clip=n_clip, n_frame=n // n_clip, device=dev)
        fn = sharded_complexity_suite(
            mesh, resize_h=resize_height, resize_w=resize_width,
            alpha=float(smoothing_factor), motion_search=motion_search,
        )

        def on_mesh():
            planes = header = None
            if dist.get_rank() == 0:
                try:
                    planes, header = _stack_corpus(video_paths, frame_interval, mesh)
                except Exception as e:
                    broadcast_object(f"{type(e).__name__}: {e}", 0, mesh.group)
                    raise
            header = broadcast_object(header, 0, mesh.group)
            if isinstance(header, str):
                raise ShardFailure(f"rank 0 failed: {header}")
            if planes is not None:
                logger.info("Batched complexity: %d clip(s) of %d frames over a %d x %d mesh",
                            header[2], header[0][0][1], *mesh.shape)
            y, u, v, ts, n_valid = _scatter_corpus(mesh, planes, header)
            out = fn(y, u, v, ts, torch.tensor(n_valid))
            packed = torch.stack([out[k] for k in METRIC_ORDER], dim=1).cpu()
            return [ComplexityResult(**{k: float(packed[i, j]) for j, k in enumerate(METRIC_ORDER)})
                    for i in range(header[2])]

        return share(on_mesh, mesh.member)
