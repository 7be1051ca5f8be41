"""Full-reference quality (PSNR/SSIM/VMAF) of one clip pair with the frame
axis sharded over a mesh, streaming in bounded chunks (counterpart of
``rtvqa_tpu/pipeline/quality_sharded.py``).

Rank 0 decodes both streams and runs the single-device chunk loop
(``metrics/full_reference.py::_quality_chunk_loop``, which repeat-pads a
ragged last chunk) with a runner in place of the chunk body: per chunk it
broadcasts a header (the planes' shapes), scatters each rank's slice of
the chunk, and every rank runs ``parallel/sharding.py::
sharded_quality_chunk_step`` on its slice. The other ranks of the mesh loop
on the headers: a header of None ends the loop, an error text raises, so
every rank leaves the loop with rank 0. Pooling
(``pool_full_reference``) runs on rank 0 and the result goes to every rank.

Under NCCL rank 0 stages each chunk on its card (pinned upload) and
scatters from there; under gloo the chunk stays on the host and each rank
uploads its slice. Rank 0 holds a whole chunk, its packed copy and the
prefetched next chunk: about 3 x 6.2 MB x ``chunk`` at 1080p (10 GB at 8
ranks x 64 frames).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from rtvqa_tpu_torch.io.stream import VideoStream, prefetch, stage_to_device
from rtvqa_tpu_torch.metrics.full_reference import (
    _quality_chunk_loop,
    auto_chunk,
    pool_full_reference,
    resolve_precision,
)
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
    sharded_quality_chunk_step,
)

logger = get_logger("rtvqa_tpu_torch.quality_sharded")


def _receive(mesh: Mesh, shapes, parts: Optional[list[torch.Tensor]]) -> list[torch.Tensor]:
    """This rank's slice of the chunk's six planes, each (chunk / n, h, w),
    on its device; ``parts`` (rank 0 only) holds every rank's slices packed."""
    n = mesh.shape[1]
    local = [(s[0] // n, *s[1:]) for s in shapes]
    sizes = [int(np.prod(s)) for s in local]
    flat = scatter(parts, sum(sizes), 0, mesh.group, mesh.device)
    return [p.view(s) for p, s in zip(torch.split(flat, sizes), local)]


def sharded_quality_loop(
    mesh: Mesh,
    step: Callable,
    open_pair: Optional[Callable[[torch.device], tuple]] = None,
) -> tuple[Optional[dict], int]:
    """The lockstep chunk loop over ``mesh`` (every rank of the mesh calls
    it). On rank 0, ``open_pair(stage_device)`` returns ``(chunk, ref_it,
    dis_it)``: a chunk size divisible by the mesh's frame count and lockstep
    ``StagedFrameBatch`` iterators staged on ``stage_device``. Returns
    (series, n_frames) on rank 0 and (None, 0) on the other ranks.

    A failure on rank 0 outside the step (opening, decoding) reaches the
    other ranks as an error header; a failure inside the step raises on
    every rank (``launch.agree``)."""
    n = mesh.shape[1]
    if dist.get_rank(mesh.group) != 0:
        carry, has_prev = None, False
        while (header := broadcast_object(None, 0, mesh.group)) is not None:
            if isinstance(header, str):
                raise ShardFailure(f"rank 0 failed: {header}")
            local = _receive(mesh, header, None)
            if carry is None:
                carry = torch.zeros(header[0][1:], dtype=torch.float32, device=mesh.device)
            _, carry = step(*local, carry, has_prev)
            has_prev = True
        return None, 0

    stage = comm_device(mesh.group)

    def runner(ry, ru, rv, dy, du, dv, carry, has_prev, vif_egl, adm_egl):
        planes = (ry, ru, rv, dy, du, dv)
        per = planes[0].shape[0] // n
        parts = [torch.cat([p[r * per:(r + 1) * per].reshape(-1) for p in planes]) for r in range(n)]
        shapes = [tuple(p.shape) for p in planes]
        broadcast_object(shapes, 0, mesh.group)
        return step(*_receive(mesh, shapes, parts), carry, has_prev)

    try:
        chunk, ref_it, dis_it = open_pair(stage)
        if chunk % n:
            raise ValueError(f"chunk {chunk} is not a multiple of the mesh's {n} frame ranks")
        try:
            series, n_frames = _quality_chunk_loop(ref_it, dis_it, chunk, None, None, stage, None,
                                                   runner=runner)
        finally:
            ref_it.close()
            dis_it.close()
    except ShardFailure:
        raise
    except Exception as e:
        broadcast_object(f"{type(e).__name__}: {e}", 0, mesh.group)
        raise
    broadcast_object(None, 0, mesh.group)
    return series, n_frames


def analyze_full_reference_sharded(
    ref_path: str,
    dis_path: str,
    mesh: Optional[Mesh] = None,
    vmaf_model_path: Optional[str] = None,
    n_devices: Optional[int] = None,
    chunk: Optional[int] = None,
    quality_precision: Optional[str] = None,
    impl: str = "auto",
    device: str | torch.device | None = None,
) -> dict:
    """Full-reference metrics with the frame axis sharded over ``mesh``
    (default: a 1 x n mesh over the first ``n_devices`` ranks of the world,
    all by default; without a process group, a world of one on ``device``,
    the card by default). Every rank of the world calls it and gets the
    same dict as ``metrics.full_reference.analyze_full_reference``.

    ``chunk`` frames per step (default ``auto_chunk`` times the frame
    ranks: ``auto_chunk`` is the per-card bound) is rounded up to a
    multiple of the frame ranks. ``impl``: "kernel", "plain" or "auto"
    (kernels on the card). ``quality_precision`` as in
    ``analyze_full_reference``."""
    from rtvqa_tpu_torch.vmaf.model import load_model

    resolve_precision(quality_precision)
    model = load_model(vmaf_model_path) if vmaf_model_path else None
    vif_egl = model.vif_enhn_gain_limit if model else None
    adm_egl = model.adm_enhn_gain_limit if model else None
    with world(device if mesh is None else mesh.device) as dev:
        if mesh is None:
            mesh = make_mesh(n_clip=1, ranks=n_devices, device=dev)
        n = mesh.shape[1]
        step = sharded_quality_chunk_step(mesh, vif_egl, adm_egl, impl)

        def open_pair(stage):
            with VideoStream(ref_path, 1, 1) as probe:
                w, h = probe.info.width, probe.info.height
            with VideoStream(dis_path, 1, 1) as probe:
                wd, hd = probe.info.width, probe.info.height
            if (h, w) != (hd, wd):
                raise ValueError(f"resolution mismatch: {w}x{h} vs {wd}x{hd}")
            c = -(-(chunk or auto_chunk(w, h) * n) // n) * n
            logger.info("Sharded quality: %dx%d in chunks of %d over %d rank(s)", w, h, c, n)
            its = [prefetch(stage_to_device(VideoStream(p, 1, c), c, stage), depth=1)
                   for p in (ref_path, dis_path)]
            return (c, *its)

        def on_mesh():
            series, n_frames = sharded_quality_loop(
                mesh, step, open_pair if dist.get_rank() == 0 else None)
            if dist.get_rank() != 0:
                return None
            if n_frames == 0:
                return {"n_frames": 0}
            return pool_full_reference(series, n_frames, vmaf_model_path, model=model)

        return share(on_mesh, mesh.member)
