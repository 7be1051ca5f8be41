"""Multi-device execution: a ("clip", "frame") device mesh, the sharded
complexity suite and the sharded quality step (counterpart of
``rtvqa_tpu/parallel/sharding.py``).

Clips shard over the mesh's "clip" dimension (data parallelism); the frame
axis of each clip shards over its "frame" dimension (sequence
parallelism). Every metric of frame g depends only on frames g and g-1, so
a frame shard needs one frame of its left neighbour: a one-frame halo.

The JAX package is one program over all devices (``shard_map``); here each
rank is a process that calls these functions on its own shard (see
``launch.py``), and the functions run the single-device bodies on it:

* ``sharded_complexity_suite``: each frame rank prepends the halo frame
  (zeros on frame rank 0, whose slot-0 value is masked out) and runs
  ``ComplexitySuite.series`` per local clip, on kernels 1 and 2 for CUDA
  tensors; the per-frame scalars are all-gathered over "frame" and reduced
  by ``metrics.complexity.smooth_series``, the single-device suite's own
  tail; the results are all-gathered over "clip".
* ``sharded_quality_chunk_step``: each frame rank runs the quality chunk
  body (``chunk_kernels``, kernels 3, 5, 6 and 7 at every width, or
  ``chunk_plain``) on its slice of the chunk, with the left
  neighbour's blurred last ref luma as its motion carry; the packed series
  are all-gathered, and the last frame rank's blur carry goes to every rank.

Collective bytes per step: one frame (or one blurred frame) per rank for
the halo, the per-frame scalars, and one blurred frame for the carry.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from rtvqa_tpu_torch.metrics.complexity import METRIC_ORDER, ComplexitySuite, smooth_series
from rtvqa_tpu_torch.metrics.complexity_streaming import VALUE_KEYS
from rtvqa_tpu_torch.metrics.full_reference import chunk_kernels, chunk_plain
from rtvqa_tpu_torch.parallel.launch import agree, all_gather, broadcast, init_from_env
from rtvqa_tpu_torch.vmaf.filters import filter1d_sep
from rtvqa_tpu_torch.vmaf.motion import FILTER_5

QUALITY_IMPLS = ("auto", "kernel", "plain")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ("clip", "frame") ``DeviceMesh`` over the first ranks of the world,
    the group of all its ranks, and this rank's device. Group rank r of
    ``group`` sits at (clip, frame) = divmod(r, n_frame)."""

    device_mesh: DeviceMesh
    group: Any
    device: torch.device

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.device_mesh.shape)

    @property
    def member(self) -> bool:
        """Whether this rank is in the mesh."""
        return self.device_mesh.get_coordinate() is not None

    def rank(self, dim: str) -> int:
        """This rank's coordinate along ``dim`` ("clip" or "frame")."""
        return self.device_mesh.get_local_rank(dim)

    def dim_group(self, dim: str):
        """The group of the ranks that share this rank's other coordinate."""
        return self.device_mesh.get_group(dim)


def make_mesh(
    n_clip: int = 1,
    n_frame: Optional[int] = None,
    ranks: Optional[int] = None,
    device: str | torch.device | None = None,
) -> Mesh:
    """Build an ``n_clip`` x ``n_frame`` mesh over the first ``ranks`` ranks
    of the world (default: all; ``n_frame`` defaults to ``ranks // n_clip``).
    Every rank of the world calls it (it makes process groups); ranks
    outside the mesh get one with ``member`` False. Needs a process group
    (``launch.world`` or ``init_from_env``); ``device`` is this rank's, as
    ``init_from_env`` binds it."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: use launch.world() or init_from_env()")
    world_size = dist.get_world_size()
    total = world_size if ranks is None else int(ranks)
    if not 1 <= total <= world_size:
        raise ValueError(f"ranks must lie in [1, {world_size}], got {ranks}")
    if n_frame is None:
        n_frame = total // n_clip
    if n_clip < 1 or n_clip * n_frame != total:
        raise ValueError(f"mesh {n_clip} x {n_frame} does not cover {total} ranks")
    dev = init_from_env(device)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = DeviceMesh(device_type, torch.arange(total).view(n_clip, n_frame),
                    mesh_dim_names=("clip", "frame"))
    group = dist.group.WORLD if total == world_size else dist.new_group(list(range(total)))
    return Mesh(dm, group, dev)


def _halo(x: torch.Tensor, fid: int, group) -> torch.Tensor:
    """The frame before ``x[:, 0]`` along the sharded frame axis: the left
    neighbour's last local frame, zeros on frame rank 0. ``x``: (C, N, ...)."""
    lasts = all_gather(x[:, -1:], group)
    return torch.zeros_like(lasts[0]) if fid == 0 else lasts[fid - 1]


def sharded_complexity_suite(
    mesh: Mesh,
    *,
    resize_h: int,
    resize_w: int,
    alpha: float = 0.8,
    block: int = 16,
    radius: int = 8,
    edge_low: float = 100.0,
    edge_high: float = 200.0,
    motion_search: str = "pyramid",
    motion_impl: str = "auto",
) -> Callable[..., dict[str, torch.Tensor]]:
    """The complexity suite over ``mesh``.

    Returns ``fn(y, u, v, ts_ms, n_valid) -> dict of (C,) f32`` that every
    rank of the mesh calls with its own shard: ``y`` (C/n_clip, N/n_frame,
    H, W) uint8, ``u``/``v`` likewise at chroma size, ``ts_ms`` (C/n_clip,
    N/n_frame) and ``n_valid`` (C/n_clip,) for its clips. Every rank gets
    all C clips' results. ``motion_impl``: "kernel" (kernels 1 and 2),
    "plain", or "auto" (the kernels for CUDA tensors, plain for CPU)."""

    def fn(y, u, v, ts_ms, n_valid):
        impl = motion_impl
        if impl == "auto":
            impl = "kernel" if y.device.type == "cuda" else "plain"
        frames, fid = mesh.dim_group("frame"), mesh.rank("frame")
        err, vals = None, None
        ext = [torch.cat([_halo(a, fid, frames), a], dim=1) for a in (y, u, v)]
        try:
            suite = ComplexitySuite(
                y.shape[-2], y.shape[-1], resize_h, resize_w, alpha=alpha, block=block,
                radius=radius, edge_low=edge_low, edge_high=edge_high,
                motion_impl=impl, motion_search=motion_search,
            ).to(y.device)
            # Value j of a local clip is frame j against frame j-1 (the halo for j = 0).
            per_clip = [suite.series(*(a[c] for a in ext)) for c in range(y.shape[0])]
            vals = torch.stack([
                torch.stack([s[k].float() for k in VALUE_KEYS] + [ts_ms[c].float()])
                for c, s in enumerate(per_clip)
            ])
        except Exception as e:  # reported to every rank before the next collective
            err = e
        agree(err, mesh.group)
        full = torch.cat(all_gather(vals, frames), dim=2)   # (C_local, 8, N)
        out = []
        for c in range(full.shape[0]):
            # Global slot 0 holds frame 0 against the zero halo: the suite's series start at slot 1.
            s = {k: full[c, i, 1:] for i, k in enumerate(VALUE_KEYS)}
            r = smooth_series(s, full[c, len(VALUE_KEYS)], int(n_valid[c]), alpha)
            out.append(torch.stack([r[k] for k in METRIC_ORDER]))
        res = torch.cat(all_gather(torch.stack(out), mesh.dim_group("clip")))
        return {k: res[:, i] for i, k in enumerate(METRIC_ORDER)}

    return fn


def sharded_quality_chunk_step(
    mesh: Mesh, vif_egl=None, adm_egl=None, impl: str = "auto"
) -> Callable[..., tuple[torch.Tensor, torch.Tensor]]:
    """One lockstep chunk of the full-reference engine over a 1 x n mesh.

    Returns ``fn(ry, ru, rv, dy, du, dv, prev_blur, has_prev) -> (packed
    (len(CHUNK_KEYS), chunk) f32, next_carry (H, W) f32)``, called by every
    rank with its slice of the chunk (chunk / n frames of each plane);
    ``prev_blur`` is the previous chunk's carry (zeros before the first) and
    ``has_prev`` whether the chunk has a predecessor. Both results are the
    same on every rank; ``next_carry`` is the last frame rank's carry.

    ``impl``: "kernel" (``chunk_kernels``), "plain" (``chunk_plain``) or
    "auto" (by the inputs' device). The halo is the left neighbour's last
    ref luma blurred by the plain FILTER_5 filter, as the JAX package's
    ``_blur_halo_ppermute``: on the kernel path a shard's first SAD
    compares it with the kernel's blur (equal within ~1e-6 relative; both
    are exact 5-tap f32 filters summed in another order). Frame rank 0
    takes ``prev_blur``, so at one rank the step is the single-device body
    on the same inputs."""
    if impl not in QUALITY_IMPLS:
        raise ValueError(f"impl must be one of {QUALITY_IMPLS}, got {impl!r}")
    if mesh.shape[0] != 1:
        raise ValueError(f"the quality step shards frames only: mesh {mesh.shape} is not 1 x n")
    n_frame = mesh.shape[1]

    def fn(ry, ru, rv, dy, du, dv, prev_blur, has_prev):
        kernels = impl == "kernel" or (impl == "auto" and ry.device.type == "cuda")
        body = chunk_kernels if kernels else chunk_plain
        frames, fid = mesh.dim_group("frame"), mesh.rank("frame")
        err, packed, carry = None, None, None
        last = filter1d_sep(ry[-1].float(), FILTER_5)
        halos = all_gather(last, frames)
        pb = prev_blur.to(ry.device, torch.float32) if fid == 0 else halos[fid - 1]
        try:
            # Frame ranks > 0 always have a predecessor: the halo'd neighbour frame.
            packed, carry = body(ry, ru, rv, dy, du, dv, pb, bool(fid != 0 or has_prev),
                                 vif_egl, adm_egl)
        except Exception as e:  # reported to every rank before the next collective
            err = e
        agree(err, mesh.group)
        packed = torch.cat(all_gather(packed, frames), dim=1)
        return packed, broadcast(carry, n_frame - 1, frames)

    return fn


def sharded_quality_step(
    mesh: Mesh, vif_egl=None, adm_egl=None, impl: str = "auto"
) -> Callable[..., torch.Tensor]:
    """The whole-clip form of ``sharded_quality_chunk_step``:
    ``fn(ry, ru, rv, dy, du, dv) -> packed (len(CHUNK_KEYS), N)``, each
    rank passing its slice of the clip. The carry is zeros and the global
    slot-0 motion SAD stays raw (against the zero carry; callers zero it,
    as the chunk loop's ``has_prev`` masking does)."""
    step = sharded_quality_chunk_step(mesh, vif_egl, adm_egl, impl)

    def fn(ry, ru, rv, dy, du, dv):
        zeros = torch.zeros(ry.shape[-2:], dtype=torch.float32, device=ry.device)
        return step(ry, ru, rv, dy, du, dv, zeros, True)[0]

    return fn
