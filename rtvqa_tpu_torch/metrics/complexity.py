"""The eight-metric scene-complexity suite (counterpart of
``rtvqa_tpu/metrics/complexity.py``).

Same sampled-frame semantics as the JAX suite: with sampled frames
``s[0..n-1]``, motion runs on the pairs ``(s[j], s[j+1])``; the spatial
metrics (DCT energy, gray entropy, Canny edges, ORB count, color entropy) on
``s[1:]``; temporal DCT on consecutive frames of ``s[1:]``; framerate
variation on consecutive sampled timestamps. Each series is EWM-smoothed
over its valid slots and averaged.

Inputs are padded along the frame axis to a multiple of 16 (``_pad_bucket``)
with a validity count, exactly as the JAX suite pads them, and the padded
slots are masked out of every smoothed mean.

``motion_impl`` selects the two hand-written CUDA kernels ("kernel": YUV420
-> gray and block-match motion) or their plain PyTorch versions ("plain").
``None`` means "kernel" for CUDA tensors and "plain" for CPU tensors;
"kernel" on a CPU tensor raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from rtvqa_tpu_torch.device import get_device
from rtvqa_tpu_torch.ops.color import yuv420_to_gray
from rtvqa_tpu_torch.ops.dct import dct_energy, dct_table, temporal_dct_abs_diff
from rtvqa_tpu_torch.ops.edges import canny_edge_count
from rtvqa_tpu_torch.ops.histogram import color_entropy_sampled, gray_entropy
from rtvqa_tpu_torch.ops.motion import (
    block_match_motion,
    block_match_motion_pyramid_series,
    fps_variation,
)
from rtvqa_tpu_torch.ops.orb import orb_keypoint_count
from rtvqa_tpu_torch.ops.resize import bilinear_table, resize_cols, resize_rows
from rtvqa_tpu_torch.ops.scan import ewm_mean_masked, masked_mean

# The reference hard-codes ORB's input size to 64x64 whatever the config's
# resize dims (complexity_metrics.py:379,386); the metric's scale depends on it.
ORB_SIZE = 64

METRIC_ORDER = (
    "motion", "dct", "histogram", "edge", "orb", "color", "temporal_dct", "framerate",
)
MOTION_IMPLS = ("kernel", "plain")


@dataclasses.dataclass(frozen=True)
class ComplexityResult:
    """The 8-tuple of ``calculate_average_scene_complexity`` with true labels
    (same fields as ``rtvqa_tpu.metrics.complexity.ComplexityResult``)."""

    motion: float
    dct: float
    histogram: float
    edge: float
    orb: float
    color: float
    temporal_dct: float
    framerate: float

    def as_tuple(self) -> tuple:
        # Reference return order (complexity_metrics.py:301-310).
        return (
            self.motion, self.dct, self.histogram, self.edge,
            self.orb, self.color, self.temporal_dct, self.framerate,
        )


def _smoothed_masked_mean(series: torch.Tensor, valid: torch.Tensor, alpha: float) -> torch.Tensor:
    sm, v = ewm_mean_masked(series, alpha, valid)
    return masked_mean(sm, v)


def _pad_bucket(n: int, bucket: int = 16) -> int:
    """Round up to a multiple of ``bucket`` (at least one bucket)."""
    return max(bucket, ((n + bucket - 1) // bucket) * bucket)


def _resize(x: torch.Tensor, rh: torch.Tensor | None, rw: torch.Tensor | None) -> torch.Tensor:
    x = x if rh is None else resize_rows(x, rh)
    return x if rw is None else resize_cols(x, rw)


class ComplexitySuite(nn.Module):
    """The suite for one frame size; its buffers hold the resize and DCT
    tables (None where a resize is the identity)."""

    def __init__(
        self,
        height: int,
        width: int,
        resize_h: int,
        resize_w: int,
        *,
        alpha: float = 0.8,
        block: int = 16,
        radius: int = 8,
        edge_low: float = 100.0,
        edge_high: float = 200.0,
        motion_impl: str = "plain",
        motion_search: str = "pyramid",
    ) -> None:
        super().__init__()
        if motion_impl not in MOTION_IMPLS:
            raise ValueError(f"motion_impl must be one of {MOTION_IMPLS}, got {motion_impl!r}")
        if motion_search not in ("pyramid", "full"):
            raise ValueError(f"motion_search must be 'pyramid' or 'full', got {motion_search!r}")
        self.resize_h, self.resize_w = resize_h, resize_w
        self.alpha, self.block, self.radius = alpha, block, radius
        self.edge_low, self.edge_high = edge_low, edge_high
        self.motion_impl, self.motion_search = motion_impl, motion_search
        cpu = torch.device("cpu")

        def table(dst: int, src: int) -> torch.Tensor | None:
            return None if dst == src else bilinear_table(dst, src, cpu)

        self.register_buffer("rh", table(resize_h, height))
        self.register_buffer("rw", table(resize_w, width))
        self.register_buffer("orb_rh", table(ORB_SIZE, height))
        self.register_buffer("orb_rw", table(ORB_SIZE, width))
        self.register_buffer("dct_h", dct_table(resize_h, cpu))
        self.register_buffer("dct_w", dct_table(resize_w, cpu))

    def _gray_and_motion(self, y: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
        if self.motion_impl == "kernel":
            if y.device.type != "cuda":
                raise ValueError("motion_impl='kernel' needs CUDA tensors; use 'plain' on the CPU")
            from rtvqa_tpu_torch.kernels.gray import yuv420_to_gray_cuda
            from rtvqa_tpu_torch.kernels.motion import block_match_motion_cuda

            gray, full_search = yuv420_to_gray_cuda(y, u, v), block_match_motion_cuda
        else:
            gray, full_search = yuv420_to_gray(y, u, v), block_match_motion
        if self.motion_search == "pyramid":
            motion = block_match_motion_pyramid_series(
                gray, block=self.block, radius=self.radius, impl=self.motion_impl
            )
        else:
            motion = full_search(gray[:-1], gray[1:], block=self.block, radius=self.radius)
        return gray, motion

    def series(self, y: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> dict[str, torch.Tensor]:
        """Per-frame values of the (M, H, W) YUV420 series ``y, u, v``, each
        (M-1,): slot j holds frame j+1 against frame j (motion, temporal
        DCT) or frame j+1 alone (DCT energy, gray entropy, edges, ORB,
        color entropy). The counterpart of ``rtvqa_tpu/parallel/
        sharding.py::_per_frame_values_series``; ``forward`` smooths these
        series and the streaming accumulator gathers them."""
        gray, motion = self._gray_and_motion(y, u, v)
        gray_rs_all = _resize(gray, self.rh, self.rw)
        gray_rs = gray_rs_all[1:]
        return {
            "motion": motion,
            "dct": dct_energy(gray_rs),
            "histogram": gray_entropy(gray_rs),
            "edge": canny_edge_count(gray_rs, self.edge_low, self.edge_high),
            "orb": orb_keypoint_count(_resize(gray[1:], self.orb_rh, self.orb_rw)),
            "color": color_entropy_sampled(
                y[1:], u[1:], v[1:], self.resize_h, self.resize_w, rw=self.rw
            ),
            "temporal_dct": temporal_dct_abs_diff(gray_rs_all[:-1], gray_rs, self.dct_h, self.dct_w),
        }

    def forward(
        self,
        y: torch.Tensor,              # (N, H, W) uint8 sampled luma
        u: torch.Tensor,              # (N, ceil(H/2), ceil(W/2)) uint8
        v: torch.Tensor,
        timestamps_ms: torch.Tensor,  # (N,) f32
        n_valid: int,                 # number of real (unpadded) frames
    ) -> dict[str, torch.Tensor]:
        """The 8 smoothed-mean scalars keyed by metric name."""
        n_pad = y.shape[0]
        idx = torch.arange(n_pad, device=y.device)
        s = self.series(y, u, v)
        pair_valid = idx[1:] < n_valid
        tdct_valid = idx[2:] < n_valid
        fps_series, fps_valid = fps_variation(timestamps_ms, idx < n_valid)

        a = self.alpha
        out = {k: _smoothed_masked_mean(s[k], pair_valid, a)
               for k in ("motion", "dct", "histogram", "edge", "orb", "color")}
        # Temporal DCT pairs consecutive frames of s[1:]: slots 1.. of its series.
        out["temporal_dct"] = _smoothed_masked_mean(s["temporal_dct"][1:], tdct_valid, a)
        out["framerate"] = _smoothed_masked_mean(fps_series, fps_valid, a)
        return out


def complexity_suite(
    y: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    timestamps_ms: torch.Tensor,
    n_valid: int,
    *,
    resize_h: int,
    resize_w: int,
    alpha: float = 0.8,
    block: int = 16,
    radius: int = 8,
    edge_low: float = 100.0,
    edge_high: float = 200.0,
    motion_impl: str = "plain",
    motion_search: str = "pyramid",
) -> dict[str, torch.Tensor]:
    """Functional form of :class:`ComplexitySuite` on padded batches."""
    suite = ComplexitySuite(
        y.shape[-2], y.shape[-1], resize_h, resize_w, alpha=alpha, block=block,
        radius=radius, edge_low=edge_low, edge_high=edge_high,
        motion_impl=motion_impl, motion_search=motion_search,
    ).to(y.device)
    return suite(y, u, v, timestamps_ms, n_valid)


def calculate_average_scene_complexity(
    clip,
    resize_width: int,
    resize_height: int,
    smoothing_factor: float = 0.8,
    block: int = 16,
    radius: int = 8,
    motion_impl: str | None = None,
    motion_search: str = "pyramid",
    device: str | torch.device | None = None,
) -> ComplexityResult:
    """Pad a ``DecodedClip`` to the frame bucket, move it to ``device``
    (default: the card), run the suite, and return the reference-ordered
    result."""
    dev = get_device(device)
    if motion_impl is None:
        motion_impl = "kernel" if dev.type == "cuda" else "plain"
    if motion_impl == "kernel" and dev.type != "cuda":
        raise ValueError("motion_impl='kernel' needs a CUDA device; use 'plain' on the CPU")
    n = int(clip.y.shape[0])
    n_pad = _pad_bucket(n)

    def put(a: np.ndarray) -> torch.Tensor:
        width = [(0, n_pad - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        return torch.from_numpy(np.pad(a, width)).to(dev)

    out = complexity_suite(
        put(clip.y), put(clip.u), put(clip.v),
        put(clip.timestamps_ms.astype(np.float32)), n,
        resize_h=resize_height, resize_w=resize_width, alpha=float(smoothing_factor),
        block=block, radius=radius, motion_impl=motion_impl, motion_search=motion_search,
    )
    packed = torch.stack([out[k] for k in METRIC_ORDER]).cpu()
    return ComplexityResult(**{k: float(packed[i]) for i, k in enumerate(METRIC_ORDER)})
