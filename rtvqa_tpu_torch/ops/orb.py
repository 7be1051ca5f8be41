"""ORB keypoint count (counterpart of the count path of
``rtvqa_tpu/ops/orb.py``).

Dense FAST-9/16 score map (max over the 16 length-9 ring arcs of the minimum
signed contrast), strict 3x3 non-max suppression, the ORB edge border masked
out, counted over an ``nlevels`` image pyramid and capped at ``nfeatures``.
BRIEF descriptors (``orb_features``) are off the complexity path and not
ported yet.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from rtvqa_tpu_torch.ops.resize import resize_bilinear

# Bresenham circle of radius 3, clockwise from 12 o'clock (dy, dx).
CIRCLE16 = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _ring_samples(g: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (16, ..., H, W) circle samples, zero-padded border."""
    h, w = g.shape[-2], g.shape[-1]
    p = F.pad(g, (3, 3, 3, 3))
    return torch.stack(
        [p[..., 3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w] for dy, dx in CIRCLE16]
    )


def _max_arc_min9(diffs: torch.Tensor) -> torch.Tensor:
    """max over the 16 circular arcs of length 9 of the min along the arc;
    ``diffs`` is (16, ...). The arc minima come from doubling windows
    (2, 4, 8, then one more sample) — min is exact, so this equals the
    direct 9-term form."""
    def ahead(t: torch.Tensor, k: int) -> torch.Tensor:
        return torch.roll(t, -k, dims=0)   # ahead(t, k)[i] = t[(i + k) % 16]

    m2 = torch.minimum(diffs, ahead(diffs, 1))
    m4 = torch.minimum(m2, ahead(m2, 2))
    m8 = torch.minimum(m4, ahead(m4, 4))
    m9 = torch.minimum(m8, ahead(diffs, 8))
    return torch.amax(m9, dim=0)


def _interior(h: int, w: int, margin: int, device: torch.device) -> torch.Tensor:
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return (ys >= margin) & (ys < h - margin) & (xs >= margin) & (xs < w - margin)


def fast_score(gray: torch.Tensor, threshold: float = 20.0) -> torch.Tensor:
    """Dense FAST-9/16 corner-score map over (..., H, W); 0 = not a corner."""
    g = gray.float()
    bright = _ring_samples(g) - g[None]
    score = torch.maximum(_max_arc_min9(bright), _max_arc_min9(-bright))
    h, w = g.shape[-2], g.shape[-1]
    score = torch.where(_interior(h, w, 3, g.device), score, 0.0)
    return torch.where(score > threshold, score, 0.0)


def _nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep strict local maxima of the score map in their 3x3 neighbourhood."""
    h, w = score.shape[-2], score.shape[-1]
    p = F.pad(score, (1, 1, 1, 1), value=float("-inf"))
    neigh = [
        p[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
        for dy in (-1, 0, 1)
        for dx in (-1, 0, 1)
        if dy or dx
    ]
    neigh_max = torch.amax(torch.stack(neigh), dim=0)
    return torch.where(score > neigh_max, score, 0.0)


def fast_keypoint_map(
    gray: torch.Tensor, threshold: float = 20.0, edge_threshold: int = 31
) -> torch.Tensor:
    """NMS'd FAST score map with the ORB edge border masked out."""
    h, w = gray.shape[-2], gray.shape[-1]
    if 2 * edge_threshold >= min(h, w):
        return torch.zeros(gray.shape, dtype=torch.float32, device=gray.device)
    score = _nms3x3(fast_score(gray, threshold))
    return torch.where(_interior(h, w, edge_threshold, gray.device), score, 0.0)


@functools.lru_cache(maxsize=8)
def pyramid_shapes(h: int, w: int, nlevels: int, scale_factor: float) -> tuple:
    """Static per-level (h, w) like OpenCV ORB's rounded pyramid sizes."""
    shapes = []
    for lvl in range(nlevels):
        s = scale_factor ** lvl
        shapes.append((max(1, int(round(h / s))), max(1, int(round(w / s)))))
    return tuple(shapes)


def orb_keypoint_count(
    gray: torch.Tensor,
    nfeatures: int = 500,
    nlevels: int = 8,
    scale_factor: float = 1.2,
    edge_threshold: int = 31,
    fast_threshold: float = 20.0,
) -> torch.Tensor:
    """Per-frame ORB keypoint count over (..., H, W), capped at ``nfeatures``.

    Levels whose border mask leaves no pixel contribute 0 and are skipped
    without resizing (at the reference's 64x64 input only level 0 counts).
    """
    h, w = gray.shape[-2], gray.shape[-1]
    total = torch.zeros(gray.shape[:-2], dtype=torch.float32, device=gray.device)
    for lh, lw in pyramid_shapes(h, w, nlevels, scale_factor):
        if 2 * edge_threshold >= min(lh, lw):
            continue
        level = gray if (lh, lw) == (h, w) else resize_bilinear(gray, lh, lw)
        kmap = fast_keypoint_map(level, fast_threshold, edge_threshold)
        total = total + torch.sum(kmap > 0, dim=(-2, -1)).float()
    return torch.clamp(total, max=float(nfeatures))
