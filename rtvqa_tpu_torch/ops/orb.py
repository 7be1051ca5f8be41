"""ORB keypoints and descriptors (counterpart of ``rtvqa_tpu/ops/orb.py``).

Dense FAST-9/16 score map (max over the 16 length-9 ring arcs of the minimum
signed contrast), strict 3x3 non-max suppression, the ORB edge border masked
out. ``orb_keypoint_count`` counts these corners over an ``nlevels`` image
pyramid, capped at ``nfeatures`` (the complexity metric).
``orb_features`` keeps a fixed K of them per frame, ranked by Harris
response, with intensity-centroid orientations and steered BRIEF-256
descriptors from the JAX package's seeded sampling pattern.

Ties rank as ``jax.lax.top_k`` ranks them, the lower flat index first (a
stable descending sort), also among the ``-inf`` slots that fill K when a
frame has fewer corners; their ``ys``/``xs`` are outputs too.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from rtvqa_tpu_torch.ops.edges import sobel_gradients
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


# --- fixed-K keypoints + BRIEF descriptors -----------------------------------


def harris_response(gray: torch.Tensor, block_size: int = 7, k: float = 0.04) -> torch.Tensor:
    """Dense Harris corner response over (..., H, W): R = det(M) - k tr(M)^2
    with M the 3x3-Sobel structure tensor summed over a ``block_size`` box
    (zero border), scaled as cv2 scales it. The box sums add the shifted
    rows, then the shifted columns, in the JAX op's order."""
    gx, gy = sobel_gradients(gray)
    r = block_size // 2

    def box_sum(x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2], x.shape[-1]
        p = F.pad(x, (r, r, r, r))
        rows = p[..., 0:h, r:r + w]
        for i in range(1, block_size):
            rows = rows + p[..., i:i + h, r:r + w]
        pr = F.pad(rows, (r, r))
        out = pr[..., :, 0:w]
        for j in range(1, block_size):
            out = out + pr[..., :, j:j + w]
        return out

    scale_sq = (1.0 / (4 * block_size * 255.0)) ** 2
    sxx = box_sum(gx * gx) * scale_sq
    syy = box_sum(gy * gy) * scale_sq
    sxy = box_sum(gx * gy) * scale_sq
    det = sxx * syy - sxy * sxy
    trace = sxx + syy
    return det - k * trace * trace


@functools.lru_cache(maxsize=4)
def _brief_pattern(n_bits: int = 256, patch: int = 24, seed: int = 7) -> np.ndarray:
    """(n_bits, 4) int32 sampling pairs (y1, x1, y2, x2), Gaussian BRIEF
    style: the JAX package's recipe on the same seeded generator."""
    rng = np.random.default_rng(seed)
    sigma = patch / 5.0
    pts = np.clip(
        np.rint(rng.normal(0.0, sigma, size=(n_bits, 4))), -(patch // 2), patch // 2
    ).astype(np.int32)
    pts.setflags(write=False)  # cached: callers must not mutate
    return pts


def orb_features(
    gray: torch.Tensor,
    k: int = 500,
    fast_threshold: float = 20.0,
    edge_threshold: int = 31,
    n_bits: int = 256,
) -> dict[str, torch.Tensor]:
    """Fixed-K keypoints, orientations and BRIEF descriptors of (B, H, W)
    frames.

    FAST corners are ranked by Harris response and the best K kept (cv2
    ORB's ``HARRIS_SCORE`` retention). Returns ``ys, xs`` (B, K) int32,
    ``score`` (B, K) Harris response, ``fast_score`` (B, K), ``valid`` (B,
    K) bool, ``angle`` (B, K) radians and ``desc`` (B, K, n_bits) bool;
    slots past a frame's corner count are invalid (score 0, desc False)."""
    b, h, w = gray.shape
    dev = gray.device
    kmap = fast_keypoint_map(gray, fast_threshold, edge_threshold)
    harris = harris_response(gray)
    rank = torch.where(kmap > 0, harris, float("-inf")).reshape(b, h * w)
    score, idx = torch.sort(rank, dim=1, descending=True, stable=True)
    score, idx = score[:, :k], idx[:, :k]
    valid = torch.isfinite(score)
    score = torch.where(valid, score, 0.0)
    ys, xs = idx // w, idx % w
    fast_sc = torch.take_along_dim(kmap.reshape(b, h * w), idx, dim=1)

    g = gray.float()
    batch = torch.arange(b, device=dev)

    # Orientation: intensity centroid over the radius-3 disc.
    r = 3
    gp = F.pad(g, (r, r, r, r))
    m01 = torch.zeros((b, idx.shape[1]), dtype=torch.float32, device=dev)
    m10 = torch.zeros_like(m01)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy * dy + dx * dx > r * r:
                continue
            yy = (ys + dy + r).clamp(0, h + 2 * r - 1)
            xx = (xs + dx + r).clamp(0, w + 2 * r - 1)
            val = gp[batch[:, None], yy, xx]
            m01 = m01 + dy * val
            m10 = m10 + dx * val
    # atan2, cos and sin in float64, rounded to f32: their last f32 bits
    # would differ between the CPU and the card, and a rotated offset
    # within an ULP of .5 would round the other way.
    angle64 = torch.atan2(m01.double(), m10.double())
    angle = angle64.float()

    # Steered BRIEF: the sampling pattern rotated by each keypoint's angle.
    pat = torch.from_numpy(_brief_pattern(n_bits).astype(np.float32)).to(dev)
    ca, sa = torch.cos(angle64).float()[..., None], torch.sin(angle64).float()[..., None]

    def rot(y: torch.Tensor, x: torch.Tensor):
        ry = y * ca + x * sa
        rx = -y * sa + x * ca
        return torch.round(ry).long(), torch.round(rx).long()

    def sample(y_off: torch.Tensor, x_off: torch.Tensor) -> torch.Tensor:
        yy = (ys[..., None] + y_off).clamp(0, h - 1)
        xx = (xs[..., None] + x_off).clamp(0, w - 1)
        return g[batch[:, None, None], yy, xx]

    y1, x1 = rot(pat[:, 0], pat[:, 1])
    y2, x2 = rot(pat[:, 2], pat[:, 3])
    desc = sample(y1, x1) < sample(y2, x2)
    return {
        "ys": ys.to(torch.int32), "xs": xs.to(torch.int32), "score": score,
        "fast_score": fast_sc, "valid": valid, "angle": angle,
        "desc": desc & valid[..., None],
    }
