"""Canny edge count (counterpart of ``rtvqa_tpu/ops/edges.py``).

1. 3x3 Sobel gradients with replicate border, L1 magnitude;
2. non-maximum suppression by the cv2 sector rule (tan 22.5 / tan 67.5,
   one strict and one non-strict neighbour test);
3. double threshold, then hysteresis as an iterated 8-connected dilation
   until nothing changes (the JAX ``while_loop`` becomes a Python loop on a
   ``changed`` flag, capped at H*W as there).

``sobel_edge_density`` is the cheap single-threshold count (L1 Sobel
magnitude above a threshold, no NMS or hysteresis).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_TG22 = 0.4142135623730951  # tan(22.5 deg)
_TG67 = 2.414213562373095   # tan(67.5 deg)


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Value of the neighbour at (+dy, +dx) with replicate border, same shape."""
    h, w = x.shape[-2], x.shape[-1]
    rows = (torch.arange(h, device=x.device) + dy).clamp(0, h - 1)
    cols = (torch.arange(w, device=x.device) + dx).clamp(0, w - 1)
    return x.index_select(-2, rows).index_select(-1, cols)


def sobel_gradients(gray: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """3x3 Sobel gx, gy over (..., H, W) with replicate border."""
    g = gray.float()
    tl, t, tr = _shift(g, -1, -1), _shift(g, -1, 0), _shift(g, -1, 1)
    l, r = _shift(g, 0, -1), _shift(g, 0, 1)
    bl, b, br = _shift(g, 1, -1), _shift(g, 1, 0), _shift(g, 1, 1)
    gx = (tr + 2.0 * r + br) - (tl + 2.0 * l + bl)
    gy = (bl + 2.0 * b + br) - (tl + 2.0 * t + tr)
    return gx, gy


def _dilate8(m: torch.Tensor) -> torch.Tensor:
    """8-connected binary dilation with a zero border (center included)."""
    h, w = m.shape[-2], m.shape[-1]
    f = m.reshape(-1, 1, h, w).to(torch.float32)
    return (F.max_pool2d(f, 3, stride=1, padding=1) > 0).reshape(m.shape)


def canny_edges(
    gray: torch.Tensor,
    low: float = 100.0,
    high: float = 200.0,
    max_hysteresis_iters: int | None = None,
) -> torch.Tensor:
    """Canny edge map over (..., H, W) -> bool (..., H, W)."""
    if max_hysteresis_iters is None:
        max_hysteresis_iters = gray.shape[-2] * gray.shape[-1]
    gx, gy = sobel_gradients(gray)
    mag = torch.abs(gx) + torch.abs(gy)

    ax, ay = torch.abs(gx), torch.abs(gy)
    horiz = ay <= _TG22 * ax
    vert = ay >= _TG67 * ax
    diag = ~(horiz | vert)
    same_sign = (gx * gy) >= 0

    def keep_along(dy: int, dx: int) -> torch.Tensor:
        return (mag > _shift(mag, dy, dx)) & (mag >= _shift(mag, -dy, -dx))

    keep = (
        (horiz & keep_along(0, 1))
        | (vert & keep_along(1, 0))
        | (diag & torch.where(same_sign, keep_along(1, 1), keep_along(1, -1)))
    )
    nms = torch.where(keep, mag, 0.0)
    strong = nms > high
    weak = nms > low

    cur = strong
    for _ in range(max_hysteresis_iters):
        nxt = cur | (weak & _dilate8(cur))
        if torch.equal(nxt, cur):
            break
        cur = nxt
    return cur


def canny_edge_count(gray: torch.Tensor, low: float = 100.0, high: float = 200.0) -> torch.Tensor:
    """Per-frame count of Canny edge pixels over (..., H, W), f32."""
    return torch.sum(canny_edges(gray, low, high), dim=(-2, -1)).float()


def sobel_edge_density(gray: torch.Tensor, threshold: float = 200.0) -> torch.Tensor:
    """Per-frame count of pixels whose L1 Sobel magnitude exceeds
    ``threshold`` over (..., H, W), f32."""
    gx, gy = sobel_gradients(gray)
    return torch.sum((torch.abs(gx) + torch.abs(gy)) > threshold, dim=(-2, -1)).float()
