"""Color-space conversion (counterpart of ``rtvqa_tpu/ops/color.py``).

BT.601 limited-range YUV420 -> full-range RGB planes, clipped to [0, 255],
and gray with the BT.601 luma weights — the same f32 constants and the same
expression order as the JAX ops. Chroma upsampling is the index map
``(r, c) -> (r // 2, c // 2)``, which also covers odd H and W.
"""

from __future__ import annotations

import torch

# BT.601 limited-range YUV -> full-range RGB (same doubles as the JAX ops;
# rounded to f32 where they meet an f32 tensor).
_Y_SCALE = 255.0 / 219.0            # 1.1643835
_V_R = 255.0 / 224.0 * 1.402        # 1.5960267
_U_G = -255.0 / 224.0 * 0.344136    # -0.3917623
_V_G = -255.0 / 224.0 * 0.714136    # -0.8129676
_U_B = 255.0 / 224.0 * 1.772        # 2.0172321

GRAY_R, GRAY_G, GRAY_B = 0.299, 0.587, 0.114


def _half_index(n: int, device: torch.device) -> torch.Tensor:
    return torch.arange(n, device=device) // 2


def yuv_rows_to_rgb_planes(
    y_rows: torch.Tensor, u_rows: torch.Tensor, v_rows: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row-aligned YUV -> (r, g, b) f32 planes in [0, 255].

    ``y_rows`` (..., K, W); ``u_rows``/``v_rows`` (..., K, ceil(W/2)) already
    sampled at the matching chroma rows. Only the 2x lane replication
    happens here."""
    w = y_rows.shape[-1]
    cols = _half_index(w, y_rows.device)
    yf = y_rows.float() - 16.0
    uf = u_rows.float().index_select(-1, cols) - 128.0
    vf = v_rows.float().index_select(-1, cols) - 128.0
    r = _Y_SCALE * yf + _V_R * vf
    g = _Y_SCALE * yf + _U_G * uf + _V_G * vf
    b = _Y_SCALE * yf + _U_B * uf
    return r.clamp(0.0, 255.0), g.clamp(0.0, 255.0), b.clamp(0.0, 255.0)


def yuv420_to_rgb_planes(
    y: torch.Tensor, u: torch.Tensor, v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Planar YUV420 (..., H, W) + 2x (..., ceil(H/2), ceil(W/2)) uint8 ->
    three (..., H, W) f32 planes (r, g, b) in [0, 255]."""
    rows = _half_index(y.shape[-2], y.device)
    return yuv_rows_to_rgb_planes(y, u.index_select(-2, rows), v.index_select(-2, rows))


def yuv420_to_gray(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Planar YUV420 -> (..., H, W) f32 gray in [0, 255] (clip in RGB space,
    then the luma weights). The plain version of the ``gray`` CUDA kernel."""
    r, g, b = yuv420_to_rgb_planes(y, u, v)
    return r * GRAY_R + g * GRAY_G + b * GRAY_B
