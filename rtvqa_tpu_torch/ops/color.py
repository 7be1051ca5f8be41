"""Color-space conversion (counterpart of ``rtvqa_tpu/ops/color.py``).

BT.601 limited-range YUV420 -> full-range RGB planes, clipped to [0, 255],
and gray with the BT.601 luma weights — the same f32 constants and the same
expression order as the JAX ops. Chroma upsampling is the index map
``(r, c) -> (r // 2, c // 2)``, which also covers odd H and W.
"""

from __future__ import annotations

import numpy as np
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


def upsample_chroma(c: torch.Tensor) -> torch.Tensor:
    """(..., H/2, W/2) -> (..., H, W) by 2x2 nearest replication."""
    return c.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


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


def yuv420_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Planar YUV420 -> (..., H, W, 3) f32 RGB in [0, 255], the interleaved
    form of :func:`yuv420_to_rgb_planes` (small arrays; hot paths keep the
    planes)."""
    return torch.stack(yuv420_to_rgb_planes(y, u, v), dim=-1)


def yuv420_to_gray(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Planar YUV420 -> (..., H, W) f32 gray in [0, 255] (clip in RGB space,
    then the luma weights). The plain version of the ``gray`` CUDA kernel."""
    r, g, b = yuv420_to_rgb_planes(y, u, v)
    return r * GRAY_R + g * GRAY_G + b * GRAY_B


def rgb_to_yuv420_np(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(N, H, W, 3) uint8 full-range RGB -> planar BT.601 limited YUV420 on
    the host, with 2x2-average chroma (test-clip synthesis; even H and W)."""
    rgb = rgb.astype(np.float64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 16.0 + (65.481 * r + 128.553 * g + 24.966 * b) / 255.0
    u = 128.0 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255.0
    v = 128.0 + (112.0 * r - 93.786 * g - 18.214 * b) / 255.0
    n, h, w = y.shape
    u2 = u.reshape(n, h // 2, 2, w // 2, 2).mean(axis=(2, 4))
    v2 = v.reshape(n, h // 2, 2, w // 2, 2).mean(axis=(2, 4))

    def to_u8(x):
        return np.clip(np.rint(x), 0, 255).astype(np.uint8)

    return to_u8(y), to_u8(u2), to_u8(v2)


def yuv420_to_gray_np(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Float64 NumPy oracle for :func:`yuv420_to_gray` (and the ``gray``
    CUDA kernel): 2x2 nearest chroma, clip in RGB space, the luma weights."""
    yf = y.astype(np.float64) - 16.0
    uf = np.repeat(np.repeat(u.astype(np.float64), 2, -2), 2, -1) - 128.0
    vf = np.repeat(np.repeat(v.astype(np.float64), 2, -2), 2, -1) - 128.0
    uf = uf[..., : y.shape[-2], : y.shape[-1]]
    vf = vf[..., : y.shape[-2], : y.shape[-1]]
    r = np.clip(_Y_SCALE * yf + _V_R * vf, 0, 255)
    g = np.clip(_Y_SCALE * yf + _U_G * uf + _V_G * vf, 0, 255)
    b = np.clip(_Y_SCALE * yf + _U_B * uf, 0, 255)
    return GRAY_R * r + GRAY_G * g + GRAY_B * b
