"""2D DCT ops (counterpart of ``rtvqa_tpu/ops/dct.py``).

Orthonormal DCT-II as ``D_h @ X @ D_w^T`` in f32. Two exact rewrites, as in
the JAX package: Parseval (``sum(dct(x)**2) == sum(x**2)``) for the spatial
energy, and linearity (``dct(a) - dct(b) == dct(a - b)``) for the temporal
difference. ``blockwise_dct8x8`` applies the 8-point basis to each 8x8
tile of a frame.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II basis, rows=frequencies (cv2.dct / scipy norm='ortho')."""
    k = np.arange(n)[:, None]
    m = np.arange(n)[None, :]
    d = np.cos(np.pi * (2 * m + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    d[0] *= np.sqrt(0.5)
    d = d.astype(np.float64)
    d.setflags(write=False)  # cached: callers must not mutate
    return d


def dct_table(n: int, device: torch.device) -> torch.Tensor:
    """The (n, n) basis as an f32 tensor on ``device``."""
    return torch.from_numpy(dct_matrix(n).astype(np.float32)).to(device)


def dct2(
    x: torch.Tensor, dh: torch.Tensor | None = None, dw: torch.Tensor | None = None
) -> torch.Tensor:
    """Orthonormal 2D DCT-II over the trailing two axes, f32. ``dh``/``dw``
    are the basis tables (built here when not given)."""
    h, w = x.shape[-2], x.shape[-1]
    x = x.float()
    dh = dct_table(h, x.device) if dh is None else dh
    dw = dct_table(w, x.device) if dw is None else dw
    return torch.matmul(torch.matmul(dh, x), dw.t())


def dct_energy(gray: torch.Tensor) -> torch.Tensor:
    """Per-frame ``sum(dct2(gray)**2)`` via Parseval: ``sum(gray**2)``."""
    g = gray.float()
    return torch.sum(g * g, dim=(-2, -1))


def temporal_dct_abs_diff(
    prev_gray: torch.Tensor,
    curr_gray: torch.Tensor,
    dh: torch.Tensor | None = None,
    dw: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-pair ``sum(|dct2(prev) - dct2(curr)|)`` via the DCT of the
    difference."""
    diff = prev_gray.float() - curr_gray.float()
    return torch.sum(torch.abs(dct2(diff, dh, dw)), dim=(-2, -1))


def blockwise_dct8x8(x: torch.Tensor) -> torch.Tensor:
    """8x8 blockwise orthonormal DCT-II: (..., H, W) -> (..., H/8, W/8, 8, 8)
    f32, as two (8, 8) f32 contractions per tile. H and W must be multiples
    of 8."""
    h, w = x.shape[-2], x.shape[-1]
    if h % 8 or w % 8:
        raise ValueError(f"blockwise DCT needs H and W multiples of 8, got {h}x{w}")
    lead = x.shape[:-2]
    tiles = x.float().reshape(*lead, h // 8, 8, w // 8, 8).transpose(-3, -2)
    d = dct_table(8, x.device)
    return torch.matmul(torch.matmul(d, tiles), d.t())
