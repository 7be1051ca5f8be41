"""Bilinear resize as two f32 matrix products (counterpart of
``rtvqa_tpu/ops/resize.py``).

cv2 ``INTER_LINEAR`` geometry: half-pixel centers, ``src = (dst + 0.5) *
scale - 0.5``, clamped, no antialiasing. The weight tables are built in
numpy with the same formula as the JAX package, so they are bitwise equal.

``resize_bilinear_sampled`` gathers the <= 2*out_h source rows that carry
weight before the row product, for callers whose upstream work shrinks
with the rows read; its result is bit for bit ``resize_bilinear``'s.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _bilinear_matrix(dst: int, src: int) -> np.ndarray:
    """(dst, src) row-stochastic bilinear interpolation matrix, cv2 geometry."""
    m = np.zeros((dst, src), dtype=np.float32)
    scale = src / dst
    for i in range(dst):
        x = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        frac = x - x0
        lo = min(max(x0, 0), src - 1)
        hi = min(max(x0 + 1, 0), src - 1)
        m[i, lo] += 1.0 - frac
        m[i, hi] += frac
    m.setflags(write=False)  # cached: callers must not mutate
    return m


@functools.lru_cache(maxsize=64)
def bilinear_sample_plan(dst: int, src: int) -> tuple[np.ndarray, np.ndarray]:
    """(distinct source rows used, compact (dst, k) weights) with
    ``mat @ x[idx] == _bilinear_matrix(dst, src) @ x`` bitwise (the dropped
    terms are exact zeros)."""
    m = _bilinear_matrix(dst, src)
    idx = np.unique(np.nonzero(m)[1]).astype(np.int64)
    mat = np.ascontiguousarray(m[:, idx])
    idx.setflags(write=False)
    mat.setflags(write=False)
    return idx, mat


def bilinear_table(dst: int, src: int, device: torch.device) -> torch.Tensor:
    """The (dst, src) f32 weight table as a tensor on ``device``."""
    return torch.from_numpy(_bilinear_matrix(dst, src).copy()).to(device)


def resize_rows(x: torch.Tensor, rh: torch.Tensor) -> torch.Tensor:
    """``rh @ x`` over the row axis: (..., H, W) -> (..., out_h, W)."""
    return torch.matmul(rh, x)


def resize_cols(x: torch.Tensor, rw: torch.Tensor) -> torch.Tensor:
    """``x @ rw^T`` over the column axis: (..., H, W) -> (..., H, out_w)."""
    return torch.matmul(x, rw.t())


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize (..., H, W) to (..., out_h, out_w) in f32, cv2 geometry."""
    h, w = x.shape[-2], x.shape[-1]
    x = x if x.is_floating_point() else x.float()
    if h != out_h:
        x = resize_rows(x, bilinear_table(out_h, h, x.device))
    if w != out_w:
        x = resize_cols(x, bilinear_table(out_w, w, x.device))
    return x


def resize_bilinear_sampled(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """:func:`resize_bilinear`, bit for bit, with the row product taken over
    the gathered rows of ``bilinear_sample_plan`` only (the dropped terms
    are exact zeros)."""
    h = x.shape[-2]
    x = x if x.is_floating_point() else x.float()
    if h != out_h:
        idx, mat = bilinear_sample_plan(out_h, h)
        rows = x.index_select(-2, torch.from_numpy(idx.copy()).to(x.device))
        x = resize_rows(rows, torch.from_numpy(mat.copy()).to(device=x.device, dtype=x.dtype))
    return resize_bilinear(x, out_h, out_w)
