"""Separable filtering primitives for the VMAF feature extractors (the
port's counterpart of ``rtvqa_tpu/vmaf/filters.py``).

Every VMAF feature is built on 1D correlations over the luma plane
(Gaussian windows for VIF, a 5-tap blur for motion, db2 wavelet taps for
ADM). A ``k``-tap filter pads ``k//2`` samples before and ``k-1-k//2`` after
(so the 4-tap db2 filter pads 2 before and 1 after) with numpy's border
modes: ``"reflect"`` mirrors without repeating the edge sample (scipy
'mirror', libvmaf's vif_filter1d), ``"edge"`` repeats it. The border is an
index gather built with ``np.pad`` on an index range, so it follows numpy's
semantics for any pad width. Taps are f32 and the sum runs tap by tap in
f32, in the JAX ops' order. The ``*_np`` functions are float64 oracles on
dense band matrices, independent of the gather.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def gaussian_kernel(n: int, sigma: float) -> np.ndarray:
    """Symmetric normalized Gaussian window of ``n`` taps (libvmaf VIF form)."""
    x = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float64)


@functools.lru_cache(maxsize=256)
def _border_index_np(n: int, before: int, after: int, mode: str) -> np.ndarray:
    pad_mode = {"reflect": "reflect", "edge": "edge"}[mode]
    return np.pad(np.arange(n), (before, after), mode=pad_mode)


def border_index(n: int, before: int, after: int, mode: str, device) -> torch.Tensor:
    """Source index of each sample of a length-``n`` axis padded by
    ``(before, after)`` in numpy's ``mode``."""
    return torch.from_numpy(_border_index_np(n, before, after, mode)).to(device)


def _conv_1d(x: torch.Tensor, taps, axis: int, mode: str) -> torch.Tensor:
    """1D correlation along axis -1 or -2 with border handling."""
    if axis not in (-1, -2):
        raise ValueError(f"axis must be -1 or -2, got {axis}")
    taps_a = np.asarray(taps, dtype=np.float32)
    k = len(taps_a)
    half = k // 2
    n = x.shape[axis]
    xp = x.float().index_select(x.dim() + axis, border_index(n, half, k - 1 - half, mode, x.device))
    acc = None
    for t in range(k):
        sl = xp.narrow(x.dim() + axis, t, n)
        term = float(taps_a[t]) * sl
        acc = term if acc is None else acc + term
    return acc


def filter1d_sep(x: torch.Tensor, taps, mode: str = "reflect") -> torch.Tensor:
    """Separable 2D filter over trailing (H, W) axes (rows then columns)."""
    return _conv_1d(_conv_1d(x, taps, -2, mode), taps, -1, mode)


def filter1d_sep_axis(x: torch.Tensor, taps, axis: int, mode: str = "reflect") -> torch.Tensor:
    """1D correlation along one of the trailing two axes."""
    return _conv_1d(x, taps, axis, mode)


def decimate2(x: torch.Tensor) -> torch.Tensor:
    """Keep the even rows and columns of the trailing (H, W) axes."""
    return x[..., ::2, ::2]


# --- NumPy oracles (an independent dense band-matrix construction) ---------


@functools.lru_cache(maxsize=256)
def _conv_matrix(length: int, taps: tuple, mode: str) -> np.ndarray:
    """(length, length) float64 matrix equal to 1D correlation with border
    handling. ``mode``: "reflect" mirrors without repeating the edge sample
    (scipy 'mirror' / libvmaf's vif_filter1d), "edge" repeats it."""
    taps_a = np.asarray(taps, dtype=np.float64)
    n = len(taps_a)
    half = n // 2
    m = np.zeros((length, length), dtype=np.float64)
    for i in range(length):
        for t in range(n):
            j = i + t - half
            if mode == "reflect":
                if j < 0:
                    j = -j
                elif j >= length:
                    j = 2 * length - 2 - j
                j = int(np.clip(j, 0, length - 1))
            elif mode == "edge":
                j = int(np.clip(j, 0, length - 1))
            else:
                raise ValueError(mode)
            m[i, j] += taps_a[t]
    return m


def filter1d_sep_np(x: np.ndarray, taps: np.ndarray, mode: str = "reflect") -> np.ndarray:
    """Float64 oracle of :func:`filter1d_sep`: rows then columns."""
    h, w = x.shape[-2], x.shape[-1]
    t = tuple(float(v) for v in np.asarray(taps, dtype=np.float64))
    mh = _conv_matrix(h, t, mode)
    mw = _conv_matrix(w, t, mode)
    y = np.einsum("oh,...hw->...ow", mh, x.astype(np.float64))
    return np.einsum("pw,...hw->...hp", mw, y)


def filter1d_sep_axis_np(x: np.ndarray, taps: np.ndarray, axis: int, mode: str = "reflect") -> np.ndarray:
    """Float64 oracle of :func:`filter1d_sep_axis` along axis -1 or -2."""
    if axis not in (-1, -2):
        raise ValueError(f"axis must be -1 or -2, got {axis}")
    length = x.shape[axis]
    t = tuple(float(v) for v in np.asarray(taps, dtype=np.float64))
    m = _conv_matrix(length, t, mode)
    eq = "oh,...hw->...ow" if axis == -2 else "pw,...hw->...hp"
    return np.einsum(eq, m, x.astype(np.float64))
