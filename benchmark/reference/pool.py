"""Plain reference of what a clip's per-frame series pool into: the
pooled PSNR (of the mean frame MSE), SSIM (mean of the frames' "All"), VMAF
(the mean of the per-frame prediction on adm2, motion2 and VIF 0-3), and
the eight smoothed scene-complexity metrics (pandas ``ewm(adjust=True)``
means over the accumulator's slots, framerate variation from the sampled
timestamps).

The VMAF prediction is the port's builtin linear fallback model, its
numbers copied here (six features, motion2 scaled by 1/20, weights 0.45,
-0.02, 0.10, 0.12, 0.15, 0.22, the bias that gives 100 for perfect
features, the score clipped to [0, 100]). Everything runs on the host in
``dtype``: float64 for the reference, bfloat16 for the control.
"""

from __future__ import annotations

import numpy as np
import torch

COMPLEXITY_KEYS = ("motion", "dct", "histogram", "edge", "orb", "color", "temporal_dct", "framerate")
VMAF_FEATURES = ("adm2", "motion2", "vif_scale0", "vif_scale1", "vif_scale2", "vif_scale3")
VMAF_WEIGHTS = (0.45, -0.02, 0.10, 0.12, 0.15, 0.22)
VMAF_SLOPES = (1.0, 1.0 / 20.0, 1.0, 1.0, 1.0, 1.0)


def _t(x, dtype) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float64)).to(dtype)


def motion2(sad: torch.Tensor) -> torch.Tensor:
    """min(sad[t], sad[t+1]); the last frame keeps its own; frame 0 is 0."""
    m = torch.minimum(sad, torch.cat([sad[1:], sad.new_full((1,), float("inf"))]))
    m[0] = 0.0
    return m


def vmaf_per_frame(feats: dict, dtype=torch.float64) -> torch.Tensor:
    x = torch.stack([feats[k] for k in VMAF_FEATURES], dim=-1)
    w = _t(VMAF_WEIGHTS, dtype)
    bias = 1.0 - (VMAF_WEIGHTS[0] + sum(VMAF_WEIGHTS[2:]))
    y = (x * _t(VMAF_SLOPES, dtype)) @ w + bias
    return (y / 0.01).clamp(0.0, 100.0)


def pool_quality(series: dict, dtype=torch.float64) -> dict:
    """Pooled psnr, ssim and vmaf of one clip's series (keys of
    ``quality.KEYS``, each (n,))."""
    mse = _t(series["mse_avg"], dtype).mean()
    psnr = float("inf") if mse <= 0 else float(10.0 * torch.log10(255.0 * 255.0 / mse))
    feats = {k: _t(series[k], dtype) for k in VMAF_FEATURES if k != "motion2"}
    feats["motion2"] = motion2(_t(series["motion_sad"], dtype))
    return {
        "psnr": psnr,
        "ssim": float(_t(series["ssim_all"], dtype).mean()),
        "vmaf": float(vmaf_per_frame(feats, dtype).mean()),
    }


def ewm_mean(x, alpha: float, dtype=torch.float64) -> float:
    """pandas ``ewm(alpha, adjust=True).mean()`` of a series, then its
    mean: at t, sum_i (1-a)^(t-i) x_i over sum_i (1-a)^(t-i), i <= t."""
    x = _t(x, dtype)
    n = x.shape[0]
    if n == 0:
        return 0.0
    t = torch.arange(n, dtype=torch.float64)
    lag = t[:, None] - t[None, :]
    w = torch.where(lag >= 0, (1.0 - alpha) ** lag.clamp_min(0), 0.0).to(dtype)
    return float(((w @ x) / w.sum(dim=1)).mean())


def pool_complexity(values: dict, timestamps_ms, alpha: float, dtype=torch.float64) -> dict:
    """The eight metrics of one clip from its accumulator slots (slot g:
    sampled frame g against g-1, slot 0 against nothing): the spatial and
    motion series over slots 1.., temporal DCT over slots 2.., framerate
    variation over the sampled timestamps' 1/dt. Fewer than two slots give
    zeros."""
    ts = np.asarray(timestamps_ms, np.float64)
    if ts.size < 2:
        return {k: 0.0 for k in COMPLEXITY_KEYS}
    out = {k: ewm_mean(np.asarray(values[k])[1:], alpha, dtype)
           for k in ("motion", "dct", "histogram", "edge", "orb", "color")}
    out["temporal_dct"] = ewm_mean(np.asarray(values["temporal_dct"])[2:], alpha, dtype)
    dt = np.diff(ts) / 1000.0
    out["framerate"] = ewm_mean(np.where(dt > 0, 1.0 / np.maximum(dt, 1e-9), 0.0), alpha, dtype)
    return out
