"""Masked exponential smoothing and masked means (counterpart of
``rtvqa_tpu/ops/scan.py``).

pandas ``ewm(alpha, adjust=True).mean()`` over a padded series where invalid
slots are skipped as if absent. The JAX package runs the two linear
recurrences as an associative scan; a clip has at most a few hundred sampled
frames, so here the recurrences are written in closed form as one (N, N)
weight matrix in float64:

    num_t = sum_{i<=t, valid_i} (1-a)^(c_t - c_i) * x_i,   den_t likewise,

with ``c`` the running count of valid slots. Exponents are non-negative and
float64 holds ``0.2 ** 128 ~ 3e-90`` exactly enough, where an f32
cumulative-product form would underflow.
"""

from __future__ import annotations

import torch


def ewm_mean_masked(
    x: torch.Tensor, alpha: float, valid: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """EWM over a padded 1-D series; returns ``(smoothed, valid)`` with zeros
    at invalid slots. Computed in float64, returned in ``x``'s float dtype."""
    out_dtype = x.dtype if x.is_floating_point() else torch.float32
    validd = valid.to(torch.float64)
    count = torch.cumsum(valid.to(torch.int64), dim=0)
    expo = (count[:, None] - count[None, :]).to(torch.float64)
    causal = torch.ones(expo.shape, dtype=torch.bool, device=x.device).tril()
    weights = torch.where(causal, torch.pow(1.0 - alpha, expo), 0.0)
    num = weights @ (x.to(torch.float64) * validd)
    den = weights @ validd
    smoothed = torch.where(den > 0, num / den.clamp_min(1e-30), 0.0)
    return (smoothed * validd).to(out_dtype), valid


def masked_mean(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean over valid slots; 0.0 when no slot is valid."""
    validf = valid.to(x.dtype)
    total = torch.sum(x * validf)
    count = torch.sum(validf)
    return torch.where(count > 0, total / count.clamp_min(1.0), 0.0)
