"""Exponential smoothing and masked means (counterpart of
``rtvqa_tpu/ops/scan.py``).

pandas ``ewm(alpha, adjust=True).mean()`` is the ratio of two first-order
linear recurrences ``s_t = (1-a) * s_{t-1} + v_t``: the numerator over the
values, the denominator over ones. The JAX package runs them as an
associative scan; here they run as the same log-depth doubling scan over
pairs ``(A, b)`` (the affine map ``s -> A*s + b``): step k composes each
slot with the slot 2^k before it. No step divides by a power of the decay,
so nothing underflows where the closed form ``cumsum(x / d^t) * d^t``
would (0.2^t leaves f32 at t ~ 55).

``ewm_mean_masked`` smooths a padded series whose invalid slots are skipped
as if absent. A clip has at most a few hundred sampled frames, so its two
recurrences are written in closed form as one (N, N) weight matrix in
float64:

    num_t = sum_{i<=t, valid_i} (1-a)^(c_t - c_i) * x_i,   den_t likewise,

with ``c`` the running count of valid slots. Exponents are non-negative and
float64 holds ``0.2 ** 128 ~ 3e-90``. (On the doubling scan in float64 its
f32 results would move by one ULP on about half of all series.)
"""

from __future__ import annotations

import torch


def linear_recurrence(decay: torch.Tensor, values: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """``s_t = decay_t * s_{t-1} + values_t`` (s_{-1} = 0) along ``axis``."""
    a = torch.movedim(decay, axis, 0)
    b = torch.movedim(values, axis, 0)
    a, b = torch.broadcast_tensors(a, b)
    n = b.shape[0]
    step = 1
    while step < n:
        # Slots t >= step take (A_t, b_t) o (A_{t-step}, b_{t-step}).
        b = torch.cat([b[:step], a[step:] * b[:-step] + b[step:]])
        a = torch.cat([a[:step], a[step:] * a[:-step]])
        step *= 2
    return torch.movedim(b, 0, axis)


def ewm_mean(x: torch.Tensor, alpha: float, axis: int = 0) -> torch.Tensor:
    """pandas ``ewm(alpha=alpha, adjust=True).mean()`` along ``axis``, in
    ``x``'s float dtype (f32 for other dtypes)."""
    if x.dtype not in (torch.float32, torch.float64):
        x = x.float()
    decay = torch.full_like(x, 1.0 - alpha)
    num = linear_recurrence(decay, x, axis)
    den = linear_recurrence(decay, torch.ones_like(x), axis)
    return num / den


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
