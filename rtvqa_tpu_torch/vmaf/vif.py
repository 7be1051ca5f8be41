"""VIF (Visual Information Fidelity) at 4 scales, libvmaf float semantics
(counterpart of ``rtvqa_tpu/vmaf/vif.py``).

For scale k = 0..3 the window has N = 2^(4-k)+1 taps and sigma = N/5; for
k > 0 ref/dis are first blurred with that window and decimated by 2. Local
moments give the regression gain g = sigma12 / (sigma1^2 + eps) and the
visual noise sv^2 = sigma2^2 - g*sigma12, clamped in float_vif order, and

    vif_scale_k = sum(log2(1 + g^2 sigma1^2 / (sv^2 + 2)))
                / sum(log2(1 + sigma1^2 / 2)).

Borders are mirrored (``filters.filter1d_sep``). Every step runs in f32 in
the JAX ops' order. ``vif_features_np`` is the float64 NumPy oracle the
kernels and the plain version are held to.
"""

from __future__ import annotations

import numpy as np
import torch

from rtvqa_tpu_torch.vmaf.filters import decimate2, filter1d_sep, filter1d_sep_np, gaussian_kernel

_SIGMA_NSQ = 2.0
_EPS = 1e-10


def scale_taps(scale: int):
    """The Gaussian window of VIF scale ``scale`` (17, 9, 5, 3 taps)."""
    n = 2 ** (4 - scale) + 1
    return gaussian_kernel(n, n / 5.0)


def _vif_scale_stats(ref, dis, taps, enhn_gain_limit=None):
    """(num, den) sums over the trailing (H, W) axes at one scale."""
    mu1 = filter1d_sep(ref, taps)
    mu2 = filter1d_sep(dis, taps)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = filter1d_sep(ref * ref, taps) - mu1_sq
    sigma2_sq = filter1d_sep(dis * dis, taps) - mu2_sq
    sigma12 = filter1d_sep(ref * dis, taps) - mu1_mu2

    sigma1_sq = sigma1_sq.clamp_min(0.0)
    sigma2_sq = sigma2_sq.clamp_min(0.0)

    g = sigma12 / (sigma1_sq + _EPS)
    sv_sq = sigma2_sq - g * sigma12

    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    small1 = sigma1_sq < _EPS
    g = torch.where(small1, zero, g)
    sv_sq = torch.where(small1, sigma2_sq, sv_sq)
    sigma1_sq = torch.where(small1, zero, sigma1_sq)

    small2 = sigma2_sq < _EPS
    g = torch.where(small2, zero, g)
    sv_sq = torch.where(small2, zero, sv_sq)

    neg_g = g < 0
    sv_sq = torch.where(neg_g, sigma2_sq, sv_sq)
    g = torch.where(neg_g, zero, g)
    sv_sq = sv_sq.clamp_min(_EPS)

    if enhn_gain_limit is not None:
        # NEG mode (libvmaf vif_enhn_gain_limit), after the clamps.
        g = g.clamp_max(float(enhn_gain_limit))

    num = torch.log2(1.0 + g * g * sigma1_sq / (sv_sq + _SIGMA_NSQ))
    den = torch.log2(1.0 + sigma1_sq / _SIGMA_NSQ)
    return num.sum(dim=(-2, -1)), den.sum(dim=(-2, -1))


def vif_ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return num / den.clamp_min(_EPS)


def vif_features(ref_y: torch.Tensor, dis_y: torch.Tensor, enhn_gain_limit=None) -> dict:
    """Per-frame VIF at 4 scales over (..., H, W) luma in [0, 255]:
    ``{"vif_scale0": (...), ..., "vif_scale3": (...)}``. ``enhn_gain_limit``
    caps the regression gain (libvmaf NEG mode); None is classic VIF."""
    ref = ref_y.float()
    dis = dis_y.float()
    out = {}
    for scale in range(4):
        taps = scale_taps(scale)
        if scale > 0:
            ref = decimate2(filter1d_sep(ref, taps))
            dis = decimate2(filter1d_sep(dis, taps))
        num, den = _vif_scale_stats(ref, dis, taps, enhn_gain_limit)
        out[f"vif_scale{scale}"] = vif_ratio(num, den)
    return out


def vif_features_np(ref_y: np.ndarray, dis_y: np.ndarray) -> dict[str, float]:
    """Float64 NumPy oracle of :func:`vif_features` on one (H, W) luma
    pair, built on the dense band matrices of ``filter1d_sep_np`` (classic
    VIF, no gain limit)."""
    ref = ref_y.astype(np.float64)
    dis = dis_y.astype(np.float64)
    out = {}
    for scale in range(4):
        n = 2 ** (4 - scale) + 1
        taps = gaussian_kernel(n, n / 5.0)
        if scale > 0:
            ref = filter1d_sep_np(ref, taps)[::2, ::2]
            dis = filter1d_sep_np(dis, taps)[::2, ::2]
        mu1 = filter1d_sep_np(ref, taps)
        mu2 = filter1d_sep_np(dis, taps)
        s1 = np.maximum(filter1d_sep_np(ref * ref, taps) - mu1 * mu1, 0)
        s2 = np.maximum(filter1d_sep_np(dis * dis, taps) - mu2 * mu2, 0)
        s12 = filter1d_sep_np(ref * dis, taps) - mu1 * mu2
        g = s12 / (s1 + _EPS)
        sv = s2 - g * s12
        m1 = s1 < _EPS
        g[m1] = 0
        sv[m1] = s2[m1]
        s1 = s1.copy()
        s1[m1] = 0
        m2 = s2 < _EPS
        g[m2] = 0
        sv[m2] = 0
        mg = g < 0
        sv[mg] = s2[mg]
        g[mg] = 0
        sv = np.maximum(sv, _EPS)
        num = np.log2(1 + g * g * s1 / (sv + _SIGMA_NSQ)).sum()
        den = np.log2(1 + s1 / _SIGMA_NSQ).sum()
        out[f"vif_scale{scale}"] = float(num / max(den, _EPS))
    return out
