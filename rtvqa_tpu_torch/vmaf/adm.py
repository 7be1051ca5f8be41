"""ADM / DLM (Detail Loss Metric), the ``adm2`` VMAF feature (counterpart
of ``rtvqa_tpu/vmaf/adm.py``).

Per scale (4 db2 DWT levels; the approximation band feeds the next level):
decoupling of the distorted detail bands into restored and additive parts
(gain clip to [0, 1], the cos(1 deg) angle test), Watson CSF weighting, a
3x3 masking threshold from the CSF-weighted additive residual (center
weight 2, edge-padded, /30), and Minkowski L3 pooling over the center crop
with libvmaf's ``cbrt(area/32)`` offset per band; adm2 = sum(num) /
sum(den). Pooling is the literal libvmaf form ``sum(|o*f|^3)``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from rtvqa_tpu_torch.vmaf.filters import border_index, filter1d_sep_axis

# Daubechies-2 analysis filters (orthonormal).
DB2_LO = np.array(
    [0.482962913144690, 0.836516303737469, 0.224143868042013, -0.129409522550921]
)
DB2_HI = np.array(
    [-0.129409522550921, -0.224143868042013, 0.836516303737469, -0.482962913144690]
)

_COS_1DEG_SQ = math.cos(math.pi / 180.0) ** 2
_BORDER_FACTOR = 0.1
_WATSON = {"a": 0.495, "k": 0.466, "f0": 0.401, "g": (1.501, 1.0, 0.534)}
_NORM_VIEW_DIST = 3.0
_REF_DISPLAY_HEIGHT = 1080


@functools.lru_cache(maxsize=None)
def csf_rfactors(scale: int) -> tuple[float, float, float]:
    """(h, v, d) CSF weights 1/Q for a DWT level (0-based scale index)."""
    r = _NORM_VIEW_DIST * _REF_DISPLAY_HEIGHT * math.pi / 180.0

    def quant_step(theta: int) -> float:
        g = _WATSON["g"][theta]
        temp = math.log10((2.0 ** (scale + 1)) * _WATSON["f0"] * g / r)
        return 2.0 * _WATSON["a"] * (10.0 ** (_WATSON["k"] * temp * temp)) / g

    q_hv = quant_step(0)
    q_d = quant_step(1)
    return (1.0 / q_hv, 1.0 / q_hv, 1.0 / q_d)


def _dwt_1level(x: torch.Tensor):
    """One db2 DWT level over trailing (H, W): (a, h, v, d), each
    (..., ceil(H/2), ceil(W/2)). Mirrored borders, even-phase decimation."""
    lo_rows = filter1d_sep_axis(x, DB2_LO, axis=-2)[..., ::2, :]
    hi_rows = filter1d_sep_axis(x, DB2_HI, axis=-2)[..., ::2, :]

    def cols(y, taps):
        return filter1d_sep_axis(y, taps, axis=-1)[..., ::2]

    a = cols(lo_rows, DB2_LO)
    v = cols(hi_rows, DB2_LO)   # vertical detail: hi on rows, lo on cols
    h = cols(lo_rows, DB2_HI)   # horizontal detail: lo on rows, hi on cols
    d = cols(hi_rows, DB2_HI)
    return a, h, v, d


def _decouple(oh, ov, od, th, tv, td, enhn_gain_limit=None):
    """Restored (rh, rv, rd) and additive (th-rh, tv-rv, td-rd) bands."""
    eps = 1e-30
    ot_dp = oh * th + ov * tv
    o_mag_sq = oh * oh + ov * ov
    t_mag_sq = th * th + tv * tv
    angle_ok = (ot_dp >= 0.0) & (ot_dp * ot_dp >= _COS_1DEG_SQ * o_mag_sq * t_mag_sq)

    def restore(o, t):
        ratio = t / (o + torch.where(o >= 0, eps, -eps))
        rst = ratio.clamp(0.0, 1.0) * o
        if enhn_gain_limit is None:
            return torch.where(angle_ok, t, rst)
        # NEG mode (libvmaf adm_enhn_gain_limit): the gain is capped even
        # where the angle test passes.
        k_neg = ratio.clamp(0.0, float(enhn_gain_limit))
        return torch.where(angle_ok, k_neg * o, rst)

    rh, rv, rd = restore(oh, th), restore(ov, tv), restore(od, td)
    return (rh, rv, rd), (th - rh, tv - rv, td - rd)


def _mask_threshold(ah, av, ad):
    """3x3 spread of the summed |additive| across bands (center weight 2),
    edge-padded."""
    x = ah.abs() + av.abs() + ad.abs()
    h, w = x.shape[-2], x.shape[-1]
    p = x.index_select(-2, border_index(h, 1, 1, "edge", x.device))
    p = p.index_select(-1, border_index(w, 1, 1, "edge", x.device))
    acc = 2.0 * x
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            acc = acc + p[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
    return acc / 30.0


def _center_crop_slices(h: int, w: int):
    top = max(int(h * _BORDER_FACTOR) - 1, 1)
    left = max(int(w * _BORDER_FACTOR) - 1, 1)
    return slice(top, h - top), slice(left, w - left)


def crop_offset(h: int, w: int) -> float:
    """libvmaf's per-band ``cbrt(area/32)`` pooling offset for an (h, w)
    subband grid."""
    ys, xs = _center_crop_slices(h, w)
    area = (ys.stop - ys.start) * (xs.stop - xs.start)
    return (area / 32.0) ** (1.0 / 3.0)


def adm_band_cubes(o, t, scale: int, enhn_gain_limit=None):
    """One DWT level + decoupling + CSF + masking: the six center-crop L3
    sums (num_h, den_h, num_v, den_v, num_d, den_d), each (...,) before the
    cube root, and the next level's inputs (a_ref, a_dis)."""
    o, oh, ov, od = _dwt_1level(o)
    t, th, tv, td = _dwt_1level(t)
    (rh, rv, rd), (ah, av, ad) = _decouple(oh, ov, od, th, tv, td, enhn_gain_limit)
    fh, fv, fd = csf_rfactors(scale)
    thr = _mask_threshold(ah * fh, av * fv, ad * fd)
    ys, xs = _center_crop_slices(oh.shape[-2], oh.shape[-1])
    sums = []
    for rst, orig, f in ((rh, oh, fh), (rv, ov, fv), (rd, od, fd)):
        masked = ((rst * f).abs() - thr).clamp_min(0.0)
        sums.append((masked[..., ys, xs] ** 3).sum(dim=(-2, -1)))
        sums.append(((orig[..., ys, xs] * f).abs() ** 3).sum(dim=(-2, -1)))
    return tuple(sums), o, t


def pool_scale(sums, offset: float):
    """(num, den) summed over k scales from their L3 sums, laid out
    (..., 6k) as (num_h, den_h, num_v, den_v, num_d, den_d) per scale, and
    the sum of the k scales' :func:`crop_offset`: cube roots after the
    sums, plus the three per-band offsets of each scale."""
    roots = sums ** (1.0 / 3.0)
    return roots[..., 0::2].sum(dim=-1) + 3.0 * offset, roots[..., 1::2].sum(dim=-1) + 3.0 * offset


def adm_one_scale(o, t, scale: int, enhn_gain_limit=None):
    """One scale: (a_ref, a_dis, num, den), offsets included."""
    sums, a_o, a_t = adm_band_cubes(o, t, scale, enhn_gain_limit)
    num, den = pool_scale(torch.stack(sums, dim=-1), crop_offset(a_o.shape[-2], a_o.shape[-1]))
    return a_o, a_t, num, den


def adm_finalize(num_total, den_total, luma_shape) -> torch.Tensor:
    """adm2 from the summed per-scale contributions (degenerate-clip rule)."""
    h0, w0 = luma_shape[-2], luma_shape[-1]
    numden_limit = 1e-2 * (h0 * w0) / (1920.0 * 1080.0)
    return torch.where(
        den_total < numden_limit,
        torch.ones_like(num_total),
        num_total / den_total.clamp_min(1e-30),
    )


def adm_features(ref_y: torch.Tensor, dis_y: torch.Tensor, enhn_gain_limit=None) -> dict:
    """Per-frame adm2 over (..., H, W) luma: ``{"adm2": (...)}``.
    ``enhn_gain_limit`` caps the decoupling gain (libvmaf NEG mode)."""
    o = ref_y.float()
    t = dis_y.float()
    num_total = den_total = 0.0
    for scale in range(4):
        o, t, num, den = adm_one_scale(o, t, scale, enhn_gain_limit)
        num_total = num_total + num
        den_total = den_total + den
    return {"adm2": adm_finalize(num_total, den_total, ref_y.shape)}
