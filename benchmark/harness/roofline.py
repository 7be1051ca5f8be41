"""Work and peaks for the roofline shares: a frozen copy of the quality
step's counts in ``rtvqa_tpu_torch/obs/roofline.py`` (``quality_roofline``
and what it calls), so that a change to the program cannot move the
yardstick.

The count is of the step's work at its shapes, whatever kernels implement
it: bytes are compulsory device-memory traffic (each input read once, each
output written once, each materialised intermediate written and read back
once); operations are the f32 and integer operations of the step (a K-tap
filter output is K multiplies and K-1 adds; VIF statistics are five moment
filters plus ~33 operations per pixel; ADM's per-subband-pixel work is 86).
Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W limit.
"""

from __future__ import annotations

#: HBM3 bandwidth, bytes/s.
HBM_BYTES_PER_S = 3.35e12
#: f32 outside the tensor cores (FMA counted as two), operations/s.
F32_OPS_PER_S = 67e12


def _taps_ops(k: int) -> int:
    return 2 * k - 1


def _vif_stats_ops(k: int) -> int:
    return 3 + 10 * _taps_ops(k) + 30


def _filter_dec_ops(k: int, h: int, w: int) -> int:
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    return 2 * _taps_ops(k) * (h2 * w + h2 * w2)


def _adm_scale_ops(h: int, w: int) -> int:
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    return 2 * 2 * _taps_ops(4) * h2 * w + (2 * 4 * _taps_ops(4) + 86) * h2 * w2


def _vif_scale_ops(scale: int, h: int, w: int) -> int:
    ops = _vif_stats_ops(2 ** (4 - scale) + 1) * h * w
    if scale < 3:
        ops += _filter_dec_ops(2 ** (3 - scale) + 1, h, w)
    return ops


def _quality_ops(h, w, hc, wc) -> int:
    per_luma = 13 + (2 * _taps_ops(5) + 3) + _vif_stats_ops(17)
    return per_luma * h * w + _filter_dec_ops(9, h, w) + 2 * 13 * hc * wc


def _vif_tail_ops(h1, w1) -> int:
    ops, h, w = 0, h1, w1
    for scale in (1, 2, 3):
        ops += _vif_scale_ops(scale, h, w)
        h, w = (h + 1) // 2, (w + 1) // 2
    return ops


def _adm_tail_ops(h1, w1) -> int:
    ops, h, w = 0, h1, w1
    for _ in range(3):
        ops += _adm_scale_ops(h, w)
        h, w = (h + 1) // 2, (w + 1) // 2
    return ops


def quality_roofline(h: int, w: int) -> dict:
    """Per-frame bytes and operations of the quality step at (h, w): the
    u8 YUV pair in, the f32 scale-1 VIF pair written and read back, the u8
    luma pair into ADM scale 0, its f32 approximation pair written and read
    back; PSNR/SSIM/motion/VIF 0, VIF 1-3, ADM 0, ADM 1-3."""
    hw = float(h * w)
    dec_pair = 2.0 * (hw / 4) * 4
    reads = 3.0 * hw + dec_pair + 2.0 * hw + dec_pair
    writes = 2.0 * dec_pair
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    ops = _quality_ops(h, w, h2, w2) + _vif_tail_ops(h2, w2) + _adm_scale_ops(h, w) + _adm_tail_ops(h2, w2)
    return {"bytes_per_frame": reads + writes, "ops_per_frame": float(ops)}


def bound_seconds(counts: dict) -> float:
    """The least time: the larger of bytes over the HBM rate and operations
    over the f32 rate."""
    return max(counts["bytes_per_frame"] / HBM_BYTES_PER_S, counts["ops_per_frame"] / F32_OPS_PER_S)
