"""VIF kernels of ``csrc/vif.cu`` and their plain versions.

* ``vif_tail_cuda`` replaces ``rtvqa_tpu/kernels/vif_pallas.py::
  vif_tail_pallas``: from the scale-1 inputs (``dec_ref``/``dec_dis``, the
  9-tap filtered, 2x-decimated luma pair of the quality pass), VIF
  statistics at 9 taps, then a 5-tap filter and decimation, statistics at 5
  taps, a 3-tap filter and decimation, statistics at 3 taps.
* ``vif_scale_cuda`` replaces ``vif_pallas.py::vif_scale_pallas``: VIF at
  one scale and the next scale's filtered, 2x-decimated pair;
  ``vif_features_cuda`` chains it over scales 0-3, as
  ``vif_features_pallas`` does for frames wider than 3840.

The wrappers take the plain versions only for tensors on the CPU; for CUDA
tensors they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from rtvqa_tpu_torch.kernels._build import check_launch, load_library, require_cuda
from rtvqa_tpu_torch.vmaf.filters import decimate2, filter1d_sep
from rtvqa_tpu_torch.vmaf.vif import _vif_scale_stats, scale_taps, vif_ratio

TAPS = {scale: scale_taps(scale).astype(np.float32) for scale in range(4)}


def vif_tail_plain(dec_ref, dec_dis, egl=None) -> dict:
    """``{"vif_scale1": (B,), "vif_scale2": ..., "vif_scale3": ...}`` from the
    (B, H1, W1) f32 scale-1 pair."""
    ref, dis = dec_ref.float(), dec_dis.float()
    out = {}
    for scale in (1, 2, 3):
        taps = TAPS[scale]
        if scale > 1:
            ref = decimate2(filter1d_sep(ref, taps))
            dis = decimate2(filter1d_sep(dis, taps))
        out[f"vif_scale{scale}"] = vif_ratio(*_vif_scale_stats(ref, dis, taps, egl))
    return out


def vif_tail_cuda(dec_ref, dec_dis, egl=None) -> dict:
    """The kernel; the same inputs and outputs as :func:`vif_tail_plain`.
    Needs H1, W1 >= 5 (9-tap reflect borders)."""
    if dec_ref.device.type == "cpu":
        return vif_tail_plain(dec_ref, dec_dis, egl)
    require_cuda("dec_ref", dec_ref, torch.float32, 3)
    require_cuda("dec_dis", dec_dis, torch.float32, 3)
    if dec_ref.shape != dec_dis.shape or dec_ref.device != dec_dis.device:
        raise ValueError(f"dec_ref/dec_dis must match: {tuple(dec_ref.shape)} vs {tuple(dec_dis.shape)}")
    b, h1, w1 = dec_ref.shape
    if h1 < 5 or w1 < 5:
        raise ValueError(f"scale-1 frames need H, W >= 5 for the 9-tap window, got {h1}x{w1}")
    s = _tail_sums(dec_ref, dec_dis, egl).float()
    vif_tail_cuda.launches += 1
    return {f"vif_scale{k}": vif_ratio(s[:, 2 * k - 2], s[:, 2 * k - 1]) for k in (1, 2, 3)}


def _tail_sums(dec_ref, dec_dis, egl):
    """One ``rtvqa_vif_tail`` call on checked CUDA inputs: the (B, 6) f64
    sums [num1, den1, num2, den2, num3, den3]."""
    b, h1, w1 = dec_ref.shape
    dev = dec_ref.device
    lib = load_library()
    img = torch.empty((max(lib.rtvqa_vif_tail_scratch_floats(b, h1, w1), 1),),
                      dtype=torch.float32, device=dev)
    part = torch.empty((max(lib.rtvqa_vif_tail_scratch_doubles(b, h1, w1), 1),),
                       dtype=torch.float64, device=dev)
    sums = torch.empty((b, 6), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.rtvqa_vif_tail(
            dec_ref.data_ptr(), dec_dis.data_ptr(), b, h1, w1,
            TAPS[1].ctypes.data, TAPS[2].ctypes.data, TAPS[3].ctypes.data,
            float(egl if egl is not None else 0.0), int(egl is not None),
            img.data_ptr(), part.data_ptr(), sums.data_ptr(), stream,
        )
    check_launch(lib, code, "vif_tail")
    return sums


vif_tail_cuda.launches = 0


def vif_scale_plain(ref, dis, scale: int, egl=None):
    """(vif (B,), dec_ref, dec_dis) at ``scale`` (0-3) of a (B, H, W) u8 or
    f32 pair: the ratio of the scale's summed num/den, and the pair filtered
    with the next scale's window, even rows and columns kept
    ((B, ceil(H/2), ceil(W/2)) f32); ``None, None`` at scale 3."""
    r, d = ref.float(), dis.float()
    vif = vif_ratio(*_vif_scale_stats(r, d, TAPS[scale], egl))
    if scale == 3:
        return vif, None, None
    taps = TAPS[scale + 1]
    return (vif, decimate2(filter1d_sep(r, taps)).contiguous(),
            decimate2(filter1d_sep(d, taps)).contiguous())


def vif_scale_cuda(ref, dis, scale: int, egl=None):
    """The kernel; the same inputs and outputs as :func:`vif_scale_plain`.
    Needs H, W >= 2^(3-scale)+1 (one reflection of the window)."""
    if ref.device.type == "cpu":
        return vif_scale_plain(ref, dis, scale, egl)
    require_cuda("ref", ref, (torch.uint8, torch.float32), 3)
    require_cuda("dis", dis, (torch.uint8, torch.float32), 3)
    if ref.shape != dis.shape or ref.dtype != dis.dtype or ref.device != dis.device:
        raise ValueError(f"ref/dis must match: {tuple(ref.shape)} {ref.dtype} vs "
                         f"{tuple(dis.shape)} {dis.dtype}")
    if scale not in TAPS:
        raise ValueError(f"scale must be 0-3, got {scale}")
    b, h, w = ref.shape
    need = 2 ** (3 - scale) + 1
    if h < need or w < need:
        raise ValueError(f"VIF scale {scale} needs H, W >= {need}, got {h}x{w}")
    dev = ref.device
    lib = load_library()
    part = torch.empty((max(lib.rtvqa_vif_scale_scratch(b, h, w), 1),), dtype=torch.float64, device=dev)
    sums = torch.empty((b, 2), dtype=torch.float64, device=dev)
    dec_ref = dec_dis = None  # scale 3 has no next scale
    if scale < 3:
        dec_ref = torch.empty((b, (h + 1) // 2, (w + 1) // 2), dtype=torch.float32, device=dev)
        dec_dis = torch.empty_like(dec_ref)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.rtvqa_vif_scale(
            ref.data_ptr(), dis.data_ptr(), int(ref.dtype == torch.uint8), b, h, w, scale,
            TAPS[scale].ctypes.data, TAPS[scale + 1].ctypes.data if scale < 3 else None,
            float(egl if egl is not None else 0.0), int(egl is not None),
            part.data_ptr(), sums.data_ptr(),
            *(None if t is None else t.data_ptr() for t in (dec_ref, dec_dis)), stream,
        )
    check_launch(lib, code, f"vif_scale (scale {scale})")
    vif_scale_cuda.launches += 1
    vif_scale_cuda.launches_by_scale[f"scale{scale}"] += 1
    s = sums.float()
    return vif_ratio(s[:, 0], s[:, 1]), dec_ref, dec_dis


vif_scale_cuda.launches = 0
vif_scale_cuda.launches_by_scale = {f"scale{k}": 0 for k in TAPS}  # the same launches, by scale


def vif_scale_occupancy(device, dtype: torch.dtype, scale: int) -> dict:
    """Kernel 4's launch figures at ``scale`` for ``dtype`` (u8 or f32)
    input on ``device``: blocks per SM (the occupancy API), registers per
    thread, dynamic shared bytes per block, local (spill) bytes per thread."""
    lib = load_library()
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        check_launch(lib, lib.rtvqa_vif_scale_occupancy(int(dtype == torch.uint8), scale, out),
                     "vif_scale_occupancy")
    return dict(zip(("blocks_per_sm", "registers", "shared_bytes", "local_bytes"), out))


def _vif_features(scale_fn, ref_y, dis_y, egl) -> dict:
    out = {}
    ref, dis = ref_y, dis_y
    for scale in range(4):
        out[f"vif_scale{scale}"], ref, dis = scale_fn(ref, dis, scale, egl)
    return out


def vif_features_plain(ref_y, dis_y, egl=None) -> dict:
    """``{"vif_scale0": (B,), ..., "vif_scale3": (B,)}``: four chained
    :func:`vif_scale_plain` calls on a (B, H, W) luma pair."""
    return _vif_features(vif_scale_plain, ref_y, dis_y, egl)


def vif_features_cuda(ref_y, dis_y, egl=None) -> dict:
    """Four chained :func:`vif_scale_cuda` calls (counterpart of
    ``vif_features_pallas``); the same output as :func:`vif_features_plain`."""
    return _vif_features(vif_scale_cuda, ref_y, dis_y, egl)
