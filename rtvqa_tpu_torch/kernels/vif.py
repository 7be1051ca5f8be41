"""VIF scales 1-3: the CUDA kernel ``csrc/vif.cu`` and its plain version.

Replaces ``rtvqa_tpu/kernels/vif_pallas.py::vif_tail_pallas``: from the
scale-1 inputs (``dec_ref``/``dec_dis``, the 9-tap filtered, 2x-decimated
luma pair of the quality pass), VIF statistics at 9 taps, then a 5-tap
filter and decimation, statistics at 5 taps, a 3-tap filter and
decimation, statistics at 3 taps. The wrapper takes the plain version only
for tensors on the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from rtvqa_tpu_torch.kernels._build import check_launch, load_library, require_cuda
from rtvqa_tpu_torch.vmaf.filters import decimate2, filter1d_sep
from rtvqa_tpu_torch.vmaf.vif import _vif_scale_stats, scale_taps, vif_ratio

TAPS = {scale: scale_taps(scale).astype(np.float32) for scale in (1, 2, 3)}


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
    vif_tail_cuda.launches += 1
    s = sums.float()
    return {f"vif_scale{k}": vif_ratio(s[:, 2 * k - 2], s[:, 2 * k - 1]) for k in (1, 2, 3)}


vif_tail_cuda.launches = 0
