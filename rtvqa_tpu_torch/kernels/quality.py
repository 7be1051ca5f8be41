"""The quality chunk's per-frame pass: the CUDA kernel ``csrc/quality.cu``
and its plain version.

Replaces ``rtvqa_tpu/kernels/quality_pallas.py::quality_fused_pallas``:
per frame, the plane SSEs, the x264 SSIM window sums of Y/U/V, the FILTER_5
blur of ref luma and its SAD against the previous frame's blur (frame 0
against ``prev_blur``), VIF scale 0, the scale-1 inputs (9-tap filter, even
rows and columns) of ref and dis, and the blurred last frame. On the card
one luma kernel computes all of the luma work from one staged tile per
frame (FMA taps; VIF moments of tiles with flat ref windows in the plain
version's order) and one more launch the chroma SSE/SSIM. The wrapper
takes the plain version only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from rtvqa_tpu_torch.kernels._build import check_launch, load_library, require_cuda
from rtvqa_tpu_torch.metrics.quality import plane_sse, ssim_window_sums
from rtvqa_tpu_torch.vmaf.filters import decimate2, filter1d_sep, gaussian_kernel
from rtvqa_tpu_torch.vmaf.motion import FILTER_5
from rtvqa_tpu_torch.vmaf.vif import _vif_scale_stats, scale_taps, vif_ratio

TAPS17 = scale_taps(0).astype(np.float32)
TAPS9 = gaussian_kernel(9, 9 / 5.0).astype(np.float32)
TAPS_BLUR = FILTER_5.astype(np.float32)
SUM_KEYS = ("sse_y", "sse_u", "sse_v", "ssim_y_sum", "ssim_u_sum", "ssim_v_sum", "sad_sum")


def quality_fused_plain(ry, ru, rv, dy, du, dv, prev_blur, egl=None) -> dict:
    """The plain PyTorch version. Luma (B, H, W), chroma (B, Hc, Wc) uint8,
    ``prev_blur`` (H, W) f32. Returns ``vif_scale0``, ``sse_y/u/v``,
    ``ssim_y/u/v_sum``, ``sad_sum`` (each (B,) f32), ``dec_ref``/``dec_dis``
    (B, ceil(H/2), ceil(W/2)) f32 and ``blur_carry`` (H, W) f32."""
    ryf, dyf = ry.float(), dy.float()
    blur = filter1d_sep(ryf, FILTER_5)
    prev = torch.cat([prev_blur.float()[None], blur[:-1]], dim=0)
    num, den = _vif_scale_stats(ryf, dyf, TAPS17, egl)
    return {
        "vif_scale0": vif_ratio(num, den),
        "sse_y": plane_sse(ry, dy),
        "sse_u": plane_sse(ru, du),
        "sse_v": plane_sse(rv, dv),
        "ssim_y_sum": ssim_window_sums(ry, dy).sum(dim=(-2, -1)),
        "ssim_u_sum": ssim_window_sums(ru, du).sum(dim=(-2, -1)),
        "ssim_v_sum": ssim_window_sums(rv, dv).sum(dim=(-2, -1)),
        "sad_sum": (blur - prev).abs().sum(dim=(-2, -1)),
        "dec_ref": decimate2(filter1d_sep(ryf, TAPS9)).contiguous(),
        "dec_dis": decimate2(filter1d_sep(dyf, TAPS9)).contiguous(),
        "blur_carry": blur[-1],
    }


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def quality_fused_cuda(ry, ru, rv, dy, du, dv, prev_blur, egl=None) -> dict:
    """The kernel; the same inputs and outputs as :func:`quality_fused_plain`.
    Needs H, W >= 9 (17-tap reflect borders)."""
    if ry.device.type == "cpu":
        return quality_fused_plain(ry, ru, rv, dy, du, dv, prev_blur, egl)
    for name, t in (("ry", ry), ("dy", dy), ("ru", ru), ("rv", rv), ("du", du), ("dv", dv)):
        require_cuda(name, t, torch.uint8, 3)
    require_cuda("prev_blur", prev_blur, torch.float32, 2)
    b, h, w = ry.shape
    hc, wc = ru.shape[-2:]
    if dy.shape != ry.shape or any(t.shape != ru.shape for t in (rv, du, dv)):
        raise ValueError(f"plane shapes differ: luma {tuple(ry.shape)}/{tuple(dy.shape)}, "
                         f"chroma {[tuple(t.shape) for t in (ru, rv, du, dv)]}")
    if tuple(prev_blur.shape) != (h, w) or ru.shape[0] != b:
        raise ValueError(f"prev_blur {tuple(prev_blur.shape)} / chroma batch do not fit luma {(b, h, w)}")
    if h < 9 or w < 9:
        raise ValueError(f"frames need H, W >= 9 for the 17-tap VIF window, got {h}x{w}")
    if len({t.device for t in (ry, ru, rv, dy, du, dv, prev_blur)}) != 1:
        raise ValueError("all planes must be on one device")
    dev = ry.device
    lib = load_library()
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    sums = torch.empty((b, 9), dtype=torch.float64, device=dev)
    dec_ref = torch.empty((b, h2, w2), dtype=torch.float32, device=dev)
    dec_dis = torch.empty_like(dec_ref)
    blur_carry = torch.empty((h, w), dtype=torch.float32, device=dev)
    scratch = torch.empty((max(lib.rtvqa_quality_scratch(b, h, w, hc, wc), 1),),
                          dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.rtvqa_quality_fused(
            ry.data_ptr(), ru.data_ptr(), rv.data_ptr(), dy.data_ptr(), du.data_ptr(),
            dv.data_ptr(), prev_blur.data_ptr(), b, h, w, hc, wc,
            _ptr(TAPS17), _ptr(TAPS9), _ptr(TAPS_BLUR),
            float(egl if egl is not None else 0.0), int(egl is not None),
            scratch.data_ptr(), sums.data_ptr(), dec_ref.data_ptr(), dec_dis.data_ptr(),
            blur_carry.data_ptr(), stream,
        )
    check_launch(lib, code, "quality_fused")
    quality_fused_cuda.launches += 1
    s = sums.float()
    out = {k: s[:, i] for i, k in enumerate(SUM_KEYS)}
    out["vif_scale0"] = vif_ratio(s[:, 7], s[:, 8])
    out.update(dec_ref=dec_ref, dec_dis=dec_dis, blur_carry=blur_carry)
    return out


quality_fused_cuda.launches = 0


def quality_luma_occupancy(device) -> dict:
    """The luma kernel's launch figures on a CUDA ``device``: blocks per SM
    (the occupancy API), registers per thread, dynamic shared bytes per
    block and local (spill) bytes per thread."""
    lib = load_library()
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        check_launch(lib, lib.rtvqa_quality_luma_occupancy(out), "quality_luma_occupancy")
    return dict(zip(("blocks_per_sm", "registers", "shared_bytes", "local_bytes"), out))
