"""ADM per scale: the CUDA kernel ``csrc/adm.cu`` and its plain versions.

``adm_scale_cuda`` replaces ``rtvqa_tpu/kernels/adm_pallas.py::
adm_scale_pallas`` (scale 0 on the uint8 luma pair); ``adm_tail_cuda``
replaces ``adm_pallas.py::adm_tail_pallas`` by launching the same per-scale
kernel for scales 1-3 on the f32 approximation bands. The kernel returns
the six center-crop L3 sums per frame; the cube roots and the per-band
``cbrt(area/32)`` offsets are taken here, after the sums, by the same
``vmaf.adm.pool_scale`` as the plain versions. The wrappers take the plain
versions only for tensors on the CPU; for CUDA tensors they launch the
kernel or raise.
"""

from __future__ import annotations

import numpy as np
import torch

from rtvqa_tpu_torch.kernels._build import check_launch, load_library, require_cuda
from rtvqa_tpu_torch.vmaf.adm import (
    _COS_1DEG_SQ,
    DB2_HI,
    DB2_LO,
    _center_crop_slices,
    adm_band_cubes,
    csf_rfactors,
    pool_scale,
)

DB2 = np.concatenate([DB2_LO, DB2_HI]).astype(np.float32)


def adm_scale_plain(ref, dis, scale: int = 0, egl=None):
    """(num (B,), den (B,), a_ref, a_dis) of one scale, offsets included;
    a_* are the (B, ceil(H/2), ceil(W/2)) f32 next-scale inputs."""
    sums, a_o, a_t = adm_band_cubes(ref.float(), dis.float(), scale, egl)
    num, den = pool_scale(sums, a_o.shape[-2], a_o.shape[-1])
    return num, den, a_o, a_t


def adm_tail_plain(a_ref, a_dis, egl=None) -> dict:
    """``{"num": (B,), "den": (B,)}``: scales 1-3 summed, offsets included."""
    num = den = 0.0
    o, t = a_ref, a_dis
    for scale in (1, 2, 3):
        n_s, d_s, o, t = adm_scale_plain(o, t, scale, egl)
        num, den = num + n_s, den + d_s
    return {"num": num, "den": den}


def _launch(ref, dis, scale: int, egl):
    """One per-scale launch: (six (B,) f32 sums, a_ref, a_dis)."""
    require_cuda("ref", ref, (torch.uint8, torch.float32), 3)
    require_cuda("dis", dis, (torch.uint8, torch.float32), 3)
    if ref.shape != dis.shape or ref.dtype != dis.dtype or ref.device != dis.device:
        raise ValueError(f"ref/dis must match: {tuple(ref.shape)} {ref.dtype} vs "
                         f"{tuple(dis.shape)} {dis.dtype}")
    b, h, w = ref.shape
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    ys, xs = _center_crop_slices(h2, w2)
    fh, fv, fd = csf_rfactors(scale)
    dev = ref.device
    lib = load_library()
    part = torch.empty((max(lib.rtvqa_adm_scratch(b, h, w), 1),), dtype=torch.float64, device=dev)
    sums = torch.empty((b, 6), dtype=torch.float64, device=dev)
    a_ref = torch.empty((b, h2, w2), dtype=torch.float32, device=dev)
    a_dis = torch.empty_like(a_ref)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.rtvqa_adm_scale(
            ref.data_ptr(), dis.data_ptr(), int(ref.dtype == torch.uint8), b, h, w,
            DB2.ctypes.data, fh, fv, fd, float(np.float32(_COS_1DEG_SQ)), ys.start, xs.start,
            float(egl if egl is not None else 0.0), int(egl is not None),
            part.data_ptr(), sums.data_ptr(), a_ref.data_ptr(), a_dis.data_ptr(), stream,
        )
    check_launch(lib, code, f"adm_scale (scale {scale})")
    s = sums.float()
    return tuple(s[:, i] for i in range(6)), a_ref, a_dis


def adm_scale_cuda(ref, dis, scale: int = 0, egl=None):
    """The kernel at one scale (uint8 or f32 input); the same outputs as
    :func:`adm_scale_plain`."""
    if ref.device.type == "cpu":
        return adm_scale_plain(ref, dis, scale, egl)
    sums, a_ref, a_dis = _launch(ref, dis, scale, egl)
    adm_scale_cuda.launches += 1
    num, den = pool_scale(sums, a_ref.shape[-2], a_ref.shape[-1])
    return num, den, a_ref, a_dis


def adm_tail_cuda(a_ref, a_dis, egl=None) -> dict:
    """Scales 1-3 as three launches of the per-scale kernel on the f32
    approximation bands; the same output as :func:`adm_tail_plain`."""
    if a_ref.device.type == "cpu":
        return adm_tail_plain(a_ref, a_dis, egl)
    num = den = 0.0
    o, t = a_ref, a_dis
    for scale in (1, 2, 3):
        sums, o, t = _launch(o, t, scale, egl)
        n_s, d_s = pool_scale(sums, o.shape[-2], o.shape[-1])
        num, den = num + n_s, den + d_s
    adm_tail_cuda.launches += 1
    return {"num": num, "den": den}


adm_scale_cuda.launches = 0
adm_tail_cuda.launches = 0
