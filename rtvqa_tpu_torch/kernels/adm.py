"""ADM per scale: the CUDA kernel ``csrc/adm.cu`` and its plain versions.

``adm_scale_cuda`` replaces ``rtvqa_tpu/kernels/adm_pallas.py::
adm_scale_pallas`` (scale 0 on the uint8 luma pair); ``adm_tail_cuda``
replaces ``adm_pallas.py::adm_tail_pallas``: the same per-scale kernel for
scales 1-3 on the f32 approximation bands. The kernel returns
the six center-crop L3 sums per frame and scale; the cube roots and the
per-band ``cbrt(area/32)`` offsets are taken here, after the sums, by the
same ``vmaf.adm.pool_scale`` as the plain versions (for the three scales
of ``adm_tail_cuda`` in one call). ``adm_tail_cuda`` makes one
call into the library (``rtvqa_adm_tail``: the kernel once per scale on
one scratch, one fixed-order reduce). ``adm_input_cuda`` (kernel
6a) replaces ``adm_scale_pallas(..., stages=0)``: kernel 6's input path
and a checksum only, to time what kernel 6 pays to load its windows. The
wrappers take the plain versions only for tensors on the CPU; for CUDA
tensors they launch the kernel or raise.
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
    adm_one_scale,
    crop_offset,
    csf_rfactors,
    pool_scale,
)

DB2 = np.concatenate([DB2_LO, DB2_HI]).astype(np.float32)


def adm_scale_plain(ref, dis, scale: int = 0, egl=None):
    """(num (B,), den (B,), a_ref, a_dis) of one scale, offsets included;
    a_* are the (B, ceil(H/2), ceil(W/2)) f32 next-scale inputs."""
    a_o, a_t, num, den = adm_one_scale(ref.float(), dis.float(), scale, egl)
    return num, den, a_o, a_t


def adm_tail_plain(a_ref, a_dis, egl=None) -> dict:
    """``{"num": (B,), "den": (B,)}``: scales 1-3 summed, offsets included."""
    num = den = 0.0
    o, t = a_ref, a_dis
    for scale in (1, 2, 3):
        n_s, d_s, o, t = adm_scale_plain(o, t, scale, egl)
        num, den = num + n_s, den + d_s
    return {"num": num, "den": den}


def _check_pair(ref, dis) -> None:
    if ref.shape != dis.shape or ref.dtype != dis.dtype or ref.device != dis.device:
        raise ValueError(f"ref/dis must match: {tuple(ref.shape)} {ref.dtype} vs "
                         f"{tuple(dis.shape)} {dis.dtype}")


def _launch(ref, dis, scale: int, egl):
    """One per-scale launch: (six (B,) f32 sums, a_ref, a_dis)."""
    require_cuda("ref", ref, (torch.uint8, torch.float32), 3)
    require_cuda("dis", dis, (torch.uint8, torch.float32), 3)
    _check_pair(ref, dis)
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
    num, den = pool_scale(torch.stack(sums, dim=-1), crop_offset(a_ref.shape[-2], a_ref.shape[-1]))
    return num, den, a_ref, a_dis


def adm_tail_cuda(a_ref, a_dis, egl=None) -> dict:
    """Scales 1-3 in one call of the kernel library on the f32
    approximation bands; the same output as :func:`adm_tail_plain`."""
    if a_ref.device.type == "cpu":
        return adm_tail_plain(a_ref, a_dis, egl)
    require_cuda("a_ref", a_ref, torch.float32, 3)
    require_cuda("a_dis", a_dis, torch.float32, 3)
    _check_pair(a_ref, a_dis)
    b, h, w = a_ref.shape
    grids, csf, crop = [], [], []
    for scale in (1, 2, 3):
        h, w = (h + 1) // 2, (w + 1) // 2
        ys, xs = _center_crop_slices(h, w)
        grids.append((h, w))
        csf.extend(csf_rfactors(scale))
        crop.extend((ys.start, xs.start))
    csf, crop = np.asarray(csf, np.float32), np.asarray(crop, np.int32)
    dev = a_ref.device
    lib = load_library()
    img = torch.empty((max(lib.rtvqa_adm_tail_scratch_floats(*a_ref.shape), 1),),
                      dtype=torch.float32, device=dev)
    part = torch.empty((max(lib.rtvqa_adm_tail_scratch_doubles(*a_ref.shape), 1),),
                       dtype=torch.float64, device=dev)
    sums = torch.empty((b, 18), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.rtvqa_adm_tail(
            a_ref.data_ptr(), a_dis.data_ptr(), *a_ref.shape, DB2.ctypes.data, csf.ctypes.data,
            crop.ctypes.data, float(np.float32(_COS_1DEG_SQ)),
            float(egl if egl is not None else 0.0), int(egl is not None),
            img.data_ptr(), part.data_ptr(), sums.data_ptr(), stream,
        )
    check_launch(lib, code, "adm_tail")
    adm_tail_cuda.launches += 1
    num, den = pool_scale(sums.float(), sum(crop_offset(h2, w2) for h2, w2 in grids))
    return {"num": num, "den": den}


def adm_strip_plan(h: int, w: int) -> tuple[int, int, int]:
    """(strip, n_strips, st_cap8) of the TPU kernel's strip plan for an
    (h, w) input (``adm_pallas.py::adm_scale_pallas``, the strip choice and
    the edge-padded row count ``h_arr``): strip s reads raw rows from
    ``st_s = clip(floor((2*s*strip - 4) / 8), 0, st_cap8) * 8``."""
    h2 = (h + 1) // 2
    strip = 24 if w >= 1536 else (64 if w >= 640 else 128)
    while strip > 16 and strip - h2 >= 16:
        strip //= 2
    while strip > 8 and 2 * strip + 16 > h:
        strip //= 2
    rows_in = 2 * strip + 16
    h_arr = max(-(-h // 8) * 8, rows_in)
    return strip, -(-h2 // strip), (h_arr - rows_in) // 8


def adm_strip_rows(h: int, w: int) -> list[int]:
    """The raw row ``st_s`` of every strip of the plan (each < h)."""
    strip, n_strips, st_cap8 = adm_strip_plan(h, w)
    return [min(max((2 * s * strip - 4) // 8, 0), st_cap8) * 8 for s in range(n_strips)]


def adm_input_plain(ref, dis):
    """(num (B,), den (B,), a_ref, a_dis) of ``adm_scale_pallas(ref, dis, 0,
    stages=0)``: num is the checksum ``sum_s ref[:, st_s, 0] + dis[:, st_s,
    0]`` over the strip plan, den is 0 and the planes are zero
    (B, ceil(H/2), ceil(W/2)) views of one zero. Sums in float64."""
    _check_pair(ref, dis)
    b, h, w = ref.shape
    rows = torch.tensor(adm_strip_rows(h, w), device=ref.device)
    num = (ref[:, rows, 0].double() + dis[:, rows, 0].double()).sum(dim=1).float()
    return _input_outputs(num, h, w)


def _input_outputs(num, h: int, w: int):
    zero = num.new_zeros(())
    planes = zero.expand(num.shape[0], (h + 1) // 2, (w + 1) // 2)
    return num, zero.expand(num.shape[0]), planes, planes


def adm_input_cuda(ref, dis):
    """Kernel 6a (uint8 or f32 pair): kernel 6's input path and the
    checksum; the same outputs as :func:`adm_input_plain`."""
    if ref.device.type == "cpu":
        return adm_input_plain(ref, dis)
    require_cuda("ref", ref, (torch.uint8, torch.float32), 3)
    require_cuda("dis", dis, (torch.uint8, torch.float32), 3)
    _check_pair(ref, dis)
    b, h, w = ref.shape
    strip, n_strips, st_cap8 = adm_strip_plan(h, w)
    dev = ref.device
    lib = load_library()
    part = torch.empty((max(lib.rtvqa_adm_scratch(b, h, w) // 6, 1),), dtype=torch.float64, device=dev)
    sums = torch.empty((b,), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.rtvqa_adm_input(
            ref.data_ptr(), dis.data_ptr(), int(ref.dtype == torch.uint8), b, h, w,
            strip, n_strips, st_cap8, part.data_ptr(), sums.data_ptr(), stream,
        )
    check_launch(lib, code, "adm_input")
    adm_input_cuda.launches += 1
    return _input_outputs(sums.float(), h, w)


adm_scale_cuda.launches = 0
adm_tail_cuda.launches = 0
adm_input_cuda.launches = 0
