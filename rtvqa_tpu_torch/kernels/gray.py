"""YUV420 -> gray: the CUDA kernel ``csrc/gray.cu`` and its plain version.

Replaces ``rtvqa_tpu/kernels/gray_pallas.py::yuv420_to_gray_pallas``. The
plain version is ``ops/color.py::yuv420_to_gray``; the wrapper takes it only
for tensors on the CPU. For CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from rtvqa_tpu_torch.kernels._build import check_launch, load_library, require_cuda
from rtvqa_tpu_torch.ops.color import yuv420_to_gray as yuv420_to_gray_plain

_INT32_MAX = 2**31 - 1


def gray_path(w: int, y_ptr: int, u_ptr: int, v_ptr: int) -> str:
    """The kernel's path for frames ``w`` wide at these data pointers:
    "vector" (2-row x 4-column quads: 4-byte luma, 2-byte chroma loads and
    one 16-byte store per row) where w % 4 == 0, y is 4-byte and u, v
    2-byte aligned, so that every row is aligned too; "general" (byte
    loads) for anything else, e.g. 854-wide frames or a view at an odd
    offset."""
    if w % 4 == 0 and y_ptr % 4 == 0 and u_ptr % 2 == 0 and v_ptr % 2 == 0:
        return "vector"
    return "general"


def gray_items(path: str, b: int, h: int, w: int) -> int:
    """Work items of one launch: 2x4 quads on the vector path, 2x32 runs
    (one per warp) on the general path. The kernel counts them in 32 bits."""
    return b * ((h + 1) // 2) * (w // 4 if path == "vector" else -(-w // 32))


def yuv420_to_gray_cuda(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, W) + 2x (B, ceil(H/2), ceil(W/2)) uint8 -> (B, H, W) f32 gray."""
    if y.device.type == "cpu":
        return yuv420_to_gray_plain(y, u, v)
    require_cuda("y", y, torch.uint8, 3)
    require_cuda("u", u, torch.uint8, 3)
    require_cuda("v", v, torch.uint8, 3)
    b, h, w = y.shape
    hc, wc = (h + 1) // 2, (w + 1) // 2
    if u.shape != (b, hc, wc) or v.shape != (b, hc, wc):
        raise ValueError(
            f"chroma planes must be {(b, hc, wc)}, got {tuple(u.shape)} and {tuple(v.shape)}"
        )
    if u.device != y.device or v.device != y.device:
        raise ValueError("y, u and v must be on one device")
    out = torch.empty((b, h, w), dtype=torch.float32, device=y.device)
    if out.numel() == 0:
        return out
    path = gray_path(w, y.data_ptr(), u.data_ptr(), v.data_ptr())
    if gray_items(path, b, h, w) > _INT32_MAX:
        raise ValueError(f"gray kernel takes fewer than 2^31 {path} items, got {b}x{h}x{w}")
    lib = load_library()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        code = lib.rtvqa_yuv420_to_gray(
            y.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, w, hc, wc,
            int(path == "vector"), stream,
        )
    check_launch(lib, code, "yuv420_to_gray")
    yuv420_to_gray_cuda.launches += 1
    return out


yuv420_to_gray_cuda.launches = 0


def gray_occupancy(device) -> dict:
    """Each path's launch figures on ``device``: blocks per SM (the
    occupancy API), registers per thread, local (spill) bytes per thread."""
    lib = load_library()
    figures = {}
    for path in ("vector", "general"):
        out = (ctypes.c_int * 3)()
        with torch.cuda.device(device):
            check_launch(lib, lib.rtvqa_gray_occupancy(int(path == "vector"), out), "gray_occupancy")
        figures[path] = dict(zip(("blocks_per_sm", "registers", "local_bytes"), out))
    return figures
