"""YUV420 -> gray: the CUDA kernel ``csrc/gray.cu`` and its plain version.

Replaces ``rtvqa_tpu/kernels/gray_pallas.py::yuv420_to_gray_pallas``. The
plain version is ``ops/color.py::yuv420_to_gray``; the wrapper takes it only
for tensors on the CPU. For CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from rtvqa_tpu_torch.kernels._build import check_launch, load_library, require_cuda
from rtvqa_tpu_torch.ops.color import yuv420_to_gray as yuv420_to_gray_plain


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
    if b > 65535 or h > 65535:
        raise ValueError(f"gray kernel grid takes at most 65535 frames and rows, got {b}x{h}")
    out = torch.empty((b, h, w), dtype=torch.float32, device=y.device)
    if out.numel() == 0:
        return out
    lib = load_library()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        code = lib.rtvqa_yuv420_to_gray(
            y.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, w, hc, wc, stream
        )
    check_launch(lib, code, "yuv420_to_gray")
    yuv420_to_gray_cuda.launches += 1
    return out


yuv420_to_gray_cuda.launches = 0
