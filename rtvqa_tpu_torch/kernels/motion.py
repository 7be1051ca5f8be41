"""Block-matching motion: the CUDA kernel ``csrc/motion.cu`` and its plain
version.

Replaces ``rtvqa_tpu/kernels/motion_pallas.py::block_match_motion_pallas``.
The plain version is ``ops/motion.py::block_match_motion``; the wrapper takes
it only for tensors on the CPU. For CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from rtvqa_tpu_torch.kernels._build import check_launch, load_library, require_cuda
from rtvqa_tpu_torch.ops.motion import block_match_motion as block_match_motion_plain


def block_match_motion_cuda(
    prev_gray: torch.Tensor, curr_gray: torch.Tensor, block: int = 16, radius: int = 8
) -> torch.Tensor:
    """Mean block displacement magnitude per pair: (B, H, W) f32 -> (B,) f32.
    H and W are cropped to whole blocks inside the kernel."""
    if curr_gray.device.type == "cpu":
        return block_match_motion_plain(prev_gray, curr_gray, block, radius)
    require_cuda("prev_gray", prev_gray, torch.float32, 3)
    require_cuda("curr_gray", curr_gray, torch.float32, 3)
    if prev_gray.shape != curr_gray.shape or prev_gray.device != curr_gray.device:
        raise ValueError(
            f"prev/curr must match: {tuple(prev_gray.shape)} on {prev_gray.device} vs "
            f"{tuple(curr_gray.shape)} on {curr_gray.device}"
        )
    if block < 1 or radius < 0:
        raise ValueError(f"need block >= 1 and radius >= 0, got {block}, {radius}")
    _, out = _launch(prev_gray, curr_gray, block, radius)
    if out.numel():
        block_match_motion_cuda.launches += 1
    return out


def _launch(prev_gray, curr_gray, block: int, radius: int):
    """One ``rtvqa_block_match_motion`` call on checked CUDA inputs: (the
    (B, H/block, W/block) int32 best-index field the search writes, the (B,)
    f32 means)."""
    b, h, w = curr_gray.shape
    nby, nbx = h // block, w // block
    if nby == 0 or nbx == 0:
        raise ValueError(f"frame {h}x{w} holds no whole {block}x{block} block")
    out = torch.empty((b,), dtype=torch.float32, device=curr_gray.device)
    best = torch.empty((b, nby, nbx), dtype=torch.int32, device=curr_gray.device)
    if b == 0:
        return best, out
    lib = load_library()
    with torch.cuda.device(curr_gray.device):
        stream = torch.cuda.current_stream(curr_gray.device).cuda_stream
        code = lib.rtvqa_block_match_motion(
            prev_gray.data_ptr(), curr_gray.data_ptr(), best.data_ptr(), out.data_ptr(),
            b, h, w, block, radius, stream,
        )
    check_launch(lib, code, "block_match_motion")
    return best, out


block_match_motion_cuda.launches = 0
