"""The strip-read floor probes: the CUDA kernels of ``csrc/probes.cu`` and
their plain versions.

* ``strip_sum_cuda`` (kernel 8) replaces the kernel of
  ``scripts/probe_int8_dma.py`` (``run``): per-frame sums over 32-row
  strips of u8 or f32 frames. The TPU kernel read each strip as its 48-row
  window at an 8-aligned row (the plain version still takes each strip's
  valid rows from that window); the kernel reads each strip's valid rows,
  which partition the frame, once.
* ``strip_floor_cuda`` (kernel 9) replaces the kernel of
  ``scripts/probe_dma_floor.py`` (``floor``): every 56-row window at a
  48-row stride read into shared memory and touched once, f32, bf16 or u8
  input — the strip-read floor.

The wrappers take the plain versions only for tensors on the CPU; for CUDA
tensors they launch the kernel or raise.
"""

from __future__ import annotations

import torch

from rtvqa_tpu_torch.kernels._build import check_launch, load_library, require_cuda
from rtvqa_tpu_torch.obs.roofline import (
    FLOOR_STRIDE,
    FLOOR_WINDOW,
    STRIP_SUM_ROWS,
    STRIP_SUM_WINDOW,
)

_FLOOR_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}


def _strip_sum_check(x) -> None:
    """The windows cover every row only for H >= 48 and a multiple of 8: the
    last window starts at the 8-aligned row at or below H - 48."""
    if x.dim() != 3:
        raise ValueError(f"x must be (N, H, W), got shape {tuple(x.shape)}")
    h = x.shape[1]
    if h < STRIP_SUM_WINDOW or h % 8:
        raise ValueError(f"H = {h}: the {STRIP_SUM_WINDOW}-row windows at 8-aligned rows cover "
                         "every row only for H >= 48 and a multiple of 8")


def _window_row(s: int, h: int) -> int:
    """First row of strip s's window: ``clip((row0 - 8) // 8, 0, (h - 48)
    // 8) * 8`` with row0 = 32 s (``vif_pallas.py::_dma_row_start``)."""
    row0 = STRIP_SUM_ROWS * s
    return min(max((row0 - 8) // 8, 0), (h - STRIP_SUM_WINDOW) // 8) * 8


def strip_sum_plain(x):
    """(N,) f32: per strip, the sum of its valid rows [row0, row0 + min(32,
    H - row0)) taken from its window; the strips summed per frame. float64
    throughout."""
    _strip_sum_check(x)
    h = x.shape[1]
    total = torch.zeros(x.shape[0], dtype=torch.float64, device=x.device)
    for s in range(-(-h // STRIP_SUM_ROWS)):
        row0, st = STRIP_SUM_ROWS * s, _window_row(s, h)
        window = x[:, st:st + STRIP_SUM_WINDOW]
        valid = window[:, row0 - st:row0 - st + min(STRIP_SUM_ROWS, h - row0)]
        total += valid.double().sum(dim=(1, 2))
    return total.float()


def strip_sum_cuda(x):
    """Kernel 8 on a uint8 or f32 (N, H, W) tensor: each frame read once;
    the same output as :func:`strip_sum_plain`."""
    if x.device.type == "cpu":
        return strip_sum_plain(x)
    require_cuda("x", x, (torch.uint8, torch.float32), 3)
    _strip_sum_check(x)
    n, h, w = x.shape
    lib = load_library()
    sums = torch.empty((n,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.rtvqa_strip_sum(x.data_ptr(), x.element_size(), n, h, w, sums.data_ptr(), stream)
    check_launch(lib, code, "strip_sum")
    strip_sum_cuda.launches += 1
    strip_sum_cuda.launches_by_type["u8" if x.dtype == torch.uint8 else "f32"] += 1
    return sums


def _strip_floor_check(x) -> int:
    """n_s = H // 48, after checking that the last window stays inside H."""
    if x.dim() != 3:
        raise ValueError(f"x must be (N, H, W), got shape {tuple(x.shape)}")
    h = x.shape[1]
    n_s = h // FLOOR_STRIDE
    if n_s == 0 or (n_s - 1) * FLOOR_STRIDE + FLOOR_WINDOW > h:
        raise ValueError(f"H = {h}: the last {FLOOR_WINDOW}-row window at a {FLOOR_STRIDE}-row "
                         f"stride would end at row {(n_s - 1) * FLOOR_STRIDE + FLOOR_WINDOW}")
    return n_s


def strip_floor_plain(x):
    """() f32: the sum over frames i and windows s of x[i, 48 s, 0], in
    float64."""
    n_s = _strip_floor_check(x)
    return x[:, 0:n_s * FLOOR_STRIDE:FLOOR_STRIDE, 0].double().sum().float()


def strip_floor_cuda(x):
    """Kernel 9 on an f32, bf16 or uint8 (N, H, W) tensor; the same output
    as :func:`strip_floor_plain`, every window read into shared memory."""
    if x.device.type == "cpu":
        return strip_floor_plain(x)
    require_cuda("x", x, tuple(_FLOOR_DTYPES), 3)
    n_s = _strip_floor_check(x)
    n, h, w = x.shape
    lib = load_library()
    part = torch.empty((max(n * n_s, 1),), dtype=torch.float64, device=x.device)
    out = torch.zeros((), dtype=torch.float64, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.rtvqa_strip_floor(x.data_ptr(), _FLOOR_DTYPES[x.dtype], n, h, w, part.data_ptr(),
                                     out.data_ptr(), stream)
    check_launch(lib, code, "strip_floor")
    strip_floor_cuda.launches += 1
    return out.float()


strip_sum_cuda.launches = 0
strip_sum_cuda.launches_by_type = {"u8": 0, "f32": 0}  # the same launches, by input type
strip_floor_cuda.launches = 0
