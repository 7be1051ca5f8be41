"""VMAF motion / motion2 features (counterpart of ``rtvqa_tpu/vmaf/motion.py``).

libvmaf's motion feature blurs each reference luma frame with the 5-tap
``FILTER_5`` window (separably, mirrored borders), then

  motion[t]  = mean |blur(y[t]) - blur(y[t-1])|      (0 for the first frame)
  motion2[t] = min(motion[t], motion[t+1])            (motion[t] for the last)

``motion_sads`` gives the SADs of one chunk of frames against the blurred
frame before it, so a long clip runs in chunks with one frame of overlap;
each SAD depends only on its own pair, so the chunk size moves no value.
The plain chunk of the streaming engine (``metrics/full_reference.py::
program_a``) takes its SADs from here too, carrying the blur across chunks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from rtvqa_tpu_torch.vmaf.filters import filter1d_sep

FILTER_5 = np.array(
    [0.054488685, 0.244201342, 0.402619947, 0.244201342, 0.054488685],
    dtype=np.float64,
)


def motion_sads(ref_y: torch.Tensor, prev_blur: Optional[torch.Tensor] = None):
    """(SADs, blur of the last frame) of (N, H, W) luma: N - 1 SADs of
    consecutive frames, or N with ``prev_blur`` (the blurred frame before
    the first). Each mean is an f64 sum of the f32 differences over a
    frame, rounded to f32. A reduction's order can follow how many frames
    it takes at once; in f64 that order moves the sum by ~1e-16 relative,
    below what the f32 result keeps."""
    blur = filter1d_sep(ref_y.float(), FILTER_5)
    prev = blur[:-1] if prev_blur is None else torch.cat([prev_blur[None], blur[:-1]])
    cur = blur[1:] if prev_blur is None else blur
    diff = (cur - prev).abs().to(torch.float64)
    sad = (diff.sum(dim=(-2, -1)) / (blur.shape[-2] * blur.shape[-1])).float()
    return sad, blur[-1]


def motion_from_sads(sad: torch.Tensor) -> dict[str, torch.Tensor]:
    """``{"motion", "motion2"}`` (N,) f32 from the N - 1 consecutive SADs."""
    zero = torch.zeros((1,), dtype=sad.dtype, device=sad.device)
    motion = torch.cat([zero, sad])
    fwd = torch.cat([sad, torch.full((1,), float("inf"), dtype=sad.dtype, device=sad.device)])
    return {"motion": motion, "motion2": torch.minimum(motion, fwd)}


def motion_features(ref_y: torch.Tensor, chunk: Optional[int] = None) -> dict[str, torch.Tensor]:
    """Per-frame motion/motion2 over (N, H, W) reference luma (VMAF's motion
    is computed on the reference only), ``chunk`` frames at a time (None:
    all at once)."""
    n = ref_y.shape[0]
    chunk = n if chunk is None else chunk
    sads, carry = [], None
    for start in range(0, n, max(chunk, 1)):
        sad, carry = motion_sads(ref_y[start:start + chunk], carry)
        sads.append(sad)
    sad = torch.cat(sads) if sads else torch.zeros((0,), device=ref_y.device)
    return motion_from_sads(sad)
