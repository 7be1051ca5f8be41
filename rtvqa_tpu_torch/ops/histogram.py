"""Histogram + Shannon-entropy ops (counterpart of
``rtvqa_tpu/ops/histogram.py``).

Counts come from one ``bincount`` over ``frame * 256 + level``: the JAX
one-hot compare would take 127 x 4096 x 256 x 4 B ~ 0.53 GB per channel on
the card, and the counts are integers either way. Quantization is
``round`` (half to even) then ``clip`` to [0, 255], as in the JAX ops; the
gray entropy masks zero bins, the color entropy adds ``1e-8`` inside the
log (the reference's deliberate asymmetry).
"""

from __future__ import annotations

import torch

from rtvqa_tpu_torch.ops.color import yuv_rows_to_rgb_planes
from rtvqa_tpu_torch.ops.resize import bilinear_sample_plan, bilinear_table, resize_cols

_NBINS = 256


def histogram_256(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) pixel values -> (..., 256) f32 counts of the rounded,
    clipped levels."""
    lead = x.shape[:-2]
    q = torch.round(x.float()).clamp(0, 255).to(torch.int64).reshape(-1, x.shape[-2] * x.shape[-1])
    frames = q.shape[0]
    offs = torch.arange(frames, device=x.device)[:, None] * _NBINS
    counts = torch.bincount((q + offs).reshape(-1), minlength=frames * _NBINS)
    return counts.reshape(*lead, _NBINS).float()


def entropy_masked(hist: torch.Tensor) -> torch.Tensor:
    """``-sum_{p>0} p log2 p`` over the trailing bin axis."""
    total = torch.sum(hist, dim=-1, keepdim=True)
    p = hist / total.clamp_min(1.0)
    logp = torch.where(p > 0, torch.log2(p.clamp_min(1e-30)), 0.0)
    return -torch.sum(p * logp, dim=-1)


def entropy_eps(hist: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """``-sum p log2(p + eps)`` over the trailing bin axis."""
    total = torch.sum(hist, dim=-1, keepdim=True)
    p = hist / total.clamp_min(1.0)
    return -torch.sum(p * torch.log2(p + eps), dim=-1)


def gray_entropy(gray: torch.Tensor) -> torch.Tensor:
    """Per-frame gray histogram entropy over (..., H, W)."""
    return entropy_masked(histogram_256(gray))


def _summed_channel_entropy(planes: torch.Tensor) -> torch.Tensor:
    """R + G + B entropies of channel-major (..., 3, H, W) planes."""
    ents = entropy_eps(histogram_256(planes))               # (..., 3)
    return (ents[..., 0] + ents[..., 1]) + ents[..., 2]


def color_entropy(rgb: torch.Tensor) -> torch.Tensor:
    """Per-frame summed R/G/B histogram entropies over (..., H, W, 3)."""
    return _summed_channel_entropy(torch.movedim(rgb, -1, -3))


def color_entropy_sampled(
    y: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    out_h: int,
    out_w: int,
    rw: torch.Tensor | None = None,
) -> torch.Tensor:
    """Summed R/G/B entropies of the bilinear-resized RGB frames, converting
    only the source rows the 2-tap row pass reads (bitwise equal to a
    full-res convert + resize). ``rw`` is the (out_w, W) column table."""
    h, w = y.shape[-2], y.shape[-1]
    ridx, rmat = bilinear_sample_plan(out_h, h)
    dev = y.device
    ridx_t = torch.from_numpy(ridx.copy()).to(dev)
    rmat_t = torch.from_numpy(rmat.copy()).to(dev)
    y_rows = y.index_select(-2, ridx_t)
    u_rows = u.index_select(-2, ridx_t // 2)
    v_rows = v.index_select(-2, ridx_t // 2)
    planes = torch.stack(yuv_rows_to_rgb_planes(y_rows, u_rows, v_rows), dim=-3)
    rgb_rows = torch.matmul(rmat_t, planes)                 # (..., 3, out_h, W)
    if w != out_w:
        rw = bilinear_table(out_w, w, dev) if rw is None else rw
        rgb_rows = resize_cols(rgb_rows, rw)
    return _summed_channel_entropy(rgb_rows)
