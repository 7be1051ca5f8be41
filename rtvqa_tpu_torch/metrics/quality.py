"""Full-reference PSNR and SSIM with FFmpeg-filter semantics (counterpart of
``rtvqa_tpu/metrics/quality.py``).

**PSNR** (libavfilter vf_psnr): per frame, the SSE of each plane; the
frame's ``mse_avg`` is the total SSE over the total pixel count of Y, U and
V; the pooled PSNR is ``10*log10(255^2 / mean-over-frames(mse_avg))``
(``inf`` for identical streams).

**SSIM** (libavfilter vf_ssim, the x264 algorithm): per plane, 4x4 block
sums of ref, dis, ref^2+dis^2 and ref*dis; each window aggregates 2x2
adjacent blocks (8x8 pixels, stride 4); x264's ``ssim_end1`` with the
integer constants c1 = 416, c2 = 235963; plane score = mean over windows,
frame "All" = plane scores weighted by plane pixel counts.

SSEs and block sums are integer sums (int64 / int32), so they are exact;
the SSIM rational is evaluated in f32 in the JAX ops' order.
"""

from __future__ import annotations

import torch

SSIM_C1 = int(0.01 * 0.01 * 255 * 255 * 64 + 0.5)         # 416
SSIM_C2 = int(0.03 * 0.03 * 255 * 255 * 64 * 63 + 0.5)    # 235963


def plane_sse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact per-frame SSE over the trailing (H, W) axes, as f32."""
    d = a.to(torch.int64) - b.to(torch.int64)
    return (d * d).sum(dim=(-2, -1)).float()


def to_psnr(mse: torch.Tensor) -> torch.Tensor:
    """vf_psnr's per-frame PSNR; ``inf`` where the MSE is 0."""
    finite = 10.0 * torch.log10((255.0 * 255.0) / mse.clamp_min(1e-30))
    return torch.where(mse > 0.0, finite, torch.full_like(finite, float("inf")))


def psnr_from_sse(sse_y, sse_u, sse_v, n_y: int, n_c: int) -> dict:
    mse_y, mse_u, mse_v = sse_y / n_y, sse_u / n_c, sse_v / n_c
    mse_avg = (sse_y + sse_u + sse_v) / (n_y + 2 * n_c)
    return {
        "mse_y": mse_y, "mse_u": mse_u, "mse_v": mse_v, "mse_avg": mse_avg,
        "psnr_y": to_psnr(mse_y), "psnr_avg": to_psnr(mse_avg),
    }


def psnr_frames(ref_y, ref_u, ref_v, dis_y, dis_u, dis_v) -> dict:
    """Per-frame MSE/PSNR over (N,H,W) + 2x(N,h,w) planes (vf_psnr)."""
    n_y = ref_y.shape[-2] * ref_y.shape[-1]
    n_c = ref_u.shape[-2] * ref_u.shape[-1]
    return psnr_from_sse(
        plane_sse(ref_y, dis_y), plane_sse(ref_u, dis_u), plane_sse(ref_v, dis_v), n_y, n_c
    )


def pooled_psnr(mse_avg_frames: torch.Tensor) -> torch.Tensor:
    """FFmpeg's global average: the PSNR of the mean frame MSE."""
    return to_psnr(mse_avg_frames.float().mean())


def block_sums_4x4(a: torch.Tensor) -> torch.Tensor:
    """(..., H, W) int -> (..., H//4, W//4) int32 4x4 block sums, partial
    blocks at the border dropped (vf_ssim's ``width >> 2``)."""
    h4, w4 = a.shape[-2] // 4, a.shape[-1] // 4
    x = a[..., : 4 * h4, : 4 * w4].to(torch.int32)
    return x.reshape(*x.shape[:-2], h4, 4, w4, 4).sum(dim=(-3, -1), dtype=torch.int32)


def ssim_window_sums(ref: torch.Tensor, dis: torch.Tensor) -> torch.Tensor:
    """Per-window x264 SSIM of one plane: (..., H, W) uint8 ->
    (..., H//4-1, W//4-1) f32."""
    r = ref.to(torch.int32)
    d = dis.to(torch.int32)
    s1 = block_sums_4x4(r)
    s2 = block_sums_4x4(d)
    ss = block_sums_4x4(r * r + d * d)
    s12 = block_sums_4x4(r * d)

    def win(x):  # 2x2 aggregation of adjacent blocks -> 8x8 windows, stride 4
        return (x[..., :-1, :-1] + x[..., :-1, 1:] + x[..., 1:, :-1] + x[..., 1:, 1:]).float()

    w1, w2, wss, w12 = win(s1), win(s2), win(ss), win(s12)
    vars_ = wss * 64.0 - w1 * w1 - w2 * w2
    covar = w12 * 64.0 - w1 * w2
    num = (2.0 * w1 * w2 + SSIM_C1) * (2.0 * covar + SSIM_C2)
    den = (w1 * w1 + w2 * w2 + SSIM_C1) * (vars_ + SSIM_C2)
    return num / den


def ssim_plane(ref: torch.Tensor, dis: torch.Tensor) -> torch.Tensor:
    """Per-frame x264 SSIM score of one plane: (..., H, W) -> (...,)."""
    return ssim_window_sums(ref, dis).mean(dim=(-2, -1))


def ssim_all(sy, su, sv, n_y: int, n_c: int) -> torch.Tensor:
    return (sy * n_y + su * n_c + sv * n_c) / (n_y + 2 * n_c)


def ssim_frames(ref_y, ref_u, ref_v, dis_y, dis_u, dis_v) -> dict:
    """Per-frame SSIM Y/U/V/All for YUV420 batches (vf_ssim)."""
    sy = ssim_plane(ref_y, dis_y)
    su = ssim_plane(ref_u, dis_u)
    sv = ssim_plane(ref_v, dis_v)
    n_y = ref_y.shape[-2] * ref_y.shape[-1]
    n_c = ref_u.shape[-2] * ref_u.shape[-1]
    return {"ssim_y": sy, "ssim_u": su, "ssim_v": sv, "ssim_all": ssim_all(sy, su, sv, n_y, n_c)}
