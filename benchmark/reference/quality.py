"""Plain reference of the per-frame quality series: PSNR/MSE (libavfilter
vf_psnr), x264 SSIM (vf_ssim), the VMAF motion SAD (FILTER_5 blur), VIF at
four scales and ADM2, for a batch of frames.

A frozen copy of the plain PyTorch definitions the port's quality route is
held to (the FFmpeg and libvmaf float semantics), trimmed to what the
benchmark compares. It imports nothing of the program. Floats run in
``prec.FLOAT``; the integer sums are exact.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import prec

KEYS = (
    "mse_y", "mse_u", "mse_v", "mse_avg", "psnr_y", "psnr_avg",
    "ssim_y", "ssim_u", "ssim_v", "ssim_all", "motion_sad",
    "vif_scale0", "vif_scale1", "vif_scale2", "vif_scale3", "adm2",
)

SSIM_C1 = int(0.01 * 0.01 * 255 * 255 * 64 + 0.5)         # 416
SSIM_C2 = int(0.03 * 0.03 * 255 * 255 * 64 * 63 + 0.5)    # 235963

FILTER_5 = np.array([0.054488685, 0.244201342, 0.402619947, 0.244201342, 0.054488685])


# --- separable filters: numpy border modes, taps summed one by one -------


@functools.lru_cache(maxsize=256)
def _border_np(n: int, before: int, after: int, mode: str) -> np.ndarray:
    return np.pad(np.arange(n), (before, after), mode={"reflect": "reflect", "edge": "edge"}[mode])


def border_index(n, before, after, mode, device) -> torch.Tensor:
    return torch.from_numpy(_border_np(n, before, after, mode)).to(device)


def conv1d(x: torch.Tensor, taps, axis: int, mode: str = "reflect") -> torch.Tensor:
    """1D correlation along axis -1 or -2; ``k//2`` samples of border
    before, ``k-1-k//2`` after."""
    taps_a = np.asarray(taps, dtype=np.float32)
    k = len(taps_a)
    half = k // 2
    n = x.shape[axis]
    xp = prec.f(x).index_select(x.dim() + axis, border_index(n, half, k - 1 - half, mode, x.device))
    acc = None
    for t in range(k):
        term = float(taps_a[t]) * xp.narrow(x.dim() + axis, t, n)
        acc = term if acc is None else acc + term
    return acc


def filter_sep(x: torch.Tensor, taps, mode: str = "reflect") -> torch.Tensor:
    return conv1d(conv1d(x, taps, -2, mode), taps, -1, mode)


def gaussian_kernel(n: int, sigma: float) -> np.ndarray:
    x = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


# --- PSNR and SSIM ------------------------------------------------------


def plane_sse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a.to(torch.int64) - b.to(torch.int64)
    return prec.f((d * d).sum(dim=(-2, -1)))


def to_psnr(mse: torch.Tensor) -> torch.Tensor:
    finite = 10.0 * torch.log10((255.0 * 255.0) / mse.clamp_min(1e-30))
    return torch.where(mse > 0.0, finite, torch.full_like(finite, float("inf")))


def psnr(ry, ru, rv, dy, du, dv) -> dict:
    n_y = ry.shape[-2] * ry.shape[-1]
    n_c = ru.shape[-2] * ru.shape[-1]
    sy, su, sv = plane_sse(ry, dy), plane_sse(ru, du), plane_sse(rv, dv)
    mse_y, mse_u, mse_v = sy / n_y, su / n_c, sv / n_c
    mse_avg = (sy + su + sv) / (n_y + 2 * n_c)
    return {"mse_y": mse_y, "mse_u": mse_u, "mse_v": mse_v, "mse_avg": mse_avg,
            "psnr_y": to_psnr(mse_y), "psnr_avg": to_psnr(mse_avg)}


def _block_sums_4x4(a: torch.Tensor) -> torch.Tensor:
    h4, w4 = a.shape[-2] // 4, a.shape[-1] // 4
    x = a[..., : 4 * h4, : 4 * w4].to(torch.int32)
    return x.reshape(*x.shape[:-2], h4, 4, w4, 4).sum(dim=(-3, -1), dtype=torch.int32)


def ssim_plane(ref: torch.Tensor, dis: torch.Tensor) -> torch.Tensor:
    """Per-frame x264 SSIM of one plane: 4x4 block sums, 8x8 windows at
    stride 4, ``ssim_end1``'s rational, the mean over windows."""
    r, d = ref.to(torch.int32), dis.to(torch.int32)
    s1, s2 = _block_sums_4x4(r), _block_sums_4x4(d)
    ss, s12 = _block_sums_4x4(r * r + d * d), _block_sums_4x4(r * d)

    def win(x):
        return prec.f(x[..., :-1, :-1] + x[..., :-1, 1:] + x[..., 1:, :-1] + x[..., 1:, 1:])

    w1, w2, wss, w12 = win(s1), win(s2), win(ss), win(s12)
    vars_ = wss * 64.0 - w1 * w1 - w2 * w2
    covar = w12 * 64.0 - w1 * w2
    num = (2.0 * w1 * w2 + SSIM_C1) * (2.0 * covar + SSIM_C2)
    den = (w1 * w1 + w2 * w2 + SSIM_C1) * (vars_ + SSIM_C2)
    return (num / den).mean(dim=(-2, -1))


def ssim(ry, ru, rv, dy, du, dv) -> dict:
    sy, su, sv = ssim_plane(ry, dy), ssim_plane(ru, du), ssim_plane(rv, dv)
    n_y = ry.shape[-2] * ry.shape[-1]
    n_c = ru.shape[-2] * ru.shape[-1]
    return {"ssim_y": sy, "ssim_u": su, "ssim_v": sv,
            "ssim_all": (sy * n_y + su * n_c + sv * n_c) / (n_y + 2 * n_c)}


# --- VMAF motion SAD ----------------------------------------------------


def motion_sad(ref_y: torch.Tensor, prev_ref_y: torch.Tensor) -> torch.Tensor:
    """mean |blur(y[t]) - blur(y[t-1])| per frame: the float differences
    summed in float64, the mean rounded to the working type."""
    cur, prev = filter_sep(ref_y, FILTER_5), filter_sep(prev_ref_y, FILTER_5)
    diff = (cur - prev).abs().to(torch.float64)
    return prec.f(diff.sum(dim=(-2, -1)) / (cur.shape[-2] * cur.shape[-1]))


# --- VIF ----------------------------------------------------------------

_SIGMA_NSQ = 2.0
_EPS = 1e-10


def _vif_stats(ref, dis, taps):
    mu1, mu2 = filter_sep(ref, taps), filter_sep(dis, taps)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = (filter_sep(ref * ref, taps) - mu1_sq).clamp_min(0.0)
    sigma2_sq = (filter_sep(dis * dis, taps) - mu2_sq).clamp_min(0.0)
    sigma12 = filter_sep(ref * dis, taps) - mu1_mu2
    g = sigma12 / (sigma1_sq + _EPS)
    sv_sq = sigma2_sq - g * sigma12
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    small1 = sigma1_sq < _EPS
    g = torch.where(small1, zero, g)
    sv_sq = torch.where(small1, sigma2_sq, sv_sq)
    sigma1_sq = torch.where(small1, zero, sigma1_sq)
    small2 = sigma2_sq < _EPS
    g = torch.where(small2, zero, g)
    sv_sq = torch.where(small2, zero, sv_sq)
    neg_g = g < 0
    sv_sq = torch.where(neg_g, sigma2_sq, sv_sq)
    g = torch.where(neg_g, zero, g)
    sv_sq = sv_sq.clamp_min(_EPS)
    num = torch.log2(1.0 + g * g * sigma1_sq / (sv_sq + _SIGMA_NSQ))
    den = torch.log2(1.0 + sigma1_sq / _SIGMA_NSQ)
    return num.sum(dim=(-2, -1)), den.sum(dim=(-2, -1))


def vif(ref_y: torch.Tensor, dis_y: torch.Tensor) -> dict:
    """VIF scales 0-3: scale k has 2^(4-k)+1 taps, sigma = taps/5; from
    scale 1 on, both images are blurred with that window and decimated."""
    ref, dis = prec.f(ref_y), prec.f(dis_y)
    out = {}
    for scale in range(4):
        n = 2 ** (4 - scale) + 1
        taps = gaussian_kernel(n, n / 5.0)
        if scale > 0:
            ref = filter_sep(ref, taps)[..., ::2, ::2]
            dis = filter_sep(dis, taps)[..., ::2, ::2]
        num, den = _vif_stats(ref, dis, taps)
        out[f"vif_scale{scale}"] = num / den.clamp_min(_EPS)
    return out


# --- ADM ----------------------------------------------------------------

DB2_LO = np.array([0.482962913144690, 0.836516303737469, 0.224143868042013, -0.129409522550921])
DB2_HI = np.array([-0.129409522550921, -0.224143868042013, 0.836516303737469, -0.482962913144690])
_COS_1DEG_SQ = math.cos(math.pi / 180.0) ** 2
_WATSON = {"a": 0.495, "k": 0.466, "f0": 0.401, "g": (1.501, 1.0, 0.534)}


def _csf(scale: int) -> tuple[float, float, float]:
    r = 3.0 * 1080 * math.pi / 180.0

    def q(theta: int) -> float:
        g = _WATSON["g"][theta]
        temp = math.log10((2.0 ** (scale + 1)) * _WATSON["f0"] * g / r)
        return 2.0 * _WATSON["a"] * (10.0 ** (_WATSON["k"] * temp * temp)) / g

    return 1.0 / q(0), 1.0 / q(0), 1.0 / q(1)


def _dwt(x: torch.Tensor):
    lo = conv1d(x, DB2_LO, -2)[..., ::2, :]
    hi = conv1d(x, DB2_HI, -2)[..., ::2, :]

    def cols(y, taps):
        return conv1d(y, taps, -1)[..., ::2]

    return cols(lo, DB2_LO), cols(lo, DB2_HI), cols(hi, DB2_LO), cols(hi, DB2_HI)


def _crop(h: int, w: int):
    top, left = max(int(h * 0.1) - 1, 1), max(int(w * 0.1) - 1, 1)
    return slice(top, h - top), slice(left, w - left)


def _adm_scale(o, t, scale: int):
    o, oh, ov, od = _dwt(o)
    t, th, tv, td = _dwt(t)
    ot_dp = oh * th + ov * tv
    angle_ok = (ot_dp >= 0.0) & (ot_dp * ot_dp >= _COS_1DEG_SQ * (oh * oh + ov * ov) * (th * th + tv * tv))

    def restore(a, b):
        ratio = b / (a + torch.where(a >= 0, 1e-30, -1e-30))
        return torch.where(angle_ok, b, ratio.clamp(0.0, 1.0) * a)

    rh, rv, rd = restore(oh, th), restore(ov, tv), restore(od, td)
    fh, fv, fd = _csf(scale)
    x = ((th - rh) * fh).abs() + ((tv - rv) * fv).abs() + ((td - rd) * fd).abs()
    h, w = x.shape[-2], x.shape[-1]
    p = x.index_select(-2, border_index(h, 1, 1, "edge", x.device))
    p = p.index_select(-1, border_index(w, 1, 1, "edge", x.device))
    acc = 2.0 * x
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                acc = acc + p[..., 1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]
    thr = acc / 30.0
    ys, xs = _crop(oh.shape[-2], oh.shape[-1])
    sums = []
    for rst, orig, fac in ((rh, oh, fh), (rv, ov, fv), (rd, od, fd)):
        masked = ((rst * fac).abs() - thr).clamp_min(0.0)
        sums.append((masked[..., ys, xs] ** 3).sum(dim=(-2, -1)))
        sums.append(((orig[..., ys, xs] * fac).abs() ** 3).sum(dim=(-2, -1)))
    area = (ys.stop - ys.start) * (xs.stop - xs.start)
    offset = (area / 32.0) ** (1.0 / 3.0)
    roots = torch.stack(sums, dim=-1).double() ** (1.0 / 3.0)
    num = roots[..., 0::2].sum(dim=-1) + 3.0 * offset
    den = roots[..., 1::2].sum(dim=-1) + 3.0 * offset
    return o, t, prec.f(num), prec.f(den)


def adm2(ref_y: torch.Tensor, dis_y: torch.Tensor) -> torch.Tensor:
    """sum over 4 db2 levels of the restored-detail L3 pools over the
    original-detail L3 pools; 1 where the denominator is degenerate."""
    o, t = prec.f(ref_y), prec.f(dis_y)
    num_total = den_total = 0.0
    for scale in range(4):
        o, t, num, den = _adm_scale(o, t, scale)
        num_total = num_total + num
        den_total = den_total + den
    limit = 1e-2 * (ref_y.shape[-2] * ref_y.shape[-1]) / (1920.0 * 1080.0)
    return torch.where(den_total < limit, torch.ones_like(num_total), num_total / den_total.clamp_min(1e-30))


def quality_frames(ry, ru, rv, dy, du, dv, prev_ry, has_prev: torch.Tensor) -> dict:
    """The 16 per-frame series of ``KEYS`` for a batch of (B, H, W) ref/dis
    YUV420 frames; ``prev_ry`` holds each frame's previous ref luma, and
    ``has_prev`` (B,) bool masks the SAD of a clip's first frame to 0."""
    out = psnr(ry, ru, rv, dy, du, dv)
    out.update(ssim(ry, ru, rv, dy, du, dv))
    sad = motion_sad(ry, prev_ry)
    out["motion_sad"] = torch.where(has_prev.to(sad.device), sad, torch.zeros_like(sad))
    out.update(vif(ry, dy))
    out["adm2"] = adm2(ry, dy)
    return {k: out[k] for k in KEYS}
