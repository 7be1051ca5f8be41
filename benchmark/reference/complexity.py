"""Plain reference of the per-frame scene-complexity values: for a batch of
(previous, current) sampled YUV420 frame pairs, the seven values the
streaming accumulator keeps per slot: pyramid block-match motion, DCT
energy, gray entropy, Canny edge count, ORB keypoint count, color entropy
and temporal DCT difference.

A frozen copy of the plain PyTorch definitions the port's suite is held to
(BT.601 gray, cv2 bilinear geometry, cv2 Canny and FAST/ORB rules), trimmed
to what the benchmark compares. It imports nothing of the program. Floats
run in ``prec.FLOAT`` and matrix products through ``prec.mm``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import prec

VALUE_KEYS = ("motion", "dct", "histogram", "edge", "orb", "color", "temporal_dct")
ORB_SIZE = 64

_Y_SCALE = 255.0 / 219.0
_V_R = 255.0 / 224.0 * 1.402
_U_G = -255.0 / 224.0 * 0.344136
_V_G = -255.0 / 224.0 * 0.714136
_U_B = 255.0 / 224.0 * 1.772


# --- color --------------------------------------------------------------


def _rgb_rows(y_rows, u_rows, v_rows):
    cols = torch.arange(y_rows.shape[-1], device=y_rows.device) // 2
    yf = prec.f(y_rows) - 16.0
    uf = prec.f(u_rows).index_select(-1, cols) - 128.0
    vf = prec.f(v_rows).index_select(-1, cols) - 128.0
    r = _Y_SCALE * yf + _V_R * vf
    g = _Y_SCALE * yf + _U_G * uf + _V_G * vf
    b = _Y_SCALE * yf + _U_B * uf
    return r.clamp(0.0, 255.0), g.clamp(0.0, 255.0), b.clamp(0.0, 255.0)


def gray(y, u, v) -> torch.Tensor:
    """BT.601 limited YUV420 -> full-range RGB, clipped, then luma weights."""
    rows = torch.arange(y.shape[-2], device=y.device) // 2
    r, g, b = _rgb_rows(y, u.index_select(-2, rows), v.index_select(-2, rows))
    return r * 0.299 + g * 0.587 + b * 0.114


# --- bilinear resize (cv2 INTER_LINEAR geometry) -------------------------


@functools.lru_cache(maxsize=64)
def _bilinear(dst: int, src: int) -> np.ndarray:
    m = np.zeros((dst, src), dtype=np.float32)
    scale = src / dst
    for i in range(dst):
        x = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        frac = x - x0
        m[i, min(max(x0, 0), src - 1)] += 1.0 - frac
        m[i, min(max(x0 + 1, 0), src - 1)] += frac
    return m


def table(dst: int, src: int, device) -> torch.Tensor:
    return torch.from_numpy(_bilinear(dst, src).copy()).to(device)


def resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    h, w = x.shape[-2], x.shape[-1]
    if h != out_h:
        x = prec.mm(table(out_h, h, x.device), x)
    if w != out_w:
        x = prec.mm(x, table(out_w, w, x.device).t())
    return x


# --- DCT ----------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _dct_matrix(n: int) -> np.ndarray:
    k, m = np.arange(n)[:, None], np.arange(n)[None, :]
    d = np.cos(np.pi * (2 * m + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    d[0] *= np.sqrt(0.5)
    return d


def dct_energy(g: torch.Tensor) -> torch.Tensor:
    """sum(dct2(g)^2) by Parseval."""
    g = prec.f(g)
    return torch.sum(g * g, dim=(-2, -1))


def temporal_dct(prev: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
    """sum |dct2(prev) - dct2(cur)| as the DCT of the difference."""
    diff = prec.f(prev) - prec.f(cur)
    dh = torch.from_numpy(_dct_matrix(diff.shape[-2]).astype(np.float32)).to(diff.device)
    dw = torch.from_numpy(_dct_matrix(diff.shape[-1]).astype(np.float32)).to(diff.device)
    return torch.sum(torch.abs(prec.mm(prec.mm(dh, diff), dw.t())), dim=(-2, -1))


# --- histograms and entropies -------------------------------------------


def _hist256(x: torch.Tensor) -> torch.Tensor:
    lead = x.shape[:-2]
    q = torch.round(prec.f(x)).clamp(0, 255).to(torch.int64).reshape(-1, x.shape[-2] * x.shape[-1])
    offs = torch.arange(q.shape[0], device=x.device)[:, None] * 256
    counts = torch.bincount((q + offs).reshape(-1), minlength=q.shape[0] * 256)
    return prec.f(counts.reshape(*lead, 256))


def gray_entropy(g: torch.Tensor) -> torch.Tensor:
    hist = _hist256(g)
    p = hist / torch.sum(hist, dim=-1, keepdim=True).clamp_min(1.0)
    logp = torch.where(p > 0, torch.log2(p.clamp_min(1e-30)), 0.0)
    return -torch.sum(p * logp, dim=-1)


def color_entropy(y, u, v, out_h: int, out_w: int) -> torch.Tensor:
    """Summed R/G/B entropies (log2(p + 1e-8)) of the bilinear-resized RGB
    frame, converting only the rows the row pass reads."""
    h, w = y.shape[-2], y.shape[-1]
    m = _bilinear(out_h, h)
    idx = np.unique(np.nonzero(m)[1]).astype(np.int64)
    ridx = torch.from_numpy(idx).to(y.device)
    rmat = torch.from_numpy(np.ascontiguousarray(m[:, idx])).to(y.device)
    planes = torch.stack(_rgb_rows(y.index_select(-2, ridx), u.index_select(-2, ridx // 2),
                                   v.index_select(-2, ridx // 2)), dim=-3)
    rgb = prec.mm(rmat, planes)
    if w != out_w:
        rgb = prec.mm(rgb, table(out_w, w, y.device).t())
    hist = _hist256(rgb)
    p = hist / torch.sum(hist, dim=-1, keepdim=True).clamp_min(1.0)
    ents = -torch.sum(p * torch.log2(p + 1e-8), dim=-1)
    return (ents[..., 0] + ents[..., 1]) + ents[..., 2]


# --- Canny --------------------------------------------------------------

_TG22 = 0.4142135623730951
_TG67 = 2.414213562373095


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    h, w = x.shape[-2], x.shape[-1]
    rows = (torch.arange(h, device=x.device) + dy).clamp(0, h - 1)
    cols = (torch.arange(w, device=x.device) + dx).clamp(0, w - 1)
    return x.index_select(-2, rows).index_select(-1, cols)


def canny_count(g: torch.Tensor, low: float = 100.0, high: float = 200.0) -> torch.Tensor:
    """Replicate-border Sobel, L1 magnitude, the cv2 sector NMS, double
    threshold and 8-connected hysteresis to a fixed point; pixels per frame."""
    g = prec.f(g)
    tl, t, tr = _shift(g, -1, -1), _shift(g, -1, 0), _shift(g, -1, 1)
    lf, rt = _shift(g, 0, -1), _shift(g, 0, 1)
    bl, b, br = _shift(g, 1, -1), _shift(g, 1, 0), _shift(g, 1, 1)
    gx = (tr + 2.0 * rt + br) - (tl + 2.0 * lf + bl)
    gy = (bl + 2.0 * b + br) - (tl + 2.0 * t + tr)
    mag = torch.abs(gx) + torch.abs(gy)
    ax, ay = torch.abs(gx), torch.abs(gy)
    horiz, vert = ay <= _TG22 * ax, ay >= _TG67 * ax
    diag = ~(horiz | vert)

    def keep_along(dy, dx):
        return (mag > _shift(mag, dy, dx)) & (mag >= _shift(mag, -dy, -dx))

    keep = ((horiz & keep_along(0, 1)) | (vert & keep_along(1, 0))
            | (diag & torch.where((gx * gy) >= 0, keep_along(1, 1), keep_along(1, -1))))
    nms = torch.where(keep, mag, 0.0)
    cur, weak = nms > high, nms > low
    h, w = g.shape[-2], g.shape[-1]
    for _ in range(h * w):
        grown = F.max_pool2d(cur.reshape(-1, 1, h, w).to(torch.float32), 3, stride=1, padding=1) > 0
        nxt = cur | (weak & grown.reshape(cur.shape))
        if torch.equal(nxt, cur):
            break
        cur = nxt
    return prec.f(torch.sum(cur, dim=(-2, -1)))


# --- ORB keypoint count -------------------------------------------------

CIRCLE16 = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _interior(h, w, margin, device):
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return (ys >= margin) & (ys < h - margin) & (xs >= margin) & (xs < w - margin)


def _arc_max_min9(d: torch.Tensor) -> torch.Tensor:
    m2 = torch.minimum(d, torch.roll(d, -1, dims=0))
    m4 = torch.minimum(m2, torch.roll(m2, -2, dims=0))
    m8 = torch.minimum(m4, torch.roll(m4, -4, dims=0))
    return torch.amax(torch.minimum(m8, torch.roll(d, -8, dims=0)), dim=0)


def orb_count(g: torch.Tensor, nfeatures=500, nlevels=8, scale_factor=1.2, edge=31, fast=20.0):
    """FAST-9/16 corners (max over arcs of the min contrast, > threshold),
    strict 3x3 NMS, the ORB border masked, counted over the rounded image
    pyramid and capped at ``nfeatures``."""
    h, w = g.shape[-2], g.shape[-1]
    total = torch.zeros(g.shape[:-2], dtype=prec.FLOAT, device=g.device)
    for lvl in range(nlevels):
        s = scale_factor ** lvl
        lh, lw = max(1, int(round(h / s))), max(1, int(round(w / s)))
        if 2 * edge >= min(lh, lw):
            continue
        x = prec.f(g if (lh, lw) == (h, w) else resize(prec.f(g), lh, lw))
        p = F.pad(x, (3, 3, 3, 3))
        ring = torch.stack([p[..., 3 + dy: 3 + dy + lh, 3 + dx: 3 + dx + lw] for dy, dx in CIRCLE16])
        bright = ring - x[None]
        score = torch.maximum(_arc_max_min9(bright), _arc_max_min9(-bright))
        score = torch.where(_interior(lh, lw, 3, g.device), score, 0.0)
        score = torch.where(score > fast, score, 0.0)
        q = F.pad(score, (1, 1, 1, 1), value=float("-inf"))
        neigh = torch.amax(torch.stack([q[..., 1 + dy: 1 + dy + lh, 1 + dx: 1 + dx + lw]
                                        for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx]), dim=0)
        kmap = torch.where(score > neigh, score, 0.0)
        kmap = torch.where(_interior(lh, lw, edge, g.device), kmap, 0.0)
        total = total + prec.f(torch.sum(kmap > 0, dim=(-2, -1)))
    return torch.clamp(total, max=float(nfeatures))


# --- pyramid block-match motion -----------------------------------------


def _down2(x: torch.Tensor) -> torch.Tensor:
    h, w = (x.shape[-2] // 2) * 2, (x.shape[-1] // 2) * 2
    xc = prec.f(x[..., :h, :w])
    s = xc[..., 0::2, 0::2] + xc[..., 0::2, 1::2]
    s = s + xc[..., 1::2, 0::2]
    s = s + xc[..., 1::2, 1::2]
    return 0.25 * s


def block_match(prev: torch.Tensor, cur: torch.Tensor, block: int, radius: int) -> torch.Tensor:
    """Mean displacement magnitude of the exhaustive block search: tiles
    cropped to the block grid, the previous frame replicate-padded, the
    first minimum in dy-major raster order; the mean from the float64
    histogram of best candidates."""
    h, w = cur.shape[-2], cur.shape[-1]
    hb, wb = (h // block) * block, (w // block) * block
    c, p = cur[..., :hb, :wb], prev[..., :hb, :wb]
    rows = torch.arange(-radius, hb + radius, device=p.device).clamp(0, hb - 1)
    cols = torch.arange(-radius, wb + radius, device=p.device).clamp(0, wb - 1)
    pp = p.index_select(-2, rows).index_select(-1, cols)
    lead, nby, nbx, side = c.shape[:-2], hb // block, wb // block, 2 * radius + 1
    best_sad = torch.full((*lead, nby, nbx), float("inf"), device=c.device)
    best_k = torch.zeros((*lead, nby, nbx), dtype=torch.int64, device=c.device)
    for k in range(side * side):
        dy, dx = divmod(k, side)
        sad = torch.abs(c - pp[..., dy: dy + hb, dx: dx + wb]).reshape(*lead, nby, block, nbx, block)
        sad = sad.sum(dim=(-3, -1))
        better = sad < best_sad
        best_sad = torch.where(better, sad, best_sad)
        best_k = torch.where(better, k, best_k)
    flat = best_k.reshape(-1, nby * nbx)
    counts = torch.zeros((flat.shape[0], side * side), dtype=torch.int64, device=flat.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    kk = torch.arange(side * side, device=flat.device)
    mag = torch.sqrt(((kk // side - radius) ** 2 + (kk % side - radius) ** 2).to(torch.float64))
    return prec.f((counts.to(torch.float64) * mag).sum(-1) / flat.shape[1]).reshape(lead)


def pair_values(py, pu, pv, cy, cu, cv, resize_h: int, resize_w: int,
                block: int = 16, radius: int = 8) -> dict:
    """The seven values of each (previous, current) pair in a batch of
    (B, H, W) planes: slot g of the accumulator holds sampled frame g
    against g-1."""
    gp, gc = gray(py, pu, pv), gray(cy, cu, cv)
    motion = 2.0 * block_match(_down2(gp), _down2(gc), max(block // 2, 1), max(radius // 2, 1))
    rs_p, rs_c = resize(gp, resize_h, resize_w), resize(gc, resize_h, resize_w)
    return {
        "motion": motion,
        "dct": dct_energy(rs_c),
        "histogram": gray_entropy(rs_c),
        "edge": canny_count(rs_c),
        "orb": orb_count(resize(gc, ORB_SIZE, ORB_SIZE)),
        "color": color_entropy(cy, cu, cv, resize_h, resize_w),
        "temporal_dct": temporal_dct(rs_p, rs_c),
    }
