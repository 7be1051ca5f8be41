"""Block-matching motion complexity, plain PyTorch (counterpart of
``rtvqa_tpu/ops/motion.py``).

Partition the current frame into ``block x block`` tiles (H, W cropped down
to multiples of ``block`` FIRST), replicate-pad the cropped previous frame by
``radius``, and for each tile take the displacement within ±radius that
minimizes the SAD — candidates in raster order, dy-major, first minimum
wins. The metric is the mean displacement magnitude over tiles.

The mean is taken from the per-candidate histogram of the best indices, in
float64, then rounded to f32. Equal displacement fields therefore give equal
means whatever order the tiles are visited in, which lets the CUDA kernel
(``kernels/motion.py``) be held to exact equality on integer-valued frames.

The production search is the pyramid: 2x2-mean downsample, exhaustive at
block/2 and radius/2, magnitudes scaled by 2. ``block_match_motion_pyramid``
takes it pairwise and ``block_match_motion_pyramid_series`` over the
consecutive pairs of one series (pooled once); the pooling is per frame, so
the two give the same values on the same pairs.
``block_match_motion_pyramid2_series`` is the JAX package's two-level
experiment, a measured dead end that no default path runs.
"""

from __future__ import annotations

import torch


def _edge_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Replicate-pad the last two dimensions by ``pad`` (any ``pad``, also
    one larger than the frame)."""
    h, w = x.shape[-2], x.shape[-1]
    rows = torch.arange(-pad, h + pad, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-pad, w + pad, device=x.device).clamp(0, w - 1)
    return x.index_select(-2, rows).index_select(-1, cols)


def block_match_index(
    prev_gray: torch.Tensor, curr_gray: torch.Tensor, block: int = 16, radius: int = 8
) -> torch.Tensor:
    """Best candidate index per tile: (..., H, W) -> (..., nby, nbx) int64,
    index ``k = (dy + r) * (2r + 1) + (dx + r)``."""
    h, w = curr_gray.shape[-2], curr_gray.shape[-1]
    hb, wb = (h // block) * block, (w // block) * block
    curr = curr_gray[..., :hb, :wb].float()
    prev = prev_gray[..., :hb, :wb].float()
    dev = curr.device
    prev_p = _edge_pad(prev, radius)

    lead = curr.shape[:-2]
    nby, nbx = hb // block, wb // block
    side = 2 * radius + 1
    best_sad = torch.full((*lead, nby, nbx), float("inf"), device=dev)
    best_k = torch.zeros((*lead, nby, nbx), dtype=torch.int64, device=dev)
    for k in range(side * side):
        dy, dx = divmod(k, side)
        d = torch.abs(curr - prev_p[..., dy : dy + hb, dx : dx + wb])
        sad = d.reshape(*lead, nby, block, nbx, block).sum(dim=(-3, -1))
        better = sad < best_sad  # strict: first (raster-order) minimum wins
        best_sad = torch.where(better, sad, best_sad)
        best_k = torch.where(better, k, best_k)
    return best_k


def block_match_field(
    prev_gray: torch.Tensor, curr_gray: torch.Tensor, block: int = 16, radius: int = 8
) -> tuple[torch.Tensor, torch.Tensor]:
    """Displacement field of the exhaustive search: (..., H, W) -> (dy, dx),
    each (..., nby, nbx) f32; first (raster-order) minimum wins."""
    best_k = block_match_index(prev_gray, curr_gray, block, radius)
    side = 2 * radius + 1
    return (best_k // side - radius).float(), (best_k % side - radius).float()


def displacement_magnitudes(radius: int, device: torch.device) -> torch.Tensor:
    """(side*side,) float64 ``|(dy, dx)|`` of each candidate index."""
    side = 2 * radius + 1
    k = torch.arange(side * side, device=device)
    dy = (k // side - radius).to(torch.float64)
    dx = (k % side - radius).to(torch.float64)
    return torch.sqrt(dy * dy + dx * dx)


def mean_magnitude(best_k: torch.Tensor, radius: int) -> torch.Tensor:
    """Mean displacement magnitude of an index field (..., nby, nbx) -> (...,)
    f32, from the float64 histogram form (see the module docstring)."""
    side = 2 * radius + 1
    lead = best_k.shape[:-2]
    flat = best_k.reshape(-1, best_k.shape[-2] * best_k.shape[-1])
    counts = torch.zeros((flat.shape[0], side * side), dtype=torch.int64, device=flat.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    total = (counts.to(torch.float64) * displacement_magnitudes(radius, flat.device)).sum(-1)
    return (total / flat.shape[1]).to(torch.float32).reshape(lead)


def block_match_motion(
    prev_gray: torch.Tensor, curr_gray: torch.Tensor, block: int = 16, radius: int = 8
) -> torch.Tensor:
    """Mean block displacement magnitude per pair: (..., H, W) -> (...,) f32.
    The plain version of the ``motion`` CUDA kernel."""
    return mean_magnitude(block_match_index(prev_gray, curr_gray, block, radius), radius)


def down2_mean(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean pooling (..., H, W) -> (..., H//2, W//2); odd tails cropped.
    Summed in raster order within the window, then scaled by 0.25."""
    h = (x.shape[-2] // 2) * 2
    w = (x.shape[-1] // 2) * 2
    xc = x[..., :h, :w].float()
    s = xc[..., 0::2, 0::2] + xc[..., 0::2, 1::2]
    s = s + xc[..., 1::2, 0::2]
    s = s + xc[..., 1::2, 1::2]
    return 0.25 * s


def block_match_motion_pyramid(
    prev_gray: torch.Tensor, curr_gray: torch.Tensor, block: int = 16, radius: int = 8
) -> torch.Tensor:
    """Pyramid motion per pair: (..., H, W) -> (...,) f32. On CUDA tensors the
    search runs in the block-match kernel, the leading dimensions folded
    into its batch; on the CPU in the plain version."""
    bp = max(block // 2, 1)
    rp = max(radius // 2, 1)
    pg, cg = down2_mean(prev_gray), down2_mean(curr_gray)
    if cg.device.type == "cpu":
        return 2.0 * block_match_motion(pg, cg, block=bp, radius=rp)
    # kernels/motion.py imports this module, so the kernel is imported here.
    from rtvqa_tpu_torch.kernels.motion import block_match_motion_cuda

    lead = cg.shape[:-2]
    flat = [a.reshape(-1, *a.shape[-2:]) for a in (pg, cg)]
    return 2.0 * block_match_motion_cuda(*flat, block=bp, radius=rp).reshape(lead)


def block_match_motion_pyramid_series(
    gray_series: torch.Tensor,
    block: int = 16,
    radius: int = 8,
    impl: str = "plain",
) -> torch.Tensor:
    """Pyramid motion over consecutive pairs of one series: (N, H, W) ->
    (N-1,). The series is pooled once; ``impl`` is "plain" or "kernel"
    (the CUDA block-match kernel)."""
    bp = max(block // 2, 1)
    rp = max(radius // 2, 1)
    gh = down2_mean(gray_series)
    if impl == "kernel":
        from rtvqa_tpu_torch.kernels.motion import block_match_motion_cuda

        return 2.0 * block_match_motion_cuda(gh[:-1], gh[1:], block=bp, radius=rp)
    if impl != "plain":
        raise ValueError(f"impl must be 'plain' or 'kernel', got {impl!r}")
    return 2.0 * block_match_motion(gh[:-1], gh[1:], block=bp, radius=rp)


def block_match_motion_pyramid2_series(
    gray_series: torch.Tensor, block: int = 16, radius: int = 8
) -> torch.Tensor:
    """Two-level pyramid motion over consecutive pairs of one series:
    (N, H, W) -> (N-1,) f32. An exhaustive search at quarter resolution
    (block/4, radius/4), then a ±1 refinement at half resolution around each
    block's coarse vector, on plain ops; the refinement's previous image is
    a 25-way masked select of the coarse-shifted slices of the edge-padded
    half-resolution frame.

    **Measured dead end, not production.** A half-quarter-pixel true shift
    makes the quarter-resolution SAD landscape ambiguous: the small coarse
    blocks take their argmin nearly at random within the coarse radius, and
    the ±1 refinement cannot recover from a wrong coarse vector, so the
    metric drifts ~1.7x from the truth where the single-level pyramid is
    exact (the JAX package's
    ``tests/test_complexity_ops.py::test_pyramid2_documented_failure_mode``;
    here ``tests/test_torch_api_ops.py``). No default path runs it; it is
    the record of the experiment, as in the JAX package."""
    bp = max(block // 2, 1)
    rp = max(radius // 2, 1)
    bq = max(bp // 2, 1)
    rq = max(rp // 2, 1)
    gh = down2_mean(gray_series)  # half resolution
    gq = down2_mean(gh)           # quarter resolution
    cdy, cdx = block_match_field(gq[:-1], gq[1:], block=bq, radius=rq)

    # Half resolution cropped to the block grid the coarse field describes.
    nby, nbx = cdy.shape[-2], cdy.shape[-1]
    hb, wb = nby * bp, nbx * bp
    prev_h = gh[:-1, :hb, :wb]
    curr_h = gh[1:, :hb, :wb]
    pad_r = 2 * rq + 1  # the largest coarse shift, 2 rq, plus the refinement's 1
    prev_p = _edge_pad(prev_h, pad_r)
    sel = torch.zeros_like(prev_h)
    for cy in range(-rq, rq + 1):
        for cx in range(-rq, rq + 1):
            m = (cdy == cy) & (cdx == cx)  # (N-1, nby, nbx)
            mpix = m.repeat_interleave(bp, -2).repeat_interleave(bp, -1)
            oy, ox = pad_r + 2 * cy, pad_r + 2 * cx
            sel = sel + torch.where(mpix, prev_p[:, oy : oy + hb, ox : ox + wb], 0.0)

    ody, odx = block_match_field(sel, curr_h, block=bp, radius=1)
    fdy = 2.0 * cdy + ody
    fdx = 2.0 * cdx + odx
    # The mean sums in float64, as ``mean_magnitude`` does: equal fields give
    # equal values whatever order the blocks are summed in.
    mag = torch.sqrt(fdy * fdy + fdx * fdx)
    return 2.0 * mag.double().mean(dim=(-2, -1)).float()


def fps_variation(
    timestamps_ms: torch.Tensor, valid: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Instantaneous fps ``1/dt`` per consecutive sampled-timestamp pair;
    nonpositive dt -> 0.0. Returns ((N-1,) fps, (N-1,) pair validity)."""
    ts = timestamps_ms.float()
    dt = (ts[..., 1:] - ts[..., :-1]) / 1000.0
    fps = torch.where(dt > 0, 1.0 / dt.clamp_min(1e-9), 0.0)
    pair_valid = valid[..., 1:] & valid[..., :-1]
    return fps * pair_valid.to(fps.dtype), pair_valid
