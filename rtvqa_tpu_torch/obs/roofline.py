"""Analytic roofline accounting on the H100: the bytes and operations of
each kernel's function and of the two device phases, against the card's
peaks (the counterpart of ``rtvqa_tpu/obs/roofline.py``, whose peaks are a
TPU's).

``chip_smoke.py`` and the probes take every kernel's bound from here:
``bound_ms`` is the larger of the bytes over the HBM rate and the
operations over the f32 rate outside the tensor cores.

The JAX package's ``obs/jaxcache.py`` (a persistent XLA compilation cache)
has no counterpart: the port compiles its kernels once per checkout into a
library whose name hashes the sources (``kernels/_build.py``,
``build/rtvqa_tpu_torch/``), and that library is its cache.

Counting rules
--------------
* **Bytes** are compulsory device-memory traffic: each input array read
  once, each output written once, each materialised intermediate written
  and read back once. The phases move the same arrays on the port as on the
  TPU path (u8 YUV pair in, f32 half-resolution dec pair out and back in, u8
  luma pair into ADM scale 0, f32 approximation pair out and back in), so
  ``quality_roofline`` and ``complexity_roofline`` keep the JAX module's byte
  counts. Kernel 8's function is the per-frame sum, so its bytes are the
  frames', which it reads once. Kernel
  9's function is the read of its windows into shared memory (one touch
  each keeps every load), so its bytes are the rows its windows cover,
  each counted once: the 8 rows two windows share are read twice, but
  need to come from memory only once. ``strip_floor_windows`` counts
  them per window, for its read rate.
* **Operations** are the f32 (and integer) operations the port's kernels
  execute (``csrc/*.cu``): a K-tap filter output is K multiplies and K-1
  adds; the VIF statistics are the five moment filters, vertical and
  horizontal, plus 3 products and ~30 operations of clamps, ratios and
  log2 per pixel; the SSE is 3 and the SSIM block and window sums ~10
  integer operations per pixel and plane; the ADM per-subband-pixel work
  (decoupling, CSF, 3x3 mask, six cubes and sums) is 86 operations. Integer
  operations are counted at the f32 rate too.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W limit.
"""

from __future__ import annotations

#: HBM3 bandwidth, bytes/s.
HBM_BYTES_PER_S = 3.35e12
#: f32 outside the tensor cores (FMA counted as two), operations/s.
F32_OPS_PER_S = 67e12
#: Dense tensor-core peaks, for reference only: no kernel of the port uses them.
TF32_TENSOR_OPS_PER_S = 495e12
BF16_TENSOR_OPS_PER_S = 989e12

#: Kernel 8's strip and window rows, kernel 9's window stride and rows.
STRIP_SUM_ROWS, STRIP_SUM_WINDOW = 32, 48
FLOOR_STRIDE, FLOOR_WINDOW = 48, 56


def kernel_bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(bound in ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ----- Work of each kernel's function: (bytes, operations) ------------------


def _taps_ops(k: int) -> int:
    return 2 * k - 1


def _vif_stats_ops(k: int) -> int:
    return 3 + 10 * _taps_ops(k) + 30


def _filter_dec_ops(k: int, h: int, w: int) -> int:
    """Two images, vertical pass at the even rows, horizontal at the even columns."""
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    return 2 * _taps_ops(k) * (h2 * w + h2 * w2)


def _adm_scale_ops(h: int, w: int) -> int:
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    return 2 * 2 * _taps_ops(4) * h2 * w + (2 * 4 * _taps_ops(4) + 86) * h2 * w2


def gray_work(b, h, w, hc, wc):
    """Kernel 1: the u8 YUV420 frames in, f32 gray out."""
    return b * h * w * (1 + 4) + 2 * b * hc * wc, 23 * b * h * w


def motion_work(pairs, h, w, block, radius):
    """Kernel 2: the f32 pairs in, one f32 per pair out; 3 operations per
    pixel and candidate."""
    nblocks = pairs * (h // block) * (w // block)
    return 2 * 4 * pairs * h * w + 4 * pairs, 3 * nblocks * block * block * (2 * radius + 1) ** 2


def quality_work(b, h, w, hc, wc):
    """Kernel 3: the u8 YUV pair and the f32 blur carry in; nine per-frame
    scalars, the carry and the f32 scale-1 pair out."""
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    nbytes = 2 * b * h * w + 4 * b * hc * wc + 2 * 4 * h * w + 2 * 4 * b * h2 * w2 + 9 * 4 * b
    per_luma = 13 + (2 * _taps_ops(5) + 3) + _vif_stats_ops(17)
    ops = b * (per_luma * h * w + _filter_dec_ops(9, h, w) + 2 * 13 * hc * wc)
    return nbytes, ops


def _vif_scale_ops(scale: int, h: int, w: int) -> int:
    """One frame of VIF at ``scale`` (0-3) on (h, w): the 2^(4-s)+1-tap
    statistics and, below scale 3, the next scale's 2^(3-s)+1-tap filter of
    both images at the even rows and columns."""
    ops = _vif_stats_ops(2 ** (4 - scale) + 1) * h * w
    if scale < 3:
        ops += _filter_dec_ops(2 ** (3 - scale) + 1, h, w)
    return ops


def vif_tail_work(b, h1, w1):
    """Kernel 5: the f32 scale-1 pair in, three per-frame values out."""
    ops, h, w = 0, h1, w1
    for scale in (1, 2, 3):
        ops += _vif_scale_ops(scale, h, w)
        h, w = (h + 1) // 2, (w + 1) // 2
    return 2 * 4 * b * h1 * w1 + 3 * 4 * b, b * ops


def vif_scale_work(b, h, w, in_bytes=1, scale=0):
    """Kernel 4 at ``scale`` on a (b, h, w) pair of ``in_bytes``-byte
    elements (u8 at scale 0, f32 after): the pair in, one vif value per
    frame out and, below scale 3, the f32 decimated pair out."""
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    planes = 2 * 4 * b * h2 * w2 if scale < 3 else 0
    return 2 * in_bytes * b * h * w + planes + 4 * b, b * _vif_scale_ops(scale, h, w)


def adm_scale0_work(b, h, w):
    """Kernel 6: the u8 luma pair in; num, den and the f32 approximation pair out."""
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    return 2 * b * h * w + 2 * 4 * b * h2 * w2 + 2 * 4 * b, b * _adm_scale_ops(h, w)


def adm_tail_work(b, h1, w1):
    """Kernel 7: the f32 scale-1 approximation pair in, num and den out."""
    ops, h, w = 0, h1, w1
    for _ in range(3):
        ops += _adm_scale_ops(h, w)
        h, w = (h + 1) // 2, (w + 1) // 2
    return 2 * 4 * b * h1 * w1 + 2 * 4 * b, b * ops


def adm_input_work(b, h, w, n_strips):
    """Kernel 6a on a u8 pair: kernel 6's input read once, num and den out
    (the zero planes are a view, not written); one add per strip and frame."""
    return 2 * b * h * w + 2 * 4 * b, 2 * b * n_strips


def strip_sum_work(n, h, w, itemsize):
    """Kernel 8: the frames read once, one f32 sum per frame out; one add
    per element."""
    return n * h * w * itemsize + 4 * n, n * h * w


def strip_floor_work(n, h, w, itemsize):
    """Kernel 9: the rows its 56-row windows at a 48-row stride cover, each
    read once, one f32 out; one add per window."""
    n_s = h // FLOOR_STRIDE
    return n * (FLOOR_STRIDE * (n_s - 1) + FLOOR_WINDOW) * w * itemsize + 4, n * n_s


def strip_floor_windows(n, h, w, itemsize):
    """Bytes of kernel 9's windows, overlaps counted per window: what it
    reads, for its read rate."""
    return n * (h // FLOOR_STRIDE) * FLOOR_WINDOW * w * itemsize


# ----- Phases, per frame ----------------------------------------------------


def quality_roofline(h: int, w: int) -> dict:
    """Per-frame bytes and operations of the quality chunk on the card
    (``metrics/full_reference.py::chunk_kernels``): the fused
    kernel reads the u8 y/u/v pair and writes the f32 scale-1 dec pair; the
    VIF tail reads it back; ADM scale 0 reads the u8 luma pair and writes
    the f32 approximation pair; the ADM tail reads it back."""
    hw = float(h * w)
    dec_pair = 2.0 * (hw / 4) * 4
    reads = 3.0 * hw + dec_pair + 2.0 * hw + dec_pair
    writes = 2.0 * dec_pair
    h2, w2 = (h + 1) // 2, (w + 1) // 2  # the chroma planes and the scale-1 pairs
    ops = (quality_work(1, h, w, h2, w2)[1] + vif_tail_work(1, h2, w2)[1]
           + adm_scale0_work(1, h, w)[1] + adm_tail_work(1, h2, w2)[1])
    return {"bytes_per_frame": reads + writes, "ops_per_frame": float(ops)}


def complexity_roofline(h: int, w: int, radius: int = 8, block: int = 16) -> dict:
    """Per-frame bytes and operations of the complexity suite: the gray
    kernel reads y/u/v u8 and writes f32 gray, the 2x2 pooling reads and
    writes, the half-resolution search reads the pooled pair; the 64x64
    resize, DCT, Sobel/Canny and entropies are byte-trivial; the colour
    entropy reads sampled rows (~1/8 of the planes). Operations: the gray
    and block-match kernels, which hold all but a trivial share of them."""
    hw = float(h * w)
    gray = hw * 4
    reads = 1.5 * hw + gray + 2 * (gray / 4) + 0.125 * 1.5 * hw
    writes = gray + gray / 4
    ops = (gray_work(1, h, w, (h + 1) // 2, (w + 1) // 2)[1]
           + motion_work(1, h // 2, w // 2, block // 2, radius // 2)[1])
    return {"bytes_per_frame": reads + writes, "ops_per_frame": float(ops)}


def attach_measured(counts: dict, seconds_per_frame: float) -> dict:
    """The analytic counts with a measured per-frame time, as percentages
    of the HBM and f32 peaks."""
    t = max(seconds_per_frame, 1e-12)
    return {
        "bytes_per_frame": round(counts["bytes_per_frame"]),
        "ops_per_frame": round(counts["ops_per_frame"]),
        "seconds_per_frame": seconds_per_frame,
        "pct_hbm_roofline": round(100 * counts["bytes_per_frame"] / t / HBM_BYTES_PER_S, 2),
        "pct_f32_roofline": round(100 * counts["ops_per_frame"] / t / F32_OPS_PER_S, 2),
    }
