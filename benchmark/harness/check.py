"""The comparison that decides ``correct``.

After the window, a sample of the window's answers, drawn from the seed, is
recomputed by the plain reference (``benchmark/reference``) from the same
pool frames the program was handed:

* ``quality_rel``: each sampled frame's 16 quality series values;
* ``complexity_rel``: each sampled accumulator slot's 7 complexity values
  (slot g: sampled frame g against g-1);
* ``pooled_rel``: every clip's pooled PSNR/SSIM/VMAF and eight smoothed
  complexity metrics, against the reference's pooling of the program's own
  series (the series themselves are held by the two numbers above) and of
  the sampled frames' timestamps as the clip gives them;
* ``frames_mismatch``: clips whose frame count, series lengths or slot
  count differ from the clip's, or whose slot timestamps are not exactly
  the sampled frames' (frame index / fps).

A value's error is ``|program - reference|`` over the larger of
``|reference|`` and the median ``|reference|`` of its key in the sample (some
values, such as a clip's first SAD, are 0). Each number is the largest
error it covers; ``limits/<cell>.json`` gives its limit.

The sample always holds a clip's first frame (no SAD), a frame at a chunk
boundary (the blur carry), the first frame of a ragged tail (padded on the
host), the last frame of the longest clip, and slot 1 and the last slot of
the longest clip; the rest is drawn uniformly over the window.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import complexity as ref_complexity
from benchmark.reference import pool as ref_pool
from benchmark.reference import prec
from benchmark.reference import quality as ref_quality

from .traffic import rng

NUMBERS = ("quality_rel", "complexity_rel", "pooled_rel", "frames_mismatch")


def sampled_index(clip_frames: int, interval: int) -> np.ndarray:
    """Clip frames the complexity target samples: k-1, 2k-1, ... (1-based)."""
    return np.arange(interval - 1, clip_frames, interval)


def sampled_ts(clip_frames: int, interval: int, fps: float) -> np.ndarray:
    """The sampled frames' timestamps in ms, as the clip's batches carry them."""
    return sampled_index(clip_frames, interval) * (1000.0 / fps)


def plan(answers: list, seed: int, n_frames: int, n_slots: int, chunk: int, interval: int):
    """(frames, slots): sampled (answer index, clip frame) and (answer
    index, slot), sorted."""
    lengths = np.array([a.clip.frames for a in answers])
    slots_per = np.array([sampled_index(n, interval).size for n in lengths])
    longest = int(np.argmax(lengths))
    frames = {(longest, int(lengths[longest]) - 1), (0, 0)}
    for i, n in enumerate(lengths):
        if n > chunk:
            frames.add((i, chunk))
            break
    for i, n in enumerate(lengths):
        if n % chunk:
            frames.add((i, int(n - n % chunk)))
            break
    slots = {(longest, int(slots_per[longest]) - 1)} if slots_per[longest] > 1 else set()
    if slots_per[0] > 1:
        slots.add((0, 1))
    r = rng(seed, 2)

    def draw(sizes, want, out, low):
        total = int(sizes.sum())
        need = min(want, total) - len(out)
        if need <= 0:
            return
        ends = np.cumsum(sizes)
        for flat in r.choice(total, size=min(total, need * 2 + 8), replace=False):
            i = int(np.searchsorted(ends, flat, side="right"))
            j = int(flat - (ends[i] - sizes[i]))
            if j >= low:
                out.add((i, j))
            if len(out) >= min(want, total):
                return

    draw(lengths, n_frames, frames, 0)
    draw(slots_per, n_slots, slots, 1)
    return sorted(frames), sorted(slots)


def _planes(pool, side, clip, idx):
    return pool.planes(side, pool.indices(clip.offset, 0, clip.frames)[idx])


def _stack(rows, p, device):
    """Plane ``p`` of each row, concatenated on ``device``."""
    return torch.from_numpy(np.concatenate([r[p] for r in rows])).to(device)


def reference_quality(pool, answers, frames, device, block: int) -> dict:
    """The reference's 16 series values at the sampled frames."""
    out = {k: [] for k in ref_quality.KEYS}
    for b0 in range(0, len(frames), block):
        part = frames[b0:b0 + block]
        rows = {"ref": [], "dis": [], "prev": []}
        for i, f in part:
            clip = answers[i].clip
            rows["ref"].append(_planes(pool, "ref", clip, np.array([f])))
            rows["dis"].append(_planes(pool, "dis", clip, np.array([f])))
            rows["prev"].append(_planes(pool, "ref", clip, np.array([max(f - 1, 0)])))
        planes = [_stack(rows[s], p, device) for s in ("ref", "dis") for p in range(3)]
        has_prev = torch.from_numpy(np.array([f > 0 for _, f in part]))
        vals = ref_quality.quality_frames(*planes, _stack(rows["prev"], 0, device), has_prev)
        for k in ref_quality.KEYS:
            out[k].append(vals[k].double().cpu().numpy())
    return {k: np.concatenate(v) if v else np.zeros(0) for k, v in out.items()}


def reference_complexity(pool, answers, slots, device, block: int, config: dict) -> dict:
    """The reference's 7 values at the sampled slots."""
    out = {k: [] for k in ref_complexity.VALUE_KEYS}
    an = config["analysis"]
    side = "ref" if an["analyze_original"] else "dis"
    for b0 in range(0, len(slots), block):
        prev, cur = [], []
        for i, g in slots[b0:b0 + block]:
            clip = answers[i].clip
            idx = sampled_index(clip.frames, int(an["frame_interval"]))
            prev.append(_planes(pool, side, clip, idx[g - 1: g]))
            cur.append(_planes(pool, side, clip, idx[g: g + 1]))
        vals = ref_complexity.pair_values(
            *(_stack(prev, p, device) for p in range(3)), *(_stack(cur, p, device) for p in range(3)),
            int(an["resize_height"]), int(an["resize_width"]))
        for k in ref_complexity.VALUE_KEYS:
            out[k].append(vals[k].double().cpu().numpy())
    return {k: np.concatenate(v) if v else np.zeros(0) for k, v in out.items()}


def rel_errors(got: dict, want: dict) -> np.ndarray:
    """Per sampled item, the largest error over the keys (see the module
    docstring); NaN or a one-sided infinity is an infinite error."""
    worst = None
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        g = np.asarray(got[k], np.float64)
        both_inf = np.isinf(g) & np.isinf(w) & (np.sign(g) == np.sign(w))
        scale = np.maximum(np.abs(w), np.median(np.abs(w[np.isfinite(w)])) if np.isfinite(w).any() else 0.0)
        with np.errstate(invalid="ignore", divide="ignore"):
            e = np.where(both_inf, 0.0, np.abs(g - w) / np.where(scale > 0, scale, 1.0))
        e = np.where(np.isnan(e), np.inf, e)
        worst = e if worst is None else np.maximum(worst, e)
    return worst if worst is not None else np.zeros(0)


def program_at(answers, frames, slots) -> tuple[dict, dict]:
    """The program's values at the sampled frames and slots."""
    q = {k: np.array([answers[i].series[k][f] for i, f in frames], np.float64) for k in ref_quality.KEYS}
    c = {k: np.array([answers[i].slots[k][g] for i, g in slots], np.float64)
         for k in ref_complexity.VALUE_KEYS}
    return q, c


def pooled_errors(answers, alpha: float, interval: int, fps: float) -> np.ndarray:
    """Per clip, the largest relative error of the pooled values against
    the reference's float64 pooling of the program's own series and of the
    clip's sampled timestamps."""
    out = []
    for a in answers:
        want = ref_pool.pool_quality(a.series)
        want.update(ref_pool.pool_complexity(a.slots, sampled_ts(a.clip.frames, interval, fps), alpha))
        got = {**a.pooled, **a.complexity}
        errs = []
        for k, w in want.items():
            g = got[k]
            if np.isinf(w) and g == w:
                errs.append(0.0)
            else:
                e = abs(g - w) / max(abs(w), 1e-12)
                errs.append(np.inf if np.isnan(e) else e)
        out.append(max(errs))
    return np.array(out)


def mismatches(answers, interval: int, fps: float) -> np.ndarray:
    """Per clip, 1 where a count or a slot timestamp differs from the clip's."""
    bad = []
    for a in answers:
        n = a.clip.frames
        ts = sampled_ts(n, interval, fps)
        ok = a.n_frames == n and all(len(v) == n for v in a.series.values()) \
            and all(len(v) == ts.size for v in a.slots.values()) and np.array_equal(a.slot_ts, ts)
        bad.append(0 if ok else 1)
    return np.array(bad)


def judge(numbers: dict, limits: dict) -> bool:
    return all(np.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in NUMBERS)


def run_check(pool, answers, config: dict, limits: dict, seed: int, device, chunk: int) -> dict:
    """Every number, its limit, the clips that failed, and ``correct``."""
    chk = config["check"]
    interval, fps = int(config["analysis"]["frame_interval"]), float(config["fps"])
    prec.exact()
    frames, slots = plan(answers, seed, int(chk["frames"]), int(chk["slots"]), chunk, interval)
    bad_clips = set(int(i) for i in np.nonzero(mismatches(answers, interval, fps))[0])
    good = [i for i in range(len(answers)) if i not in bad_clips]
    frames = [(i, f) for i, f in frames if i in good]
    slots = [(i, g) for i, g in slots if i in good]
    with torch.no_grad():
        ref_q = reference_quality(pool, answers, frames, device, int(chk["block"]))
        ref_c = reference_complexity(pool, answers, slots, device, int(chk["block"]), config)
    got_q, got_c = program_at(answers, frames, slots)
    eq, ec = rel_errors(got_q, ref_q), rel_errors(got_c, ref_c)
    ep = pooled_errors([answers[i] for i in good], float(config["analysis"]["smoothing_alpha"]), interval, fps)
    numbers = {
        "quality_rel": float(eq.max()) if eq.size else 0.0,
        "complexity_rel": float(ec.max()) if ec.size else 0.0,
        "pooled_rel": float(ep.max()) if ep.size else 0.0,
        "frames_mismatch": float(len(bad_clips)),
    }
    for (i, _), e in zip(frames, eq):
        if not e <= limits["quality_rel"]:
            bad_clips.add(i)
    for (i, _), e in zip(slots, ec):
        if not e <= limits["complexity_rel"]:
            bad_clips.add(i)
    for i, e in zip(good, ep):
        if not e <= limits["pooled_rel"]:
            bad_clips.add(i)
    return {"numbers": numbers, "failed": len(bad_clips), "correct": judge(numbers, limits),
            "sampled_frames": len(frames), "sampled_slots": len(slots)}
