"""The device's side of a traced stretch, from ``torch.profiler``'s trace.

The stretch is the ``bench.stretch`` range of whole clips at the start of
the traced window. Device activity is every kernel, copy and memset in the
trace, clipped to the stretch; ``busy_s`` is the length of their union, so
overlapping work counts once. The gaps of that union are the device's idle
time; each is named by the innermost ``bench.*`` range the host's main
thread was in at the gap's middle. Copies that the prefetch threads issue
are sometimes missing from the trace, so ``busy_s`` can read low.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
QUALITY = "bench.quality"
TOP = 10


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _launched_inside(events: list, name: str, tid) -> set:
    """Correlation ids of the runtime calls thread ``tid`` made inside its
    ranges called ``name``."""
    ranges = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                     if e.get("ph") == "X" and e.get("name") == name and e.get("tid") == tid])
    starts = [a for a, _ in ranges]
    out = set()
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in LAUNCH_CATS or e.get("tid") != tid:
            continue
        corr = (e.get("args") or {}).get("correlation")
        i = bisect.bisect_right(starts, float(e["ts"])) - 1
        if corr is not None and i >= 0 and float(e["ts"]) <= ranges[i][1]:
            out.add(corr)
    return out


def summarize(events: list) -> dict | None:
    """busy_s, window_s and the breakdown of the stretch in ``events``
    (chrome-trace events, times in microseconds); None when the trace holds
    no stretch or no device activity."""
    stretch = [e for e in events if e.get("name") == "bench.stretch" and e.get("ph") == "X"]
    if not stretch:
        return None
    s0 = float(stretch[0]["ts"])
    s1 = s0 + float(stretch[0]["dur"])
    main_tid = stretch[0].get("tid")
    dev, per_op = [], defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), s0)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), s1)
        if b > a:
            dev.append((a, b))
            per_op[e["name"]] += (b - a) / 1e6
    if not dev:
        return None
    busy = _union(dev)
    launched = _launched_inside(events, QUALITY, main_tid)
    quality = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in events
               if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
               and (e.get("args") or {}).get("correlation") in launched]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][len("bench."):])
             for e in events
             if e.get("ph") == "X" and str(e.get("name", "")).startswith("bench.")
             and e.get("name") != "bench.stretch" and e.get("tid") == main_tid]
    gaps, prev = [], s0
    for a, b in busy + [[s1, s1]]:
        if a > prev:
            mid = (prev + a) / 2
            inside = [(e - s, name) for s, e, name in spans if s <= mid <= e]
            gaps.append((min(inside)[1] if inside else "loop", (a - prev) / 1e6))
        prev = max(prev, b)
    return {
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "window_s": (s1 - s0) / 1e6,
        "quality_s": sum(b - a for a, b in _union(quality)) / 1e6,
        "quality_launches": len(launched),
        "device_ops": [[k, v] for k, v in sorted(per_op.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[k, v] for k, v in sorted(gaps, key=lambda g: -g[1])[:TOP]],
    }


def read_profile(prof) -> dict | None:
    """``summarize`` of a finished ``torch.profiler.profile``: its trace is
    exported to a temporary file (under ``TMPDIR``), read and removed."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    return summarize(events)
