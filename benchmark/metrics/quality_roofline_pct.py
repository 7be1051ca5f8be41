"""quality_roofline_pct: the quality step's least time per frame at the
cell's frame size (``benchmark/harness/roofline.py``: bytes at 3.35 TB/s or
f32 operations at 67 TFLOP/s, whichever is larger) over its device time per
frame in the profiled stretch (``quality_ms_per_frame``), in percent."""

from benchmark.harness import roofline


def read(run):
    t = run.trace
    d = t and t["device"]
    if not d or not t["stretch_frames"] or d["quality_s"] <= 0:
        return None
    least = roofline.bound_seconds(roofline.quality_roofline(run.height, run.width))
    return 100.0 * least / (d["quality_s"] / t["stretch_frames"])
