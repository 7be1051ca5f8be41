"""quality_ms_per_frame: device milliseconds of the quality step per clip
frame (padding frames are cost, not frames), over the profiled stretch of
the traced run: the device time of the operations launched inside
``full_reference.chunk_kernels`` (``harness/profile.py``: ``quality_s``),
without the staged copies queued on the same stream meanwhile."""


def read(run):
    t = run.trace
    d = t and t["device"]
    if not d or not t["stretch_frames"] or d["quality_s"] <= 0:
        return None
    return 1e3 * d["quality_s"] / t["stretch_frames"]
