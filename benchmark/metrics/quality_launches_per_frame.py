"""quality_launches_per_frame: the runtime calls (kernel launches, copies,
memsets) the main thread made inside ``full_reference.chunk_kernels`` over
the profiled stretch of the traced run (``harness/profile.py``:
``quality_launches``), per clip frame: the quality step's dispatch load."""


def read(run):
    t = run.trace
    d = t and t.get("device")
    if not d or not t.get("stretch_frames") or not d.get("quality_launches"):
        return None
    return d["quality_launches"] / t["stretch_frames"]
