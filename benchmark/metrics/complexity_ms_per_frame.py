"""complexity_ms_per_frame: host milliseconds, each span between two
synchronizes, in the calls into the streaming complexity layer (the tap's
``ComplexityAccumulator.add``/``finalize``; the merged step's
``_chunk_values_body``/``add_packed``/``finalize``), per clip frame, over
the timed part of the traced window."""


def read(run):
    t = run.trace
    if not t or not t["frames"]:
        return None
    return 1e3 * t["complexity_s"] / t["frames"]
