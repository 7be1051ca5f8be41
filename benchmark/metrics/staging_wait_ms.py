"""staging_wait_ms: host milliseconds the chunk loop waits in ``next()`` on
the two staged iterators (``io/stream.py``: ``prefetch`` over
``stage_to_device``), per chunk, over the timed part of the traced
window."""


def read(run):
    t = run.trace
    if not t or not t["chunks"]:
        return None
    return 1e3 * t["staging_wait_s"] / t["chunks"]
