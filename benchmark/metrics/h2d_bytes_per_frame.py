"""h2d_bytes_per_frame: bytes through ``io/stream.py::upload`` (staged
chunks, padded tails, the accumulator's re-uploads), per clip frame, over
the timed part of the traced window. Tables sent by ``.to()`` are not
counted."""


def read(run):
    t = run.trace
    if not t or not t["frames"]:
        return None
    return t["h2d_bytes"] / t["frames"]
