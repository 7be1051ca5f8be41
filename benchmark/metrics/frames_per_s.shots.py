"""frames_per_s.shots: ref/dis pairs analysed per second over the timed
window of the traced run (spans on), in the cells where the host's speed
moves the rate too far between runs to bound it end to end: the shots
mix, whose time is per-clip host work on shared cores. The clips of the
profiled stretch before the window are not counted."""


def read(run):
    t = run.trace
    if not t or not t["frames"] or run.window_s <= 0:
        return None
    return t["frames"] / run.window_s
