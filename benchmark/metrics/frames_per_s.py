"""frames_per_s: ref/dis pairs analysed per second, every frame of every
clip of the window over the whole window (from its opening to the end of
its last clip)."""


def read(run):
    if not run.answers or run.window_s <= 0:
        return None
    return sum(a.clip.frames for a in run.answers) / run.window_s
