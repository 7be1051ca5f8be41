"""clip_s_p95: the 95th percentile, over all clips of the window, of one
clip's seconds from its first batch handed to staging to its pooled
results on the host (numpy's linear interpolation between order
statistics)."""

import numpy as np


def read(run):
    if not run.answers:
        return None
    return float(np.percentile([a.seconds for a in run.answers], 95))
