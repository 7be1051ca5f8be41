"""device_idle_pct: the share of the traced stretch in which no kernel,
copy or memset ran on the device (the union of their intervals in the
``torch.profiler`` trace). Copies issued on the prefetch threads can be
missing from the trace, which reads high."""


def read(run):
    d = run.trace and run.trace["device"]
    if not d or d["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
