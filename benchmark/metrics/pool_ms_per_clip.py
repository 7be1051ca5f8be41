"""pool_ms_per_clip: host milliseconds in ``pool_full_reference`` per clip
(PSNR/SSIM means, motion2, the VMAF predict), over the timed part of the
traced window."""


def read(run):
    t = run.trace
    if not t or not t["clips"]:
        return None
    return 1e3 * t["pool_s"] / t["clips"]
