"""VMAF motion blur window (counterpart of ``rtvqa_tpu/vmaf/motion.py``).

libvmaf's motion feature blurs each reference luma frame with the 5-tap
``FILTER_5`` window (separably, mirrored borders) and takes the mean
absolute difference of consecutive blurred frames; the chunk engine
(``metrics/full_reference.py``) computes those SADs and pools motion2.
"""

from __future__ import annotations

import numpy as np

FILTER_5 = np.array(
    [0.054488685, 0.244201342, 0.402619947, 0.244201342, 0.054488685],
    dtype=np.float64,
)
