"""Device selection and precision settings for the port.

Metric paths run in f32 with TF32 off: resize and DCT are f32 matmuls, and
TF32 keeps ~3 decimal digits, which would break parity with the JAX
reference (``docs/DESIGN.md`` "Precision rules").
"""

from __future__ import annotations

import torch


def get_device(requested: str | torch.device | None = None) -> torch.device:
    """``cuda`` when a card is present and nothing was requested, else
    ``cpu``; an explicit ``cuda`` request without a card raises rather than
    silently running on the CPU. Turns TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if requested is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    dev = torch.device(requested)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda.is_available() is False")
    return dev
