"""Device selection and precision settings for the port.

The port runs on the card. The CPU runs only when a caller asks for it
(``get_device("cpu")``, the CLI's ``--device cpu``), as the tests do.

Metric paths run in f32 with TF32 off: resize and DCT are f32 matmuls, and
TF32 keeps ~3 decimal digits, which would break parity with the JAX
reference (``docs/DESIGN.md`` "Precision rules").
"""

from __future__ import annotations

import torch


def get_device(requested: str | torch.device | None = None) -> torch.device:
    """``cuda`` unless ``requested`` names another device. A CUDA device
    without a card raises: nothing falls back to the CPU. Turns TF32 off for
    matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if requested is None else requested)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    return dev
