"""The reference's working precision.

The reference runs every float operation in ``FLOAT`` (float32, the
precision the configurations state) and its matrix products in float32 with
TF32 off. The control (``benchmark/control.py``) lowers both by one step:
``FLOAT`` becomes bfloat16 (the step below float32 for the elementwise
filters, moments and ratios) and the matrix products run in TF32 (the step
below float32 with TF32 off). Integer work (SSE, SSIM block sums, counts)
and the float64 reductions are the same in both.
"""

from __future__ import annotations

import contextlib

import torch

FLOAT = torch.float32


def f(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the working float type."""
    return x.to(FLOAT)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matrix product: float32 operands (TF32 decides how the card
    multiplies them), the result in the working float type."""
    return torch.matmul(a.float(), b.float()).to(FLOAT)


def exact() -> None:
    """float32 everywhere, TF32 off."""
    global FLOAT
    FLOAT = torch.float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def lowered():
    """The control's precision: bfloat16 floats, TF32 matrix products."""
    global FLOAT
    FLOAT = torch.bfloat16
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        exact()
