"""Build and load the port's CUDA kernels, and the checks every kernel
wrapper shares.

Every ``csrc/*.cu`` is compiled with ``nvcc`` into one shared library with a
plain C interface under ``build/rtvqa_tpu_torch/`` at the checkout root, and
loaded with ``ctypes`` on first use. The library name carries a hash of the
sources, so an edited source never loads a stale build. The build depends
only on the sources in the repository; a missing ``nvcc`` or a failed build
raises — there is no fallback to the plain PyTorch versions here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "rtvqa_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Where a toolkit is looked for when neither CUDA_HOME nor PATH names one.
_NVCC_CANDIDATES = ("/usr/local/cuda/bin/nvcc",)


class KernelBuildError(RuntimeError):
    """nvcc is missing, or compiling/loading the kernel library failed."""


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def find_nvcc() -> str | None:
    """``$CUDA_HOME/bin/nvcc``, then ``nvcc`` on PATH, then the usual
    toolkit location; None when there is none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.extend(_NVCC_CANDIDATES)
    return next((c for c in candidates if os.path.isfile(c)), None)


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"librtvqa_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel library if it is not built yet; returns its path.
    The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) is kept in ``nvcc.log`` beside it."""
    out = library_path()
    if out.is_file():
        return out
    nvcc = find_nvcc()
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
            "kernels of rtvqa_tpu_torch cannot be built"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, _sources())],
        capture_output=True, text=True,
    )
    (BUILD_DIR / "nvcc.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelBuildError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """Build (once) and load the kernel library, declaring every entry
    point's argument and return types."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rtvqa_cuda_error_string.argtypes = [i32]
        lib.rtvqa_cuda_error_string.restype = ctypes.c_char_p
        lib.rtvqa_yuv420_to_gray.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
        lib.rtvqa_yuv420_to_gray.restype = i32
        lib.rtvqa_block_match_motion.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
        lib.rtvqa_block_match_motion.restype = i32
        _lib = lib
        return lib


def check_launch(lib: ctypes.CDLL, code: int, name: str) -> None:
    """Raise if a C launcher returned a non-zero ``cudaGetLastError()``."""
    if code != 0:
        msg = lib.rtvqa_cuda_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")


def require_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and rank."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
