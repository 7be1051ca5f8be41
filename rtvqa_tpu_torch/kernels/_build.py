"""Build and load the port's CUDA kernels, and the checks every kernel
wrapper shares.

Every ``csrc/*.cu`` is compiled with ``nvcc`` into one shared library with a
plain C interface under ``build/rtvqa_tpu_torch/`` at the checkout root, and
loaded with ``ctypes`` on first use. The sources are compiled in parallel,
one ``nvcc -c`` each, then linked. The library name carries a hash of the
sources and headers, so an edited source never loads a stale build. The build depends
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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


def _headers() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in _sources() + _headers():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"librtvqa_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel library if it is not built yet; returns its path.
    Each source compiles in its own ``nvcc -c``, all started together, then
    one ``nvcc -shared`` links them. The compilers' output (``-Xptxas -v``:
    registers, shared memory, spills) is kept in ``nvcc.log`` beside it."""
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
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [Path(work) / f"{src.stem}.o" for src in _sources()]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(_sources(), objs)
        ]
        logs = [(p.args[-1], p.communicate()[0], p.returncode) for p in procs]
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                "-o", str(Path(work) / out.name), *map(str, objs)]
        if all(rc == 0 for _, _, rc in logs):
            proc = subprocess.run(link, capture_output=True, text=True)
            logs.append(("link", proc.stdout + proc.stderr, proc.returncode))
        (BUILD_DIR / "nvcc.log").write_text(
            "".join(f"== {name} (exit {rc})\n{text}" for name, text, rc in logs)
        )
        failed = [(name, text, rc) for name, text, rc in logs if rc != 0]
        if failed:
            name, text, rc = failed[0]
            raise KernelBuildError(f"nvcc failed on {name} ({rc}):\n{text[-4000:]}")
        os.replace(Path(work) / out.name, out)
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
        f32, i64 = ctypes.c_float, ctypes.c_longlong
        lib.rtvqa_quality_scratch.argtypes = [i32] * 5
        lib.rtvqa_quality_scratch.restype = i64
        lib.rtvqa_quality_fused.argtypes = (
            [ptr] * 7 + [i32] * 5 + [ptr] * 3 + [f32, i32] + [ptr] * 6)
        lib.rtvqa_quality_fused.restype = i32
        lib.rtvqa_quality_luma_occupancy.argtypes = [ptr]
        lib.rtvqa_quality_luma_occupancy.restype = i32
        lib.rtvqa_vif_tail_scratch_floats.argtypes = [i32] * 3
        lib.rtvqa_vif_tail_scratch_floats.restype = i64
        lib.rtvqa_vif_tail_scratch_doubles.argtypes = [i32] * 3
        lib.rtvqa_vif_tail_scratch_doubles.restype = i64
        lib.rtvqa_vif_tail.argtypes = [ptr, ptr] + [i32] * 3 + [ptr] * 3 + [f32, i32] + [ptr] * 4
        lib.rtvqa_vif_tail.restype = i32
        lib.rtvqa_vif_scale_scratch.argtypes = [i32] * 3
        lib.rtvqa_vif_scale_scratch.restype = i64
        lib.rtvqa_vif_scale.argtypes = [ptr, ptr] + [i32] * 5 + [ptr] * 2 + [f32, i32] + [ptr] * 5
        lib.rtvqa_vif_scale.restype = i32
        lib.rtvqa_vif_scale_occupancy.argtypes = [i32, i32, ptr]
        lib.rtvqa_vif_scale_occupancy.restype = i32
        lib.rtvqa_adm_scratch.argtypes = [i32] * 3
        lib.rtvqa_adm_scratch.restype = i64
        lib.rtvqa_adm_scale.argtypes = (
            [ptr, ptr] + [i32] * 4 + [ptr] + [f32] * 4 + [i32, i32, f32, i32] + [ptr] * 5)
        lib.rtvqa_adm_scale.restype = i32
        lib.rtvqa_adm_tail_scratch_floats.argtypes = [i32] * 3
        lib.rtvqa_adm_tail_scratch_floats.restype = i64
        lib.rtvqa_adm_tail_scratch_doubles.argtypes = [i32] * 3
        lib.rtvqa_adm_tail_scratch_doubles.restype = i64
        lib.rtvqa_adm_tail.argtypes = [ptr, ptr] + [i32] * 3 + [ptr] * 3 + [f32, f32, i32] + [ptr] * 4
        lib.rtvqa_adm_tail.restype = i32
        lib.rtvqa_adm_input.argtypes = [ptr, ptr] + [i32] * 7 + [ptr] * 3
        lib.rtvqa_adm_input.restype = i32
        lib.rtvqa_strip_sum.argtypes = [ptr] + [i32] * 4 + [ptr] * 2
        lib.rtvqa_strip_sum.restype = i32
        lib.rtvqa_strip_floor.argtypes = [ptr] + [i32] * 4 + [ptr] * 3
        lib.rtvqa_strip_floor.restype = i32
        _lib = lib
        return lib


def check_launch(lib: ctypes.CDLL, code: int, name: str) -> None:
    """Raise if a C launcher returned a non-zero ``cudaGetLastError()``."""
    if code != 0:
        msg = lib.rtvqa_cuda_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")


def require_cuda(name: str, t: torch.Tensor, dtype, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (or one
    of a tuple of dtypes) and rank."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
