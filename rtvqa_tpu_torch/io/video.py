"""Host IO of the port: ctypes bindings over the native libav runtime
(the port's own copy of ``rtvqa_tpu/io/video.py``).

The library is compiled from the repository's ``native/rtvqa_io.cpp`` with
``g++`` into ``build/rtvqa_tpu_torch/`` at the checkout root on first use
(the file name carries a hash of the source, so an edited source never loads
a stale build). A missing compiler, missing libav development files or a
failed build raise ``NativeIOUnavailable`` with the compiler's message.
Importing this module needs none of that; only calling an IO function does.

Frames stay planar YUV420 uint8 on the host; colour conversion runs on the
device.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
import tempfile
import threading
from fractions import Fraction
from pathlib import Path
from typing import Optional

import numpy as np

from rtvqa_tpu_torch.ops.color import rgb_to_yuv420_np

_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _ROOT / "native" / "rtvqa_io.cpp"
BUILD_DIR = _ROOT / "build" / "rtvqa_tpu_torch"
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")
LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale")


class NativeIOUnavailable(RuntimeError):
    """The native IO library could not be built or loaded."""


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() if SOURCE.is_file() else b"")
    digest.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"librtvqa_io_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the IO library if it is not built yet; returns its path."""
    out = library_path()
    if out.is_file():
        return out
    if not SOURCE.is_file():
        raise NativeIOUnavailable(f"native IO source not found at {SOURCE}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cxx = os.environ.get("CXX", "g++")
    try:
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE), *LIBS],
            capture_output=True, text=True, timeout=300,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        raise NativeIOUnavailable(f"cannot run {cxx}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise NativeIOUnavailable(
            f"building {SOURCE.name} failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = build()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise NativeIOUnavailable(f"cannot load {path}: {e}") from e
        u8p, i64p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64)
        lib.rtvqa_last_error.restype = ctypes.c_char_p
        lib.rtvqa_decode_open_threads.restype = ctypes.c_void_p
        lib.rtvqa_decode_open_threads.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        lib.rtvqa_decode_info.argtypes = [ctypes.c_void_p, i64p]
        lib.rtvqa_decode_copy.argtypes = [
            ctypes.c_void_p, u8p, u8p, u8p, ctypes.POINTER(ctypes.c_double),
        ]
        lib.rtvqa_decode_close.argtypes = [ctypes.c_void_p]
        lib.rtvqa_probe.argtypes = [ctypes.c_char_p, i64p]
        lib.rtvqa_transcode.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
        ]
        lib.rtvqa_encode_raw.argtypes = [
            ctypes.c_char_p, u8p, u8p, u8p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
        ]
        lib.rtvqa_stream_open.restype = ctypes.c_void_p
        lib.rtvqa_stream_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.rtvqa_stream_info.argtypes = [ctypes.c_void_p, i64p]
        lib.rtvqa_stream_next.argtypes = [
            ctypes.c_void_p, u8p, u8p, u8p, ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ]
        lib.rtvqa_stream_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def _err(lib) -> str:
    return lib.rtvqa_last_error().decode(errors="replace")


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


VALID_VIDEO_EXT = (".mp4", ".avi", ".mov", ".mkv", ".webm")


def validate_video_path(input_path: str) -> str:
    """Extension gate, mirroring the reference (``complexity_metrics.py:25-35``)
    with a slightly wider container whitelist."""
    if not isinstance(input_path, str):
        raise ValueError("Invalid input path. Please provide a valid file path.")
    lower = input_path.lower()
    if lower.endswith(VALID_VIDEO_EXT):
        return "video"
    if lower.endswith((".jpg", ".png")):
        return "frame"
    raise ValueError("Unsupported file type. Please provide a video or frame file.")


@dataclasses.dataclass
class DecodedClip:
    """Sampled frames of one clip as planar YUV420 batches.

    ``y``: (N, H, W) uint8; ``u``/``v``: (N, ceil(H/2), ceil(W/2)) uint8;
    ``timestamps_ms``: (N,) float64 presentation timestamps of the sampled
    frames, ``frame_interval`` source frames apart.
    """

    y: np.ndarray
    u: np.ndarray
    v: np.ndarray
    timestamps_ms: np.ndarray
    width: int
    height: int
    n_frames_total: int
    bit_rate: int
    avg_fps: float


def decode_sampled(
    path: str, frame_interval: int = 10, threads: Optional[int] = None
) -> DecodedClip:
    """Decode ``path`` once, keeping every ``frame_interval``-th frame
    (1-based). ``threads`` bounds the decoder's threads (None/0 = auto)."""
    validate_video_path(path)
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    lib = _load()
    handle = lib.rtvqa_decode_open_threads(path.encode(), int(frame_interval), int(threads or 0))
    if not handle:
        raise RuntimeError(f"decode failed: {_err(lib)}")
    try:
        info = (ctypes.c_int64 * 8)()
        lib.rtvqa_decode_info(handle, info)
        n, w, h, cw, ch, total, bitrate, fps_milli = (int(x) for x in info)
        y = np.empty((n, h, w), dtype=np.uint8)
        u = np.empty((n, ch, cw), dtype=np.uint8)
        v = np.empty((n, ch, cw), dtype=np.uint8)
        ts = np.empty((n,), dtype=np.float64)
        if n > 0:
            lib.rtvqa_decode_copy(
                handle, _u8(y), _u8(u), _u8(v),
                ts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            )
        return DecodedClip(
            y=y, u=u, v=v, timestamps_ms=ts, width=w, height=h,
            n_frames_total=total, bit_rate=bitrate, avg_fps=fps_milli / 1000.0,
        )
    finally:
        lib.rtvqa_decode_close(handle)


@dataclasses.dataclass(frozen=True)
class VideoInfo:
    bitrate_kbps: int
    resolution: str
    frame_rate: float
    width: int
    height: int


def get_video_info(path: str) -> VideoInfo:
    """Stream probe; the fps fraction is evaluated as an exact rational."""
    lib = _load()
    info = (ctypes.c_int64 * 6)()
    if lib.rtvqa_probe(path.encode(), info) < 0:
        raise RuntimeError(f"probe failed: {_err(lib)}")
    w, h, bitrate_bps, fps_num, fps_den, _ = (int(x) for x in info)
    fps = float(Fraction(fps_num, fps_den)) if fps_den > 0 and fps_num >= 0 else 0.0
    return VideoInfo(
        bitrate_kbps=bitrate_bps // 1000, resolution=f"{w}x{h}", frame_rate=fps,
        width=w, height=h,
    )


def transcode(in_path: str, out_path: str, crf: int = 23, preset: str = "medium") -> None:
    """In-process libx264 transcode."""
    lib = _load()
    rc = lib.rtvqa_transcode(in_path.encode(), out_path.encode(), int(crf), preset.encode())
    if rc < 0:
        raise RuntimeError(f"transcode failed: {_err(lib)}")


def encode_raw_yuv420(
    out_path: str,
    y: np.ndarray,
    u: np.ndarray,
    v: np.ndarray,
    fps: Fraction = Fraction(30, 1),
    crf: int = 23,
    preset: str = "medium",
) -> None:
    """Encode raw planar YUV420 frames to an H.264 mp4 (test-clip synthesis)."""
    lib = _load()
    n, h, w = y.shape
    y, u, v = (np.ascontiguousarray(a, dtype=np.uint8) for a in (y, u, v))
    rc = lib.rtvqa_encode_raw(
        out_path.encode(), _u8(y), _u8(u), _u8(v),
        n, w, h, fps.numerator, fps.denominator, int(crf), preset.encode(),
    )
    if rc < 0:
        raise RuntimeError(f"encode failed: {_err(lib)}")


def encode_raw_rgb(
    out_path: str,
    rgb: np.ndarray,
    fps: Fraction = Fraction(30, 1),
    crf: int = 23,
    preset: str = "medium",
) -> None:
    """Encode (N, H, W, 3) uint8 RGB frames via BT.601 limited-range YUV420."""
    encode_raw_yuv420(out_path, *rgb_to_yuv420_np(rgb), fps=fps, crf=crf, preset=preset)
