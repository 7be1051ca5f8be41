"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``rtvqa_tpu_torch/csrc/``, checks each
against its plain PyTorch version at the main path's shapes (128 synthetic
1080p YUV420 frames; 127 half-resolution pyramid pairs), checks the suite
against the repository's NumPy oracles on a small input, then drives the
complexity main path (``calculate_average_scene_complexity``, the
``quality_backend: "none"`` route of the CLI) once on the kernels and once on
the plain versions, with the kernels' launch counts reset just before the
kernel run. Any failure raises, so the exit code is non-zero; without a GPU
it stops before printing any result.

Output, one line per phase, then: the ``nvidia-smi`` name/power-limit line,
one JSON line ``{"kernels": [...]}`` and, last, ``{"ok": true, "device":
{...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
N, H, W = 128, 1080, 1920
SEED = 0
BLOCK, RADIUS = 16, 8          # the suite's defaults; the pyramid halves them
GRAY_ATOL = 1e-3               # tests/test_pallas_kernels.py:96 (FMA ULPs)
MOTION_RTOL = 5e-3             # docs/PARITY.md motion row (near-tie argmins)
SUITE_RTOL = 1e-4


def make_frames(n: int, h: int, w: int, seed: int):
    """The bench's gradient + noise recipe (bench.py:59-69)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 3 + yy * 2) % 256
    y = np.stack([(base + 7 * i) % 256 for i in range(n)]).astype(np.uint8)
    y = np.clip(
        y.astype(np.int16) + rng.integers(0, 8, y.shape, dtype=np.int16), 0, 255
    ).astype(np.uint8)
    u = rng.integers(100, 156, (n, h // 2, w // 2), np.uint8)
    v = rng.integers(100, 156, (n, h // 2, w // 2), np.uint8)
    return y, u, v


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("FAIL device: torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    return name, smi


def phase_build() -> None:
    from rtvqa_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.load_library()._name
    print(f"build: {os.path.relpath(path, ROOT)} in {time.perf_counter() - t0:.2f} s")


def phase_gray(dev, y, u, v) -> dict:
    from rtvqa_tpu_torch.kernels.gray import yuv420_to_gray_cuda
    from rtvqa_tpu_torch.ops.color import yuv420_to_gray

    got = yuv420_to_gray_cuda(y, u, v)
    want = yuv420_to_gray(y, u, v)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not err <= GRAY_ATOL:
        raise AssertionError(f"gray kernel vs plain: max abs err {err} > {GRAY_ATOL}")
    ms = cuda_ms(lambda: yuv420_to_gray_cuda(y, u, v), 20)
    plain_ms = cuda_ms(lambda: yuv420_to_gray(y, u, v), 5)
    print(f"gray: {tuple(y.shape)} max_abs_err {err:.3g}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"name": "yuv420_to_gray", "route": "cuda", "source": "rtvqa_tpu_torch/csrc/gray.cu",
            "replaces": "rtvqa_tpu/kernels/gray_pallas.py:116", "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms}


def phase_motion(dev, gray) -> dict:
    from rtvqa_tpu_torch.kernels.motion import block_match_motion_cuda
    from rtvqa_tpu_torch.ops.motion import block_match_motion, down2_mean

    bp, rp = BLOCK // 2, RADIUS // 2
    gh = down2_mean(gray)
    prev, curr = gh[:-1], gh[1:]
    got = block_match_motion_cuda(prev, curr, bp, rp)
    want = block_match_motion(prev, curr, bp, rp)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = float(((got - want).abs() / want.abs().clamp_min(1e-12)).max())
    if not torch.isfinite(got).all() or not rel <= MOTION_RTOL:
        raise AssertionError(f"motion kernel vs plain: max rel err {rel} > {MOTION_RTOL}")

    # Integer-valued frames: SADs are exact in f32, so the result must be exact.
    rng = np.random.default_rng(SEED + 1)
    ip = torch.from_numpy(rng.integers(0, 256, (2, gh.shape[1], gh.shape[2])).astype(np.float32)).to(dev)
    ic = torch.roll(ip, shifts=(2, -3), dims=(1, 2)).contiguous()
    k_int, p_int = block_match_motion_cuda(ip, ic, bp, rp), block_match_motion(ip, ic, bp, rp)
    if not torch.equal(k_int, p_int):
        raise AssertionError(f"motion on integer frames not exact: {k_int} vs {p_int}")
    k_static = block_match_motion_cuda(ip, ip, bp, rp)
    if not bool((k_static == 0).all()):
        raise AssertionError(f"motion on a static scene not 0: {k_static}")

    ms = cuda_ms(lambda: block_match_motion_cuda(prev, curr, bp, rp), 10)
    plain_ms = cuda_ms(lambda: block_match_motion(prev, curr, bp, rp), 3)
    print(f"motion: {tuple(prev.shape)} pairs, block {bp} r {rp}: max_abs_err {err:.3g} "
          f"(rel {rel:.3g}); integer pair exact ({float(k_int[0]):.6f}), static 0; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"name": "block_match_motion", "route": "cuda",
            "source": "rtvqa_tpu_torch/csrc/motion.cu",
            "replaces": "rtvqa_tpu/kernels/motion_pallas.py:228", "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms}


def phase_oracle(dev) -> None:
    """Small-input agreement with the repository's NumPy oracles
    (tests/oracles/complexity.py), through the kernel path on the card."""
    spec = importlib.util.spec_from_file_location(
        "rtvqa_complexity_oracle", os.path.join(ROOT, "tests", "oracles", "complexity.py")
    )
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)

    from rtvqa_tpu_torch.kernels.motion import block_match_motion_cuda
    from rtvqa_tpu_torch.ops.dct import dct_energy, temporal_dct_abs_diff
    from rtvqa_tpu_torch.ops.edges import canny_edge_count
    from rtvqa_tpu_torch.ops.motion import down2_mean

    rng = np.random.default_rng(SEED + 2)
    tex = rng.integers(0, 256, (80, 112)).astype(np.float64)
    prev = tex[:64, :96]
    curr = np.roll(np.roll(tex, 4, 0), -2, 1)[:64, :96]
    tp, tc = (torch.from_numpy(a.astype(np.float32))[None].to(dev) for a in (prev, curr))
    got = float(2.0 * block_match_motion_cuda(down2_mean(tp), down2_mean(tc), BLOCK // 2, RADIUS // 2)[0])
    want = oracle.block_match_motion_pyramid(prev, curr, BLOCK, RADIUS)
    checks = {"motion": (got, want)}
    checks["dct"] = (float(dct_energy(tc)[0]), oracle.dct_energy(curr))
    checks["temporal_dct"] = (float(temporal_dct_abs_diff(tp, tc)[0]), oracle.temporal_dct(prev, curr))
    checks["edge"] = (float(canny_edge_count(tc)[0]), float(oracle.canny(curr).sum()))
    for key, (g, w) in checks.items():
        if not abs(g - w) <= 1e-5 * max(abs(w), 1.0):
            raise AssertionError(f"oracle {key}: port {g} vs NumPy {w}")
    print("oracle: " + ", ".join(f"{k} {g:.6g} = {w:.6g}" for k, (g, w) in checks.items()))


def phase_suite(dev, y, u, v) -> dict:
    from rtvqa_tpu.io.video import DecodedClip
    from rtvqa_tpu_torch.kernels.gray import yuv420_to_gray_cuda
    from rtvqa_tpu_torch.kernels.motion import block_match_motion_cuda
    from rtvqa_tpu_torch.metrics.complexity import (
        METRIC_ORDER,
        calculate_average_scene_complexity,
    )

    clip = DecodedClip(
        y=y, u=u, v=v, timestamps_ms=np.arange(N) * 333.3, width=W, height=H,
        n_frames_total=N, bit_rate=0, avg_fps=3.0,
    )

    def run(impl):
        return calculate_average_scene_complexity(clip, 64, 64, motion_impl=impl, device=dev)

    run(None), run("plain")  # warm-up: cuBLAS handles, allocator pools
    kernels = (yuv420_to_gray_cuda, block_match_motion_cuda)
    for k in kernels:
        k.launches = 0
    res_k, t_k = wall_s(lambda: run(None))
    launches = {k.__name__: k.launches for k in kernels}
    res_p, t_p = wall_s(lambda: run("plain"))
    for key in METRIC_ORDER:
        a, b = getattr(res_k, key), getattr(res_p, key)
        tol = MOTION_RTOL if key == "motion" else SUITE_RTOL
        if not (np.isfinite(a) and abs(a - b) <= tol * max(abs(b), 1e-12)):
            raise AssertionError(f"suite {key}: kernel path {a} vs plain {b}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"{name} was not launched on the suite's kernel run")
    print(f"suite: {N}x{H}x{W} kernel path {t_k:.4f} s, plain path {t_p:.4f} s; "
          f"launches {launches}; values {res_k}")
    return launches


def main() -> int:
    name, smi = phase_device()
    print(f"nvidia-smi: {smi}")
    import rtvqa_tpu_torch

    if not os.path.abspath(rtvqa_tpu_torch.__file__).startswith(ROOT + os.sep):
        raise SystemExit(f"FAIL: rtvqa_tpu_torch imported from outside {ROOT}")
    from rtvqa_tpu_torch.device import get_device

    dev = get_device("cuda")
    phase_build()
    y_np, u_np, v_np = make_frames(N, H, W, SEED)
    y, u, v = (torch.from_numpy(a).to(dev) for a in (y_np, u_np, v_np))
    gray_rec = phase_gray(dev, y, u, v)
    from rtvqa_tpu_torch.ops.color import yuv420_to_gray

    motion_rec = phase_motion(dev, yuv420_to_gray(y, u, v))
    del y, u, v
    phase_oracle(dev)
    launches = phase_suite(dev, y_np, u_np, v_np)
    gray_rec["launches"] = launches["yuv420_to_gray_cuda"]
    motion_rec["launches"] = launches["block_match_motion_cuda"]
    print(smi)
    print(json.dumps({"kernels": [gray_rec, motion_rec]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
