"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``rtvqa_tpu_torch/csrc/`` and drives
the two paths of the ``rtvqa-torch`` CLI that are ported, on synthetic
1080p YUV420 frames (the card's machine has no libav, so the CLI itself
cannot decode there):

* complexity (``quality_backend: "none"``): the gray and block-match
  kernels against their plain versions at the main path's shapes (128
  frames; 127 half-resolution pyramid pairs; the gray kernel bit for bit,
  also at 32x2160x3840 and on the general path at 128x480x854, each timed
  beside ``y.to(torch.float32)`` as a yardstick), the block-match kernel's
  index fields on non-integer frames against ``MOTION_INDEX_DIGEST``
  (``tests/test_torch_cuda.py``), the suite against the
  repository's NumPy oracles on a small input, then
  ``calculate_average_scene_complexity`` once on the kernels and once on
  the plain versions;
* quality (``quality_backend: "native"``): the four quality kernels
  against their plain versions at one 64-frame chunk (ref and a noisy
  dis), the fused quality kernel also on 64 frames with flat regions
  (flat quadrants; letterbox bars), the kernel chunk body against the
  NumPy oracles of PSNR, SSIM and
  ADM on a small input, VIF scales 0-3 from kernels 3 + 5 (the chunk
  body) and from kernel 4 (four chained scales) on two 540x960 pairs, and
  kernel 1 on the suite's 128 1080p frames, against the port's float64
  NumPy references (``vmaf/vif.py::vif_features_np``,
  ``ops/color.py::yuv420_to_gray_np``), then the streaming chunk loop
  (``metrics.full_reference._quality_chunk_loop`` + ``pool_full_reference``,
  what ``analyze_full_reference`` runs after decoding) over 128 frames in
  two chunks, once on the kernels and once on the plain versions;
* the default config's route (``quality_backend: "native"``,
  ``streaming_complexity`` null): the combined loop
  (``metrics.full_reference.combined_chunk_loop``, what ``analyze_combined``
  runs after opening the streams) over the same 128 pairs at
  ``frame_interval`` 10 and 1, tapping the sampled dis frames into the
  streaming complexity accumulator (``complexity_chunk`` 128), on the
  kernels and on the plain versions; its quality series against the loop
  without the tap, its complexity against
  ``calculate_average_scene_complexity`` on the same sampled frames; then
  at ``frame_interval`` 1 the merged step (``chunk_combined``, the card's
  default there), whose complexity values come from the staged quality
  planes: its series bit for bit the loop's without complexity, its
  complexity against the tap's and the suite's, kernels 1 and 2 launched
  once per quality chunk, and the walls, device time, busy share, bytes
  uploaded (counted at ``io/stream.py::upload``; the merged step's must
  equal the staged pairs': no re-upload) and peak memory of the tap and
  of the merged step;
* DCI 4K (4096x2160, frames wider than 3840): kernel 4 (VIF at one
  scale; the VMAF API's VIF route) against its plain version at
  each scale of a 14-frame chunk, also on flat quadrants and on
  letterboxed 2.39:1 scope content, the four-scale chain against the fused
  quality kernel's and the VIF tail's values on 1080p frames, then the
  chunk loop over 28 pairs in two chunks on the kernels (the fused route,
  kernels 3, 5, 6 and 7) and on the plain versions;
* the measurement path (``trace`` and ``probes``): the quality loop once
  under ``obs/profiler.py::device_trace``, whose exported trace must name
  every ``__global__`` kernel of the route; kernels 6a (ADM scale 0's input
  path, beside kernel 6 on the 64-frame 1080p chunk), 8 (per-frame strip
  sums, u8 and f32, 16x1080x1920) and 9 (the strip-read floor,
  f32/bf16/u8, 128x1088x2176) against their plain versions, then the three
  entry points
  ``python -m rtvqa_tpu_torch.probes.{adm_stages,int8_dma,dma_floor}`` at
  their default shapes;
* the JAX package's Python API (``api``): the standalone scorer
  (``calculate_scene_complexity_score``) on the suite's 128 frames, equal
  to the suite phase's score, kernels 1 and 2 launched, within the
  values' tolerances of the plain path; the pairwise
  ``block_match_motion_pyramid`` on 32 gray pairs (kernel 2), equal to the
  series form and within MOTION_RTOL of the plain search;
  ``compute_quality`` on the 128 pairs, its PSNR equal to the quality
  loop's and its SSIM within API_SSIM_ATOL; ``extract_features`` and
  ``compute_vmaf`` on 32 pairs through kernels 4, 6 and 7 against the
  plain route on the card (walls, peak memory, peak bytes per pixel, and
  a second chunk size giving equal features); ``orb_features`` on 8
  frames with corners, the card against the CPU;
* the multi-device paths (``sharded``, ``rtvqa_tpu_torch/parallel/``):
  in this process a world of one on NCCL, where the sharded quality loop
  (``pipeline/quality_sharded.py::sharded_quality_loop``, rank 0 scattering
  each chunk, ``parallel/sharding.py::sharded_quality_chunk_step`` per
  rank) over the quality cell's 128 pairs at chunk 64 must equal the
  single-device kernel loop bit for bit (kernels 3, 5, 6 and 7), and the
  sharded suite on a 1 x 1 mesh over 2 clips of 64 of the suite's frames
  must agree with ``calculate_average_scene_complexity`` per clip within
  the suite's tolerances (kernels 1 and 2); then a spawned world of two on
  gloo, both ranks on this card: the quality loop on a 1 x 2 mesh against
  world 1 (shard-boundary SADs rel 1e-4, every other value rtol 2e-4 /
  atol 2e-4, the JAX sharded tests' budget) and the suite on 2 x 1 and
  1 x 2 meshes against world 1, each rank checking its kernels launched.
  The world-2 run checks the halo and lockstep logic; its walls are no
  speed figure.

The kernels' launch counts are set to 0 just before each path's kernel run
and read just after it; every kernel of the path must have launched. Any
failure raises, so the exit code is non-zero; without a GPU it stops before
printing any result.

Output, one line per phase, then: the ``nvidia-smi`` name/power-limit line,
one JSON line ``{"kernels": [...]}`` and, last, ``{"ok": true, "device":
{...}}``. ``bound_ms`` is the larger of the bytes a kernel's function must
move over 3.35 TB/s and its operations over 67 TFLOP/s (the H100 SXM's f32
rate outside the tensor cores; integer operations are counted at that rate
too), computed from this run's shapes by ``rtvqa_tpu_torch/obs/roofline.py``.
``library_ms`` is ``torch.sum(x, (1, 2), dtype=torch.float32)`` for kernel
8; no single PyTorch call computes any other kernel's function (kernel 9's
is the read of its windows into shared memory, whose bound counts the rows
they cover once), so it is null there. Imports nothing of JAX.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
N, H, W = 128, 1080, 1920
WIDE_N, WIDE_H, WIDE_W = 28, 2160, 4096   # DCI 4K: two chunks of auto_chunk = 14
FPS = 30.0
SEED = 0
BLOCK, RADIUS = 16, 8          # the suite's defaults; the pyramid halves them
GRAY_ATOL = 0.0                # kernel 1 rounds every operation as its plain version does
GRAY_SHAPES = ((32, 2160, 3840), (128, 480, 854))   # UHD (vector path), 480p (general path)
MOTION_RTOL = 5e-3             # docs/PARITY.md motion row (near-tie argmins)
SUITE_RTOL = 1e-4
NOISE = 4                      # dis = ref + uniform integers in [-NOISE, NOISE]
# Quality tolerances: those of the JAX package's kernel tests
# (tests/test_quality_pallas.py, test_vif_pallas.py, test_adm_pallas.py).
SSE_RTOL = 1e-6
SSIM_ATOL = 2e-6
VIF0_RTOL = 2e-4
SAD_RTOL = SAD_ATOL = 1e-5
BLUR_ATOL = 1e-4
PLANE_RTOL, PLANE_ATOL = 1e-4, 1e-3   # dec_* and a_* planes
VIF_TAIL_RTOL = 3e-4
ADM_RTOL = 2e-4
ADM2_RTOL = 3e-4
VMAF_RTOL = 3e-4               # pooled VMAF: the widest of its features' tolerances
STRIP_SUM_RTOL = 1e-6         # scripts/probe_int8_dma.py's own check
# Kernels 3, 5, 6 and 7 on content with flat regions: quadrant levels,
# letterbox bars of a 2.39:1 picture in 1080 rows; the tile of kernel 3's
# luma kernel and of kernel 5 (8 x 240 in both) and their flat-window test
# (kFlatTol), from csrc/quality.cu, csrc/vif.cu and csrc/common.cuh.
FLAT_LEVELS = (255, 128, 16, 235)
BAR_ROWS = 138
DCI_BAR_ROWS = 222             # (2160 - 1716) / 2: 2.39:1 scope content in a DCI-4K frame
VIF_TILE = (8, 240)
FLAT_TOL = 1e-4
# The quality route's __global__ kernels, which the trace must name.
ROUTE_KERNELS = ("quality_luma_kernel", "ssim_sse_kernel", "vif_tail_kernel", "adm_scale_kernel",
                 "reduce_rows_kernel", "reduce_segments_kernel")
# Against the NumPy oracles: tests/test_quality.py (MSE, SSIM), test_vmaf.py (ADM).
ORACLE_MSE_RTOL, ORACLE_SSIM_ATOL, ORACLE_ADM_RTOL = 1e-5, 1e-4, 5e-4
# Against the port's float64 references (vmaf/vif.py::vif_features_np,
# ops/color.py::yuv420_to_gray_np): VIF pairs at 540x960 (the reference
# takes seconds per pair on the host, ~10x that at 1080p), the VIF
# reference tolerance of ROADMAP.md queue C; gray within 1e-4 of 0-255,
# about 6 f32 ULPs at 255 (kernel 1 rounds as its plain f32 version, which
# is ~3 ULPs off the float64 value at most).
F64_VIF_N, F64_VIF_H, F64_VIF_W = 2, 540, 960
F64_VIF_RTOL = 3e-4
F64_GRAY_ATOL = 1e-4
VIF_KEYS = tuple(f"vif_scale{k}" for k in range(4))
# The API phase: pairs of the pairwise pyramid and of extract_features, and
# ORB frames and keypoints; compute_quality's SSIM against the quality
# loop's; the kernel route of extract_features against its plain route
# (VIF/ADM as kernels 4-7 are held, motion from the same f64 sums, the
# builtin model's score); ORB on the card against the CPU as
# tests/test_torch_api_ops.py holds it against JAX (ANGLE_ATOL, DESC_BITS).
API_PAIRS, ORB_FRAMES, ORB_K = 32, 8, 500
API_SSIM_ATOL = 1e-6
# The sharded phase: the suite's N frames as 2 clips; the world-2 spawn's limit.
SHARDED_CLIPS, SHARDED_TIMEOUT_S = 2, 300.0
API_VQ_RTOL, API_MOTION_RTOL, API_VMAF_ATOL = 3e-4, 1e-6, 1e-3
ORB_ANGLE_ATOL, ORB_DESC_BITS = 1e-5, 0


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


def wall_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def peak_gib(fn) -> float:
    """Peak device memory (GiB) allocated while ``fn()`` runs."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**30


def counted_uploads(fn) -> tuple[int, int]:
    """Run ``fn`` with ``io/stream.py::upload`` wrapped in every module of
    the port that binds it, counting what it moves host to device: returns
    (bytes, calls). The prefetch threads upload, so the count takes a lock."""
    import threading

    from rtvqa_tpu_torch.io import stream
    from rtvqa_tpu_torch.metrics import complexity_streaming, full_reference

    real, lock, seen = stream.upload, threading.Lock(), [0, 0]

    def counting(a, device):
        with lock:
            seen[0] += a.nbytes
            seen[1] += 1
        return real(a, device)

    mods = (stream, full_reference, complexity_streaming)
    for m in mods:
        m.upload = counting
    try:
        fn()
    finally:
        for m in mods:
            m.upload = real
    return seen[0], seen[1]


def profile_device(label: str, fn, top: int = 8, h2d: bool = False) -> dict | None:
    """One run of ``fn`` under ``torch.profiler``: device self time by kernel
    name (the ``top`` largest) and the device's busy share of the run's
    wall time; with ``h2d``, also the host-to-device copies it recorded.
    Prints "not measured" and returns None if the profiler records no
    device time; else returns the figures printed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        print(f"profile {label}: device time not measured (the profiler recorded none)")
        return None
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    out = {"device_ms": busy, "wall_ms": wall_ms, "busy": busy / wall_ms}
    extra = ""
    if h2d:
        out["h2d_ms"] = sum(ms for name, ms, _ in rows if "HtoD" in name)
        out["h2d_copies"] = sum(count for name, _, count in rows if "HtoD" in name)
        extra = f"; {out['h2d_copies']} H2D copies recorded, {out['h2d_ms']:.3f} ms"
    print(f"profile {label}: device self time {busy:.3f} ms of {wall_ms:.3f} ms wall "
          f"(busy {busy / wall_ms:.1%}, under the profiler){extra}")
    for name, ms, count in rows[:top]:
        print(f"  {ms:10.3f} ms  x{count:<5d} {name[:100]}")
    return out


def record(name, source, replaces, err, ms, plain_ms, work, library_ms=None) -> dict:
    """One entry of the ``{"kernels": [...]}`` line; ``work`` = (bytes, ops)."""
    from rtvqa_tpu_torch.obs.roofline import kernel_bound

    bound_ms, bound_by = kernel_bound(*work)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def max_rel(got, want) -> float:
    g, w = got.double(), want.double()
    return float(((g - w).abs() / w.abs().clamp_min(1e-30)).max())


def max_abs(got, want) -> float:
    return float((got.double() - want.double()).abs().max())


def check_close(label, got, want, rtol=0.0, atol=0.0) -> None:
    """|got - want| <= atol + rtol * |want| everywhere, and got finite."""
    g, w = got.double(), want.double()
    bad = ~torch.isfinite(g) | ((g - w).abs() > atol + rtol * w.abs())
    if bool(bad.any()):
        raise AssertionError(f"{label}: kernel vs plain beyond rtol {rtol} / atol {atol}: "
                             f"max abs {max_abs(got, want):.3g}, max rel {max_rel(got, want):.3g}")


def distort(planes, seed: int):
    """dis = ref + uniform integer noise in [-NOISE, NOISE], clipped, per plane."""
    rng = np.random.default_rng(seed)
    return tuple(
        np.clip(a.astype(np.int16) + rng.integers(-NOISE, NOISE + 1, a.shape, dtype=np.int16),
                0, 255).astype(np.uint8)
        for a in planes
    )


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
    from rtvqa_tpu_torch.kernels.gray import gray_occupancy, gray_path, yuv420_to_gray_cuda
    from rtvqa_tpu_torch.obs.roofline import gray_work
    from rtvqa_tpu_torch.ops.color import yuv420_to_gray
    from rtvqa_tpu_torch.probes import device_ms, time_ms
    from rtvqa_tpu_torch.probes.gray_shapes import describe, measure, planes, yardstick

    def path(y, u, v):
        return gray_path(y.shape[-1], y.data_ptr(), u.data_ptr(), v.data_ptr())

    got = yuv420_to_gray_cuda(y, u, v)
    want = yuv420_to_gray(y, u, v)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not err <= GRAY_ATOL:
        raise AssertionError(f"gray kernel vs plain: max abs err {err} > {GRAY_ATOL}")
    ms = time_ms(lambda _: yuv420_to_gray_cuda(y, u, v), [None], 20, dev)
    dev_ms = device_ms(lambda _: yuv420_to_gray_cuda(y, u, v), [None], 20, dev)
    plain_ms = time_ms(lambda _: yuv420_to_gray(y, u, v), [None], 5, dev)
    rec = record("yuv420_to_gray", "rtvqa_tpu_torch/csrc/gray.cu",
                 "rtvqa_tpu/kernels/gray_pallas.py:116", err, ms, plain_ms,
                 gray_work(*y.shape, *u.shape[-2:]))
    print(f"gray: {tuple(y.shape)} ({path(y, u, v)} path) max_abs_err {err:.3g}; "
          f"{kernel_time(rec, dev_ms)}, plain {plain_ms:.4f} ms; "
          f"{json.dumps(gray_occupancy(dev))}")
    print(f"gray: {yardstick(y, 20, dev)}")
    for b, h, w in GRAY_SHAPES:
        yuv = planes(b, h, w, dev)
        m = measure(*yuv, 20, dev)
        if not m["equal"]:
            raise AssertionError(f"gray kernel vs plain at {b}x{h}x{w}: not equal")
        print(f"gray: ({path(*yuv)} path) {describe(m)}")
        del yuv
    return rec


def phase_motion(dev, gray) -> dict:
    from rtvqa_tpu_torch.kernels.motion import _launch, block_match_motion_cuda
    from rtvqa_tpu_torch.obs.roofline import motion_work
    from rtvqa_tpu_torch.ops.motion import block_match_motion, down2_mean
    from rtvqa_tpu_torch.probes import device_ms, time_ms

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
    # The index fields on non-integer frames: the digest the card tests hold.
    tests = load_tests_module("test_torch_cuda")
    digest = tests.motion_index_digest(lambda *a: _launch(*a)[0], dev)
    if digest != tests.MOTION_INDEX_DIGEST:
        raise AssertionError(f"motion index fields: digest {digest}, not {tests.MOTION_INDEX_DIGEST}")

    ms = time_ms(lambda _: block_match_motion_cuda(prev, curr, bp, rp), [None], 10, dev)
    dev_ms = device_ms(lambda _: block_match_motion_cuda(prev, curr, bp, rp), [None], 10, dev)
    plain_ms = time_ms(lambda _: block_match_motion(prev, curr, bp, rp), [None], 3, dev)
    rec = record("block_match_motion", "rtvqa_tpu_torch/csrc/motion.cu",
                 "rtvqa_tpu/kernels/motion_pallas.py:228", err, ms, plain_ms,
                 motion_work(*prev.shape, bp, rp))
    print(f"motion: {tuple(prev.shape)} pairs, block {bp} r {rp}: max_abs_err {err:.3g} "
          f"(rel {rel:.3g}); integer pair exact ({float(k_int[0]):.6f}), static 0; index fields "
          f"equal MOTION_INDEX_DIGEST; {kernel_time(rec, dev_ms)}, plain {plain_ms:.4f} ms")
    return rec


def load_tests_module(*parts: str):
    """tests/<parts>.py, loaded by path without importing the tests package."""
    spec = importlib.util.spec_from_file_location(
        "rtvqa_" + "_".join(parts), os.path.join(ROOT, "tests", *parts[:-1], f"{parts[-1]}.py")
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_oracle(name: str):
    """tests/oracles/<name>.py."""
    return load_tests_module("oracles", name)


def phase_oracle(dev) -> None:
    """Small-input agreement with the repository's NumPy oracles
    (tests/oracles/complexity.py), through the kernel path on the card."""
    oracle = load_oracle("complexity")

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


def suite_clip(y, u, v):
    """The suite's N sampled frames as a ``DecodedClip``, 333.3 ms apart."""
    from rtvqa_tpu_torch.io.video import DecodedClip

    return DecodedClip(
        y=y, u=u, v=v, timestamps_ms=np.arange(y.shape[0]) * 333.3, width=y.shape[2],
        height=y.shape[1], n_frames_total=y.shape[0], bit_rate=0, avg_fps=3.0,
    )


def phase_suite(dev, y, u, v):
    """The suite on the kernels and on the plain versions; returns (the
    kernel run's launches, its result)."""
    from rtvqa_tpu_torch.kernels.gray import yuv420_to_gray_cuda
    from rtvqa_tpu_torch.kernels.motion import block_match_motion_cuda
    from rtvqa_tpu_torch.metrics.complexity import (
        METRIC_ORDER,
        calculate_average_scene_complexity,
    )

    clip = suite_clip(y, u, v)

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
    profile_device("suite, kernel path", lambda: run(None))
    return launches, res_k


def check_quality_fused(label, got, want, h, w, hc, wc) -> dict:
    """Kernel 3's outputs on (h, w) luma and (hc, wc) chroma against its
    plain version's with the tolerances above; returns the max abs error of
    each output (SSE and SAD as means per pixel, SSIM as the mean over
    windows)."""
    n_win = {"y": (h // 4 - 1) * (w // 4 - 1), "u": (hc // 4 - 1) * (wc // 4 - 1)}
    n_win["v"] = n_win["u"]
    errs = {}
    for p, n_pix in (("y", h * w), ("u", hc * wc), ("v", hc * wc)):
        check_close(f"{label} sse_{p}", got[f"sse_{p}"], want[f"sse_{p}"], rtol=SSE_RTOL)
        errs[f"mse_{p}"] = max_abs(got[f"sse_{p}"] / n_pix, want[f"sse_{p}"] / n_pix)
        gs, ws = got[f"ssim_{p}_sum"] / n_win[p], want[f"ssim_{p}_sum"] / n_win[p]
        check_close(f"{label} ssim_{p} mean", gs, ws, atol=SSIM_ATOL)
        errs[f"ssim_{p}"] = max_abs(gs, ws)
    check_close(f"{label} vif_scale0", got["vif_scale0"], want["vif_scale0"], rtol=VIF0_RTOL)
    check_close(f"{label} sad_sum", got["sad_sum"], want["sad_sum"], rtol=SAD_RTOL, atol=SAD_ATOL)
    check_close(f"{label} blur_carry", got["blur_carry"], want["blur_carry"], atol=BLUR_ATOL)
    for key in ("dec_ref", "dec_dis"):
        check_close(f"{label} {key}", got[key], want[key], rtol=PLANE_RTOL, atol=PLANE_ATOL)
    errs["sad_mean"] = max_abs(got["sad_sum"] / (h * w), want["sad_sum"] / (h * w))
    for key in ("vif_scale0", "blur_carry", "dec_ref", "dec_dis"):
        errs[key] = max_abs(got[key], want[key])
    return errs


def phase_quality_kernels(dev, ref_np, dis_np) -> list[dict]:
    """The four quality kernels against their plain versions on one chunk."""
    from rtvqa_tpu_torch.kernels.adm import (
        adm_scale_cuda,
        adm_scale_plain,
        adm_tail_cuda,
        adm_tail_plain,
    )
    from rtvqa_tpu_torch.kernels.quality import (
        quality_fused_cuda,
        quality_fused_plain,
        quality_luma_occupancy,
    )
    from rtvqa_tpu_torch.kernels.vif import vif_tail_cuda, vif_tail_plain
    from rtvqa_tpu_torch.obs.roofline import (
        adm_scale0_work,
        adm_tail_work,
        quality_work,
        vif_tail_work,
    )
    from rtvqa_tpu_torch.probes import device_ms, fmt_ms, time_ms
    from rtvqa_tpu_torch.vmaf.filters import filter1d_sep
    from rtvqa_tpu_torch.vmaf.motion import FILTER_5

    ry, ru, rv = (torch.from_numpy(a).to(dev) for a in ref_np)
    dy, du, dv = (torch.from_numpy(a).to(dev) for a in dis_np)
    b, h, w = ry.shape
    hc, wc = ru.shape[-2:]
    # A carry as the loop would hand it over: the blur of a ref frame.
    prev_blur = filter1d_sep(ry[-1:].float(), FILTER_5)[0].contiguous()
    args = (ry, ru, rv, dy, du, dv, prev_blur)
    records = []

    # Kernel 3: the per-frame pass.
    got, want = quality_fused_cuda(*args), quality_fused_plain(*args)
    torch.cuda.synchronize()
    errs = check_quality_fused("quality_fused", got, want, h, w, hc, wc)
    again = quality_fused_cuda(*args)
    torch.cuda.synchronize()
    for key, v in got.items():
        if not torch.equal(v, again[key]):
            raise AssertionError(f"quality_fused {key}: a repeat call gave other bits")
    del again
    ms = time_ms(lambda _: quality_fused_cuda(*args), [None], 10, dev)
    dev_ms = device_ms(lambda _: quality_fused_cuda(*args), [None], 10, dev)
    plain_ms = time_ms(lambda _: quality_fused_plain(*args), [None], 2, dev)
    mem = (peak_gib(lambda: quality_fused_cuda(*args)), peak_gib(lambda: quality_fused_plain(*args)))
    rec = record("quality_fused", "rtvqa_tpu_torch/csrc/quality.cu",
                 "rtvqa_tpu/kernels/quality_pallas.py:635", max(errs.values()), ms,
                 plain_ms, quality_work(b, h, w, hc, wc))
    print(f"quality_fused: {tuple(ry.shape)} max abs errs {json.dumps(errs)} "
          f"(vif_scale0 rel {max_rel(got['vif_scale0'], want['vif_scale0']):.3g}); repeat bit-equal; "
          f"kernel {ms:.4f} ms (device {fmt_ms(dev_ms)}; {rec['bound_ms'] / ms:.1%} of the bound "
          f"{rec['bound_ms']:.4f}), plain {plain_ms:.4f} ms; peak {mem[0]:.2f} vs {mem[1]:.2f} GiB; "
          f"luma kernel {json.dumps(quality_luma_occupancy(dev))}")
    profile_device("quality_fused, one call", lambda: quality_fused_cuda(*args))
    records.append(rec)

    # Kernel 5: VIF scales 1-3 on the kernel's scale-1 pair.
    dec = (got["dec_ref"], got["dec_dis"])
    vk, vp = vif_tail_cuda(*dec), vif_tail_plain(*dec)
    torch.cuda.synchronize()
    for key in vp:
        check_close(key, vk[key], vp[key], rtol=VIF_TAIL_RTOL)
    rels = {key: max_rel(vk[key], vp[key]) for key in vp}
    err = max(max_abs(vk[key], vp[key]) for key in vp)
    check_repeat("vif_tail", tuple(vk.values()), tuple(vif_tail_cuda(*dec).values()))
    ms = time_ms(lambda _: vif_tail_cuda(*dec), [None], 10, dev)
    dev_ms = device_ms(lambda _: vif_tail_cuda(*dec), [None], 10, dev)
    plain_ms = time_ms(lambda _: vif_tail_plain(*dec), [None], 2, dev)
    mem = (peak_gib(lambda: vif_tail_cuda(*dec)), peak_gib(lambda: vif_tail_plain(*dec)))
    rec = record("vif_tail", "rtvqa_tpu_torch/csrc/vif.cu", "rtvqa_tpu/kernels/vif_pallas.py:874", err, ms,
                 plain_ms, vif_tail_work(*dec[0].shape))
    print(f"vif_tail: {tuple(dec[0].shape)} max abs err {err:.3g}, rel {json.dumps(rels)}; repeat "
          f"bit-equal; {kernel_time(rec, dev_ms)}, plain {plain_ms:.4f} ms; peak {mem[0]:.2f} vs "
          f"{mem[1]:.2f} GiB")
    profile_device("vif_tail, one call", lambda: vif_tail_cuda(*dec))
    records.append(rec)
    del dec, vk, vp, got, want

    # Kernel 6: ADM scale 0 on the u8 luma pair.
    num, den, a_ref, a_dis = adm_scale_cuda(ry, dy, 0)
    pn, pd, pa_ref, pa_dis = adm_scale_plain(ry, dy, 0)
    torch.cuda.synchronize()
    check_close("adm scale 0 num", num, pn, rtol=ADM_RTOL)
    check_close("adm scale 0 den", den, pd, rtol=ADM_RTOL)
    check_close("a_ref", a_ref, pa_ref, rtol=PLANE_RTOL, atol=PLANE_ATOL)
    check_close("a_dis", a_dis, pa_dis, rtol=PLANE_RTOL, atol=PLANE_ATOL)
    err = max(max_abs(x, y) for x, y in ((num, pn), (den, pd), (a_ref, pa_ref), (a_dis, pa_dis)))
    check_repeat("adm_scale0", (num, den, a_ref, a_dis), adm_scale_cuda(ry, dy, 0))
    ms = time_ms(lambda _: adm_scale_cuda(ry, dy, 0), [None], 10, dev)
    dev_ms = device_ms(lambda _: adm_scale_cuda(ry, dy, 0), [None], 10, dev)
    plain_ms = time_ms(lambda _: adm_scale_plain(ry, dy, 0), [None], 2, dev)
    mem = (peak_gib(lambda: adm_scale_cuda(ry, dy, 0)), peak_gib(lambda: adm_scale_plain(ry, dy, 0)))
    rec = record("adm_scale0", "rtvqa_tpu_torch/csrc/adm.cu", "rtvqa_tpu/kernels/adm_pallas.py:499", err,
                 ms, plain_ms, adm_scale0_work(b, h, w))
    print(f"adm_scale0: {tuple(ry.shape)} max abs err {err:.3g} (num rel {max_rel(num, pn):.3g}, "
          f"den rel {max_rel(den, pd):.3g}); repeat bit-equal; {kernel_time(rec, dev_ms)}, plain "
          f"{plain_ms:.4f} ms; peak {mem[0]:.2f} vs {mem[1]:.2f} GiB")
    profile_device("adm_scale0, one call", lambda: adm_scale_cuda(ry, dy, 0))
    records.append(rec)
    del pa_ref, pa_dis

    # Kernel 7: ADM scales 1-3 on the kernel's approximation bands.
    tk, tp = adm_tail_cuda(a_ref, a_dis), adm_tail_plain(a_ref, a_dis)
    torch.cuda.synchronize()
    check_close("adm tail num", tk["num"], tp["num"], rtol=ADM_RTOL)
    check_close("adm tail den", tk["den"], tp["den"], rtol=ADM_RTOL)
    adm2_k = (num + tk["num"]) / (den + tk["den"])
    adm2_p = (pn + tp["num"]) / (pd + tp["den"])
    check_close("adm2", adm2_k, adm2_p, rtol=ADM2_RTOL)
    err = max(max_abs(tk[k], tp[k]) for k in ("num", "den"))
    check_repeat("adm_tail", tuple(tk.values()), tuple(adm_tail_cuda(a_ref, a_dis).values()))
    ms = time_ms(lambda _: adm_tail_cuda(a_ref, a_dis), [None], 10, dev)
    dev_ms = device_ms(lambda _: adm_tail_cuda(a_ref, a_dis), [None], 10, dev)
    plain_ms = time_ms(lambda _: adm_tail_plain(a_ref, a_dis), [None], 2, dev)
    mem = (peak_gib(lambda: adm_tail_cuda(a_ref, a_dis)), peak_gib(lambda: adm_tail_plain(a_ref, a_dis)))
    rec = record("adm_tail", "rtvqa_tpu_torch/csrc/adm.cu", "rtvqa_tpu/kernels/adm_pallas.py:886", err, ms,
                 plain_ms, adm_tail_work(*a_ref.shape))
    print(f"adm_tail: {tuple(a_ref.shape)} max abs err {err:.3g} (adm2 rel {max_rel(adm2_k, adm2_p):.3g}); "
          f"repeat bit-equal; {kernel_time(rec, dev_ms)}, plain {plain_ms:.4f} ms; peak {mem[0]:.2f} vs "
          f"{mem[1]:.2f} GiB")
    profile_device("adm_tail, one call", lambda: adm_tail_cuda(a_ref, a_dis))
    records.append(rec)
    return records


def check_repeat(label, got, again) -> None:
    """A repeat call's outputs equal the first call's bit for bit."""
    torch.cuda.synchronize()
    for i, (g, a) in enumerate(zip(got, again)):
        if not torch.equal(g, a):
            raise AssertionError(f"{label} output {i}: a repeat call gave other bits")


def kernel_time(rec: dict, dev_ms) -> str:
    """A kernel's event time, device time and share of its bound."""
    from rtvqa_tpu_torch.probes import fmt_ms

    share = "" if dev_ms is None else f", {rec['bound_ms'] / dev_ms:.1%} by device time"
    return (f"kernel {rec['ms']:.4f} ms (device {fmt_ms(dev_ms)}; {rec['bound_ms'] / rec['ms']:.1%} of the "
            f"bound {rec['bound_ms']:.4f} by events{share})")


def content_frames(kind: str, n: int, h: int, w: int, seed: int, bar_rows: int = BAR_ROWS):
    """(ref, dis) YUV420 planes with flat regions, where kernel 3 redoes
    the VIF moments of a tile in the plain version's order. ``flat``: ref
    luma one level per quadrant (FLAT_LEVELS) with one textured square that
    moves a pixel per frame; dis = ref + noise on the left half, = ref on
    the right (``tests/test_torch_cuda.py::_flat_inputs`` at full size).
    ``letterbox``: the gradient + noise frames with black bars of
    ``bar_rows`` luma rows at the top and bottom (Y 16, U and V 128), equal
    in ref and dis."""
    rng = np.random.default_rng(seed)
    if kind == "flat":
        y = np.empty((n, h, w), np.uint8)
        for k, (ys, xs) in enumerate(((slice(0, h // 2), slice(0, w // 2)), (slice(0, h // 2), slice(w // 2, w)),
                                      (slice(h // 2, h), slice(0, w // 2)), (slice(h // 2, h), slice(w // 2, w)))):
            y[:, ys, xs] = FLAT_LEVELS[k]
        side = min(h, w) // 4
        tex = rng.integers(0, 256, (side, side + n), dtype=np.uint8)
        for i in range(n):
            y[i, h // 3:h // 3 + side, w // 3:w // 3 + side] = tex[:, i:i + side]
        ref = (y, *(rng.integers(100, 156, (n, h // 2, w // 2), np.uint8) for _ in range(2)))
        dis = distort(ref, seed + 1)
        dis[0][:, :, w // 2:] = y[:, :, w // 2:]
        return ref, dis
    ref = make_frames(n, h, w, seed)
    dis = distort(ref, seed + 1)
    for planes in (ref, dis):
        for a, level in zip(planes, (16, 128, 128)):
            bar = bar_rows * a.shape[1] // h
            a[:, :bar] = level
            a[:, a.shape[1] - bar:] = level
    return ref, dis


def flat_tile_share(x, taps) -> float:
    """Share of the (frame, 8 x 240 tile) steps of kernel 3's luma kernel
    (17 taps, on the u8 luma) or of kernel 5 (at one scale) with a pixel
    whose ref window is flat by the kernels' test, sigma1^2 < FLAT_TOL *
    E[x^2], on the plain version's moments: the share of steps that redo
    their VIF moments (an estimate: the kernels test their own FMA moments)."""
    from rtvqa_tpu_torch.vmaf.filters import filter1d_sep

    x = x.float()
    mu, e2 = filter1d_sep(x, taps), filter1d_sep(x * x, taps)
    flat = ((e2 - mu * mu) < FLAT_TOL * e2).float()
    b, h, w = flat.shape
    th, tw = VIF_TILE
    flat = torch.nn.functional.pad(flat, (0, -w % tw, 0, -h % th))
    return float(flat.view(b, -(-h // th), th, -(-w // tw), tw).amax(dim=(2, 4)).mean())


def vif_flat_share(ref, first: int) -> dict:
    """flat_tile_share of the VIF stencil (kernel 5, or kernel 4) at scales
    ``first`` .. 3, on the plain version's scale inputs from the ref plane
    of scale ``first``."""
    from rtvqa_tpu_torch.kernels.vif import TAPS
    from rtvqa_tpu_torch.vmaf.filters import decimate2, filter1d_sep

    x, shares = ref.float(), {}
    for scale in range(first, 4):
        if scale > first:
            x = decimate2(filter1d_sep(x, TAPS[scale]))
        shares[f"scale{scale}"] = round(flat_tile_share(x, TAPS[scale]), 4)
    return shares


def check_tail_kernels(label, ry, dy, dec) -> dict:
    """Kernels 5 (on the scale-1 pair ``dec``), 6 and 7 (on the u8 luma
    pair) against their plain versions with the tolerances above; returns
    their max relative errors."""
    from rtvqa_tpu_torch.kernels.adm import adm_scale_cuda, adm_scale_plain, adm_tail_cuda, adm_tail_plain
    from rtvqa_tpu_torch.kernels.vif import vif_tail_cuda, vif_tail_plain

    vk, vp = vif_tail_cuda(*dec), vif_tail_plain(*dec)
    num, den, a_ref, a_dis = adm_scale_cuda(ry, dy, 0)
    pn, pd, pa_ref, pa_dis = adm_scale_plain(ry, dy, 0)
    tk = adm_tail_cuda(a_ref, a_dis)
    tp = adm_tail_plain(a_ref, a_dis)
    torch.cuda.synchronize()
    rels = {}
    for key in vp:
        check_close(f"{label} {key}", vk[key], vp[key], rtol=VIF_TAIL_RTOL)
        rels[key] = max_rel(vk[key], vp[key])
    for key, g, p, rtol in (("adm0 num", num, pn, ADM_RTOL), ("adm0 den", den, pd, ADM_RTOL),
                            ("adm tail num", tk["num"], tp["num"], ADM_RTOL),
                            ("adm tail den", tk["den"], tp["den"], ADM_RTOL),
                            ("adm2", (num + tk["num"]) / (den + tk["den"]),
                             (pn + tp["num"]) / (pd + tp["den"]), ADM2_RTOL)):
        check_close(f"{label} {key}", g, p, rtol=rtol)
        rels[key] = max_rel(g, p)
    for key, g, p in (("a_ref", a_ref, pa_ref), ("a_dis", a_dis, pa_dis)):
        check_close(f"{label} {key}", g, p, rtol=PLANE_RTOL, atol=PLANE_ATOL)
    return {k: float(f"{v:.3g}") for k, v in rels.items()}


def phase_quality_content(dev, b: int, recs: list[dict]) -> None:
    """Kernels 3, 5, 6 and 7 at b x H x W on content with flat regions
    (content_frames): held against their plain versions (kernel 5 on kernel
    3's scale-1 pair, kernel 7 on kernel 6's bands), timed beside the
    gradient + noise frames' times (recs: the records of
    phase_quality_kernels), with the share of kernel 3's and kernel 5's tile
    steps that redo their VIF moments."""
    from rtvqa_tpu_torch.kernels.adm import adm_scale_cuda, adm_tail_cuda
    from rtvqa_tpu_torch.kernels.quality import TAPS17, quality_fused_cuda, quality_fused_plain
    from rtvqa_tpu_torch.kernels.vif import vif_tail_cuda
    from rtvqa_tpu_torch.probes import device_ms, fmt_ms, time_ms

    def timed(fn):
        return f"{time_ms(fn, [None], 10, dev):.4f} ms (device {fmt_ms(device_ms(fn, [None], 10, dev))})"

    line = []
    for k, kind in enumerate(("flat", "letterbox")):
        ref, dis = content_frames(kind, b, H, W, SEED + 20 + k)
        planes = [torch.from_numpy(a).to(dev) for a in (*ref, *dis)]
        args = (planes[0], planes[1], planes[2], planes[3], planes[4], planes[5],
                torch.zeros((H, W), dtype=torch.float32, device=dev))
        got, want = quality_fused_cuda(*args), quality_fused_plain(*args)
        torch.cuda.synchronize()
        errs = check_quality_fused(f"quality_fused {kind}", got, want, H, W, H // 2, W // 2)
        rel = max_rel(got["vif_scale0"], want["vif_scale0"])
        del want
        dec = (got["dec_ref"], got["dec_dis"])
        ry, dy = planes[0], planes[3]
        rels = check_tail_kernels(kind, ry, dy, dec)
        a = adm_scale_cuda(ry, dy, 0)[2:]
        times = {"quality_fused": timed(lambda _: quality_fused_cuda(*args)),
                 "vif_tail": timed(lambda _: vif_tail_cuda(*dec)),
                 "adm_scale0": timed(lambda _: adm_scale_cuda(ry, dy, 0)),
                 "adm_tail": timed(lambda _: adm_tail_cuda(*a))}
        line.append(f"{kind}: times {json.dumps(times)}; tile steps flat: kernel 3 "
                    f"{flat_tile_share(ry, TAPS17):.1%}, kernel 5 {json.dumps(vif_flat_share(dec[0], 1))}; "
                    f"vif_scale0 rel {rel:.3g}, kernel 3 max abs errs {json.dumps(errs)}; kernels 5-7 max rel "
                    f"{json.dumps(rels)}")
        del planes, args, got, dec, a
        torch.cuda.empty_cache()
    gradient = {r["name"]: round(r["ms"], 4) for r in recs}
    print(f"quality content: {(b, H, W)}, kernels 3, 5, 6, 7 against plain within the tolerances; gradient + "
          f"noise {json.dumps(gradient)}; " + "; ".join(line))
    phase_vif_scale_content(dev)


def phase_vif_scale_content(dev) -> None:
    """Kernel 4 on a DCI-4K chunk (WIDE_N / 2 frames) of flat quadrants and
    of letterboxed 2.39:1 scope content (DCI_BAR_ROWS-row bars): the four
    scales chained on the kernel's own planes, each held against its plain
    version on the same inputs, timed (scale 0, then scales 1-3), with the
    share of its tile steps that redo their VIF moments at each scale."""
    from rtvqa_tpu_torch.kernels.vif import vif_scale_cuda, vif_scale_plain
    from rtvqa_tpu_torch.probes import device_ms, fmt_ms, time_ms

    def timed(fn):
        return f"{time_ms(fn, [None], 10, dev):.4f} ms (device {fmt_ms(device_ms(fn, [None], 10, dev))})"

    line = []
    for k, kind in enumerate(("flat", "letterbox")):
        ref, dis = content_frames(kind, WIDE_N // 2, WIDE_H, WIDE_W, SEED + 30 + k, DCI_BAR_ROWS)
        ry, dy = (torch.from_numpy(a[0]).to(dev) for a in (ref, dis))
        del ref, dis
        r, d, rels = ry, dy, {}
        for scale in range(4):
            got, want = vif_scale_cuda(r, d, scale), vif_scale_plain(r, d, scale)
            torch.cuda.synchronize()
            check_close(f"vif_scale {kind} scale {scale}", got[0], want[0],
                        rtol=VIF0_RTOL if scale == 0 else VIF_TAIL_RTOL)
            if scale < 3:
                for i in (1, 2):
                    check_close(f"vif_scale {kind} scale {scale} planes", got[i], want[i], rtol=PLANE_RTOL,
                                atol=PLANE_ATOL)
            rels[f"scale{scale}"] = float(f"{max_rel(got[0], want[0]):.3g}")
            if scale == 0:
                r1, d1 = got[1], got[2]
            r, d = got[1], got[2]
        del got, want, r, d
        times = {"scale0": timed(lambda _: vif_scale_cuda(ry, dy, 0)),
                 "scales1-3": timed(lambda _: vif_chain(vif_scale_cuda, r1, d1))}
        line.append(f"{kind}: times {json.dumps(times)}; tile steps flat {json.dumps(vif_flat_share(ry, 0))}; "
                    f"vif max rel {json.dumps(rels)}")
        del ry, dy, r1, d1
        torch.cuda.empty_cache()
    print(f"vif_scale content: {(WIDE_N // 2, WIDE_H, WIDE_W)}, kernel 4 against plain within the "
          "tolerances; " + "; ".join(line))


def phase_quality_oracle(dev) -> None:
    """The kernel chunk body on a small input against the repository's
    NumPy oracles (tests/oracles/quality.py, tests/oracles/adm.py)."""
    q_oracle, adm_oracle = (load_oracle(name) for name in ("quality", "adm"))
    from rtvqa_tpu_torch.metrics.full_reference import CHUNK_KEYS, chunk_kernels

    rng = np.random.default_rng(SEED + 4)
    b, h, w = 2, 64, 96
    ref = make_frames(b, h, w, SEED + 5)
    dis = distort(ref, SEED + 6)
    planes = [torch.from_numpy(a).to(dev) for a in (*ref, *dis)]
    prev_blur = torch.from_numpy((rng.random((h, w)) * 255).astype(np.float32)).to(dev)
    packed, _ = chunk_kernels(*planes, prev_blur, True)
    got = dict(zip(CHUNK_KEYS, packed.double().cpu().numpy()))
    worst = {}
    for i in range(b):
        r_pl, d_pl = [a[i] for a in ref], [a[i] for a in dis]
        want = {**q_oracle.psnr_frame(r_pl, d_pl), **q_oracle.ssim_frame(r_pl, d_pl),
                "adm2": adm_oracle.adm2(ref[0][i], dis[0][i])}
        for key, wv in want.items():
            tol = ORACLE_ADM_RTOL if key == "adm2" else (ORACLE_MSE_RTOL if key.startswith("mse") else 0.0)
            atol = ORACLE_SSIM_ATOL if key.startswith("ssim") else 0.0
            gv = float(got[key][i])
            if not abs(gv - wv) <= atol + tol * abs(wv):
                raise AssertionError(f"quality oracle {key}[{i}]: kernels {gv} vs NumPy {wv}")
            worst[key] = max(worst.get(key, 0.0), abs(gv - wv))
    print("quality oracle: " + ", ".join(f"{k} max abs {v:.3g}" for k, v in worst.items()))


def phase_float64_oracle(dev, y_np, u_np, v_np) -> None:
    """VIF scales 0-3 from kernels 3 + 5 (``chunk_kernels``) and from kernel
    4 (``vif_features_cuda``) on F64_VIF_N noisy pairs at 540x960, and
    kernel 1 on the suite's frames, against the port's float64 NumPy
    references; the references run on a pool of host threads."""
    from concurrent.futures import ThreadPoolExecutor

    from rtvqa_tpu_torch.kernels.gray import yuv420_to_gray_cuda
    from rtvqa_tpu_torch.kernels.quality import quality_fused_cuda
    from rtvqa_tpu_torch.kernels.vif import vif_features_cuda, vif_scale_cuda, vif_tail_cuda
    from rtvqa_tpu_torch.metrics.full_reference import CHUNK_KEYS, chunk_kernels
    from rtvqa_tpu_torch.ops.color import yuv420_to_gray_np
    from rtvqa_tpu_torch.vmaf.vif import vif_features_np

    t_phase = time.perf_counter()
    n, h, w = F64_VIF_N, F64_VIF_H, F64_VIF_W
    ref = make_frames(n, h, w, SEED + 9)
    dis = distort(ref, SEED + 10)
    planes = [torch.from_numpy(a).to(dev) for a in (*ref, *dis)]
    blur0 = torch.zeros((h, w), dtype=torch.float32, device=dev)
    (packed, _), _, chunk_counts = counted_run(
        (quality_fused_cuda, vif_tail_cuda), lambda: chunk_kernels(*planes, blur0, False))
    k4, _, k4_counts = counted_run((vif_scale_cuda,), lambda: vif_features_cuda(planes[0], planes[3]))
    check_launches("float64 oracle", {**chunk_counts, **k4_counts},
                   {"quality_fused_cuda": 1, "vif_tail_cuda": 1, "vif_scale_cuda": 4})
    routes = {"kernels 3 + 5": {k: packed[CHUNK_KEYS.index(k)] for k in VIF_KEYS}, "kernel 4": k4}
    routes = {r: {k: v.double().cpu().numpy() for k, v in got.items()} for r, got in routes.items()}
    yuv = [torch.from_numpy(a).to(dev) for a in (y_np, u_np, v_np)]
    gray, _, gray_counts = counted_run((yuv420_to_gray_cuda,), lambda: yuv420_to_gray_cuda(*yuv))
    check_launches("float64 oracle", gray_counts, {"yuv420_to_gray_cuda": 1})
    gray = gray.cpu().numpy()
    del yuv, planes

    def gray_err(i):
        return float(np.abs(gray[i].astype(np.float64) - yuv420_to_gray_np(y_np[i], u_np[i], v_np[i])).max())

    threads = min(8, os.cpu_count() or 1)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(threads) as pool:
        vif_jobs = [pool.submit(vif_features_np, ref[0][i], dis[0][i]) for i in range(n)]
        gray_errs = list(pool.map(gray_err, range(y_np.shape[0])))
        want = [job.result() for job in vif_jobs]
    oracle_s = time.perf_counter() - t0
    print(f"float64 oracle: the references took {oracle_s:.2f} s on {threads} host threads "
          f"(VIF {n}x{h}x{w}, gray {'x'.join(map(str, y_np.shape))})")
    worst = {}
    for route, got in routes.items():
        for key in VIF_KEYS:
            for i in range(n):
                g, wv = float(got[key][i]), want[i][key]
                if not (np.isfinite(g) and abs(g - wv) <= F64_VIF_RTOL * abs(wv)):
                    raise AssertionError(f"float64 oracle {route} {key}[{i}]: {g} vs NumPy {wv}, "
                                         f"beyond rtol {F64_VIF_RTOL}")
                worst[(route, key)] = max(worst.get((route, key), 0.0), abs(g - wv) / abs(wv))
    gray_max = max(gray_errs)
    if not gray_max <= F64_GRAY_ATOL:
        raise AssertionError(f"float64 oracle gray (kernel 1): max abs err {gray_max} > {F64_GRAY_ATOL}")
    for route in routes:
        print(f"float64 oracle: VIF {n}x{h}x{w} ({route}) max rel err, rtol {F64_VIF_RTOL}: "
              + ", ".join(f"{k} {worst[(route, k)]:.3g}" for k in VIF_KEYS))
    print(f"float64 oracle: gray {'x'.join(map(str, y_np.shape))} (kernel 1) max abs err "
          f"{gray_max:.3g}, atol {F64_GRAY_ATOL}; the phase took {time.perf_counter() - t_phase:.2f} s")


def frame_batches(planes, chunk: int):
    """``FrameBatch``es of ``chunk`` frames over (y, u, v) arrays, as the
    decoder yields them; timestamps 1/FPS apart."""
    from rtvqa_tpu_torch.io.stream import FrameBatch

    ts = np.arange(planes[0].shape[0]) * 1000.0 / FPS
    for s in range(0, planes[0].shape[0], chunk):
        yield FrameBatch(*(a[s:s + chunk] for a in planes), ts[s:s + chunk], s)


def run_loop(dev, ref_np, dis_np, chunk: int, impl: str, combined=None):
    """The quality chunk loop (or, with ``combined`` = (interval,
    complexity_chunk, merged), the combined loop: the tap, or the merged
    step where ``merged``) over prefetched, device-staged batches, as
    ``analyze_full_reference`` / ``analyze_combined`` run it after opening
    the streams. Returns (series, pooled dict, complexity or None)."""
    from rtvqa_tpu_torch.io.stream import prefetch, stage_to_device
    from rtvqa_tpu_torch.metrics.complexity_streaming import ComplexityAccumulator
    from rtvqa_tpu_torch.metrics.full_reference import (
        _quality_chunk_loop,
        combined_chunk_loop,
        pool_full_reference,
    )

    ref_it, dis_it = (prefetch(stage_to_device(frame_batches(p, chunk), chunk, dev), depth=1)
                      for p in (ref_np, dis_np))
    comp = None
    try:
        if combined is None:
            series, n = _quality_chunk_loop(ref_it, dis_it, chunk, None, None, dev, impl)
        else:
            interval, c_chunk, merged = combined
            acc = ComplexityAccumulator(64, 64, 0.8, c_chunk, motion_impl=impl, device=dev)
            series, n, comp = combined_chunk_loop(ref_it, dis_it, chunk, acc, interval, "dis",
                                                  None, None, dev, impl, merged)
    finally:
        ref_it.close()
        dis_it.close()
    return series, pool_full_reference(series, n), comp


def check_quality(label, n, s_k, pool_k, s_p, pool_p) -> None:
    """The kernel path's series and pooled values against the plain path's."""
    from rtvqa_tpu_torch.metrics.full_reference import CHUNK_KEYS

    if pool_k["n_frames"] != n or pool_p["n_frames"] != n:
        raise AssertionError(f"{label}: loop saw {pool_k['n_frames']} / {pool_p['n_frames']} frames, not {n}")
    tols = {"motion_sad": (SAD_RTOL, SAD_ATOL), "vif_scale0": (VIF0_RTOL, 0.0), "adm2": (ADM2_RTOL, 0.0)}
    for key in CHUNK_KEYS:
        if key.startswith("vif_scale") and key != "vif_scale0":
            rtol, atol = VIF_TAIL_RTOL, 0.0
        elif key.startswith("ssim"):
            rtol, atol = 0.0, SSIM_ATOL
        else:
            rtol, atol = tols.get(key, (SSE_RTOL, 0.0))
        a, b = s_k[key], s_p[key]
        if a.shape != (n,) or not np.isfinite(a).all():
            raise AssertionError(f"{label} series {key}: shape {a.shape}, finite {np.isfinite(a).all()}")
        check_close(f"{label} series {key}", torch.from_numpy(a), torch.from_numpy(b), rtol, atol)
    for key, rtol, atol in (("psnr", SSE_RTOL, 0.0), ("ssim", 0.0, SSIM_ATOL), ("vmaf", VMAF_RTOL, 0.0)):
        a, b = pool_k[key], pool_p[key]
        if not (np.isfinite(a) and abs(a - b) <= atol + rtol * abs(b)):
            raise AssertionError(f"{label} pooled {key}: kernel path {a} vs plain {b}")


def check_launches(label, launches: dict, at_least: dict, exactly: dict | None = None) -> None:
    for name, low in at_least.items():
        if launches[name] < low:
            raise AssertionError(f"{name} launched {launches[name]} times on the {label} kernel run, "
                                 f"not at least {low}")
    for name, count in (exactly or {}).items():
        if launches[name] != count:
            raise AssertionError(f"{name} launched {launches[name]} times on the {label} kernel run, "
                                 f"not {count}")


BY_KIND = ("launches_by_type", "launches_by_scale")


def counted_run(kernels, fn):
    """Set every kernel's count to 0, run ``fn`` (timed), read the counts; a
    wrapper that also counts its launches by input type or by scale adds
    one entry ``name[kind]`` per kind."""
    for k in kernels:
        k.launches = 0
        for attr in BY_KIND:
            if hasattr(k, attr):
                setattr(k, attr, dict.fromkeys(getattr(k, attr), 0))
    out, t = wall_s(fn)
    counts = {k.__name__: k.launches for k in kernels}
    for k in kernels:
        for attr in BY_KIND:
            counts.update({f"{k.__name__}[{kind}]": n for kind, n in getattr(k, attr, {}).items()})
    return out, t, counts


def quality_kernels():
    from rtvqa_tpu_torch.kernels.adm import adm_scale_cuda, adm_tail_cuda
    from rtvqa_tpu_torch.kernels.gray import yuv420_to_gray_cuda
    from rtvqa_tpu_torch.kernels.motion import block_match_motion_cuda
    from rtvqa_tpu_torch.kernels.quality import quality_fused_cuda
    from rtvqa_tpu_torch.kernels.vif import vif_scale_cuda, vif_tail_cuda

    return (quality_fused_cuda, vif_tail_cuda, adm_scale_cuda, adm_tail_cuda, vif_scale_cuda,
            yuv420_to_gray_cuda, block_match_motion_cuda)


def phase_quality(dev, ref_np, dis_np):
    """The streaming chunk loop over N frames on the kernels, then on the
    plain versions; pooled with the builtin VMAF model. Returns (launches,
    kernel-path series, kernel-path pooled values)."""
    from rtvqa_tpu_torch.metrics.full_reference import auto_chunk

    chunk = auto_chunk(W, H)
    run_loop(dev, ref_np, dis_np, chunk, "kernel"), run_loop(dev, ref_np, dis_np, chunk, "plain")  # warm-up
    (s_k, pool_k, _), t_k, launches = counted_run(
        quality_kernels(), lambda: run_loop(dev, ref_np, dis_np, chunk, "kernel"))
    (s_p, pool_p, _), t_p = wall_s(lambda: run_loop(dev, ref_np, dis_np, chunk, "plain"))
    check_quality("quality", N, s_k, pool_k, s_p, pool_p)
    check_launches("quality", launches, {k: 1 for k in ("quality_fused_cuda", "vif_tail_cuda",
                                                        "adm_scale_cuda", "adm_tail_cuda")})
    print(f"quality: {N}x{H}x{W} in {N // chunk} chunks of {chunk}: kernel path {t_k:.4f} s, "
          f"plain path {t_p:.4f} s; launches {launches}; psnr {pool_k['psnr']:.6f} "
          f"ssim {pool_k['ssim']:.6f} vmaf {pool_k['vmaf']:.6f} (plain {pool_p['psnr']:.6f} "
          f"{pool_p['ssim']:.6f} {pool_p['vmaf']:.6f})")
    profile_device("quality, kernel path", lambda: run_loop(dev, ref_np, dis_np, chunk, "kernel"), top=12)
    return launches, s_k, pool_k


COMBINED_KERNELS = ("quality_fused_cuda", "vif_tail_cuda", "adm_scale_cuda", "adm_tail_cuda",
                    "yuv420_to_gray_cuda", "block_match_motion_cuda")


def check_complexity_result(label, got, wants: dict) -> tuple[dict, list]:
    """A ``ComplexityResult`` against others (name -> result) by
    ``check_complexity``; returns the max rel per metric over them, and the
    names whose results are equal to ``got`` in every metric."""
    worst = {}
    for name, want in wants.items():
        rel = check_complexity(f"{label} vs {name}", np.array([got.as_tuple()]), np.array([want.as_tuple()]))
        worst = {k: max(worst.get(k, 0.0), v) for k, v in rel.items()}
    return worst, [name for name, want in wants.items() if want == got]


def check_series_equal(label, series, s_alone) -> None:
    for key, a in s_alone.items():
        if not np.array_equal(series[key], a):
            raise AssertionError(f"{label} series {key} differs from the quality loop without complexity")


def phase_combined(dev, ref_np, dis_np, s_alone) -> None:
    """The default config's combined loop over the N pairs at frame_interval
    10 and 1, complexity_chunk 128, tapping the sampled dis frames, on the
    kernels and on the plain versions; then at frame_interval 1 the merged
    step (``analyze_combined``'s default on the card there) on the kernels,
    beside the tap: walls, device time, H2D bytes and peak memory of both."""
    from rtvqa_tpu_torch.io.video import DecodedClip
    from rtvqa_tpu_torch.metrics.complexity import calculate_average_scene_complexity
    from rtvqa_tpu_torch.metrics.full_reference import auto_chunk

    chunk = auto_chunk(W, H)
    dis_y, dis_u, dis_v = dis_np
    ts = np.arange(N) * 1000.0 / FPS

    def run(impl, interval, merged=False):
        return run_loop(dev, ref_np, dis_np, chunk, impl, combined=(interval, 128, merged))

    for interval in (10, 1):
        run("kernel", interval), run("plain", interval)  # warm-up
        (s_k, pool_k, comp_k), t_k, counts = counted_run(quality_kernels(), lambda: run("kernel", interval))
        (s_p, pool_p, comp_p), t_p = wall_s(lambda: run("plain", interval))
        # The tap leaves the quality series bit for bit as they are without it.
        check_series_equal(f"combined (interval {interval})", s_k, s_alone)
        check_quality(f"combined (interval {interval})", N, s_k, pool_k, s_p, pool_p)
        sl = slice(interval - 1, None, interval)  # decode_sampled's 1-based sampling
        n_s = len(ts[sl])
        clip = DecodedClip(y=dis_y[sl], u=dis_u[sl], v=dis_v[sl], timestamps_ms=ts[sl], width=W,
                           height=H, n_frames_total=N, bit_rate=0, avg_fps=FPS / interval)
        suite_k = calculate_average_scene_complexity(clip, 64, 64, device=dev)
        worst, _ = check_complexity_result(f"combined (interval {interval})", comp_k,
                                           {"suite": suite_k, "plain": comp_p})
        check_launches(f"combined (interval {interval})", counts, {k: 1 for k in COMBINED_KERNELS})
        print(f"combined (interval {interval}): {N}x{H}x{W} pairs, {n_s} sampled dis frames: kernel "
              f"path {t_k:.4f} s, plain path {t_p:.4f} s; launches {counts}; quality series equal to "
              f"the loop without the tap; complexity max rel vs suite/plain {json.dumps(worst)}; "
              f"values {comp_k}")
        prof_tap = profile_device(f"combined (interval {interval}), kernel path",
                                  lambda: run("kernel", interval), top=12, h2d=interval == 1)
        del s_k, s_p
        torch.cuda.empty_cache()

    # frame_interval 1 (the last loop's): the merged step against the tap
    # (comp_k, t_k, prof_tap) and the suite (suite_k).
    run("kernel", 1, merged=True)  # warm-up
    (s_m, _, comp_m), t_m, counts_m = counted_run(quality_kernels(), lambda: run("kernel", 1, merged=True))
    check_series_equal("combined merged (interval 1)", s_m, s_alone)
    worst_m, equal_m = check_complexity_result("combined merged (interval 1)", comp_m,
                                               {"tap": comp_k, "suite": suite_k})
    n_chunks = N // chunk
    check_launches("combined merged (interval 1)", counts_m,
                   {**{k: 1 for k in COMBINED_KERNELS},
                    "yuv420_to_gray_cuda": n_chunks, "block_match_motion_cuda": n_chunks})
    walls = {"tap": [t_k], "merged": [t_m]}
    for _ in range(2):  # in turns, tap first
        walls["tap"].append(wall_s(lambda: run("kernel", 1))[1])
        walls["merged"].append(wall_s(lambda: run("kernel", 1, merged=True))[1])
    uploads, peak = {}, {}
    for route, merged in (("tap", False), ("merged", True)):
        peak[route] = peak_gib(lambda: uploads.update({route: counted_uploads(lambda: run("kernel", 1, merged))}))
    print(f"combined merged (interval 1): {N}x{H}x{W} pairs in {n_chunks} merged steps of {chunk}: "
          f"launches {counts_m}; quality series equal to the loop without complexity; complexity max "
          f"rel vs tap/suite {json.dumps(worst_m)}, equal in every metric to: {equal_m or 'neither'}; "
          f"values {comp_m}")
    prof_m = profile_device("combined merged (interval 1), kernel path",
                            lambda: run("kernel", 1, merged=True), top=12, h2d=True)
    # The merged step uploads the staged pairs and nothing else: no
    # accumulator re-upload.
    staged = sum(a.nbytes for a in (*ref_np, *dis_np))
    if uploads["merged"][0] != staged:
        raise AssertionError(f"combined merged (interval 1): uploaded {uploads['merged'][0]} B, not the "
                             f"{staged} B of the staged pairs")

    def fig(prof, key, fmt):
        return "not measured" if not prof or prof.get(key) is None else format(prof[key], fmt)

    for route, prof in (("tap", prof_tap), ("merged", prof_m)):
        print(f"combined (interval 1) {route}: walls {', '.join(f'{t:.4f}' for t in walls[route])} s; "
              f"profiled device {fig(prof, 'device_ms', '.3f')} ms of {fig(prof, 'wall_ms', '.3f')} ms "
              f"wall (busy {fig(prof, 'busy', '.1%')}), {fig(prof, 'h2d_copies', 'd')} H2D copies recorded in "
              f"{fig(prof, 'h2d_ms', '.3f')} ms; uploaded {uploads[route][0]} B in {uploads[route][1]} "
              f"calls (the staged pairs: {staged} B); peak memory {peak[route]:.3f} GiB")
    del s_m
    torch.cuda.empty_cache()


def chain_work(b, h, w) -> tuple[int, int]:
    """Kernel 4's work at scales 1-3 below a (b, h, w) scale-0 pair: each
    scale's f32 pair in and (below scale 3) the next one out."""
    from rtvqa_tpu_torch.obs.roofline import vif_scale_work

    total = [0, 0]
    for scale in (1, 2, 3):
        h, w = (h + 1) // 2, (w + 1) // 2
        for i, n in enumerate(vif_scale_work(b, h, w, 4, scale)):
            total[i] += n
    return total[0], total[1]


def vif_chain(scale_fn, r, d) -> None:
    """Scales 1-3 of ``scale_fn`` (kernel 4 or its plain version) from the
    scale-1 pair (r, d)."""
    for scale in (1, 2, 3):
        _, r, d = scale_fn(r, d, scale)


def phase_vif_scale(dev, ref_np, dis_np, ref_1080, dis_1080) -> list[dict]:
    """Kernel 4 at DCI 4K against its plain version, scale by scale, and the
    four-scale chain against the fused kernel's VIF at 1080p. Returns the
    records of scale 0 and of the chain of scales 1-3."""
    from rtvqa_tpu_torch.kernels.quality import quality_fused_cuda
    from rtvqa_tpu_torch.kernels.vif import (
        vif_features_cuda,
        vif_features_plain,
        vif_scale_cuda,
        vif_scale_occupancy,
        vif_scale_plain,
        vif_tail_cuda,
    )
    from rtvqa_tpu_torch.obs.roofline import vif_scale_work
    from rtvqa_tpu_torch.probes import device_ms, fmt_ms, time_ms

    ry, dy = (torch.from_numpy(a).to(dev) for a in (ref_np[0], dis_np[0]))
    b, h, w = ry.shape
    got, want = vif_scale_cuda(ry, dy, 0), vif_scale_plain(ry, dy, 0)
    torch.cuda.synchronize()
    check_close("vif_scale 0", got[0], want[0], rtol=VIF0_RTOL)
    for i, key in ((1, "dec_ref"), (2, "dec_dis")):
        check_close(f"vif_scale 0 {key}", got[i], want[i], rtol=PLANE_RTOL, atol=PLANE_ATOL)
    errs = {"scale0": max_abs(got[0], want[0]), "dec": max(max_abs(got[i], want[i]) for i in (1, 2))}
    rels = {"scale0": max_rel(got[0], want[0])}
    check_repeat("vif_scale 0", got, vif_scale_cuda(ry, dy, 0))
    del want
    # Scales 1-3 chained on the kernel's own outputs.
    r1, d1 = r, d = got[1], got[2]
    for scale in (1, 2, 3):
        k, p = vif_scale_cuda(r, d, scale), vif_scale_plain(r, d, scale)
        torch.cuda.synchronize()
        check_close(f"vif_scale {scale}", k[0], p[0], rtol=VIF_TAIL_RTOL)
        if scale < 3:
            for i in (1, 2):
                check_close(f"vif_scale {scale} planes", k[i], p[i], rtol=PLANE_RTOL, atol=PLANE_ATOL)
        check_repeat(f"vif_scale {scale}", k[:1 if scale == 3 else 3], vif_scale_cuda(r, d, scale))
        errs[f"scale{scale}"] = max_abs(k[0], p[0])
        rels[f"scale{scale}"] = max_rel(k[0], p[0])
        r, d = k[1], k[2]
    del got, r, d, k, p
    ms = time_ms(lambda _: vif_scale_cuda(ry, dy, 0), [None], 10, dev)
    dev_ms = device_ms(lambda _: vif_scale_cuda(ry, dy, 0), [None], 10, dev)
    plain_ms = time_ms(lambda _: vif_scale_plain(ry, dy, 0), [None], 2, dev)
    chain_ms = time_ms(lambda _: vif_chain(vif_scale_cuda, r1, d1), [None], 10, dev)
    chain_dev_ms = device_ms(lambda _: vif_chain(vif_scale_cuda, r1, d1), [None], 10, dev)
    chain_plain_ms = time_ms(lambda _: vif_chain(vif_scale_plain, r1, d1), [None], 2, dev)
    ms4 = time_ms(lambda _: vif_features_cuda(ry, dy), [None], 10, dev)
    dev4_ms = device_ms(lambda _: vif_features_cuda(ry, dy), [None], 10, dev)
    plain4_ms = time_ms(lambda _: vif_features_plain(ry, dy), [None], 2, dev)
    mem = (peak_gib(lambda: vif_scale_cuda(ry, dy, 0)), peak_gib(lambda: vif_scale_plain(ry, dy, 0)))
    rec0 = record("vif_scale[scale0]", "rtvqa_tpu_torch/csrc/vif.cu", "rtvqa_tpu/kernels/vif_pallas.py:583",
                  max(errs["scale0"], errs["dec"]), ms, plain_ms, vif_scale_work(b, h, w, 1, 0))
    rec_chain = record("vif_scale[scales1-3]", "rtvqa_tpu_torch/csrc/vif.cu",
                       "rtvqa_tpu/kernels/vif_pallas.py:583", max(errs[f"scale{k}"] for k in (1, 2, 3)),
                       chain_ms, chain_plain_ms, chain_work(b, h, w))
    occupancy = {"u8 scale 0": vif_scale_occupancy(dev, torch.uint8, 0),
                 **{f"f32 scale {k}": vif_scale_occupancy(dev, torch.float32, k) for k in (1, 2, 3)}}
    print(f"vif_scale: {(b, h, w)} u8 pair, scale 0 then 1-3 chained: max abs errs {json.dumps(errs)}, "
          f"rel {json.dumps(rels)}; repeat bit-equal; scale 0 {kernel_time(rec0, dev_ms)}, plain "
          f"{plain_ms:.4f} ms; scales 1-3 {kernel_time(rec_chain, chain_dev_ms)}, plain "
          f"{chain_plain_ms:.4f} ms; four scales kernel {ms4:.4f} ms (device {fmt_ms(dev4_ms)}), plain "
          f"{plain4_ms:.4f} ms; peak scale 0 {mem[0]:.2f} vs {mem[1]:.2f} GiB; vif_tail_kernel "
          f"{json.dumps(occupancy)}")
    del ry, dy, r1, d1
    torch.cuda.empty_cache()

    # At 1080p the chain shares its arithmetic with the fused kernel + tail.
    planes = [torch.from_numpy(a).to(dev) for a in (*ref_1080, *dis_1080)]
    blur = torch.zeros(planes[0].shape[1:], dtype=torch.float32, device=dev)
    fq = quality_fused_cuda(*planes, blur)
    fused = {"vif_scale0": fq["vif_scale0"], **vif_tail_cuda(fq["dec_ref"], fq["dec_dis"])}
    chain = vif_features_cuda(planes[0], planes[3])
    torch.cuda.synchronize()
    rels = {}
    for key, v in fused.items():
        check_close(f"1080p chain {key}", chain[key], v, rtol=VIF0_RTOL if key == "vif_scale0" else VIF_TAIL_RTOL)
        rels[key] = max_rel(chain[key], v)
    print(f"vif_scale chain vs fused kernel + tail at {tuple(planes[0].shape)}: max rel {json.dumps(rels)}")
    del planes, fq, fused, chain
    torch.cuda.empty_cache()
    return [rec0, rec_chain]


def phase_wide_quality(dev, ref_np, dis_np) -> None:
    """The chunk loop over WIDE_N DCI-4K pairs (two chunks) on the kernels
    (the fused route, as at every width on the card), then on the plain
    versions."""
    from rtvqa_tpu_torch.metrics.full_reference import auto_chunk

    chunk = auto_chunk(WIDE_W, WIDE_H)
    run_loop(dev, ref_np, dis_np, chunk, "kernel")  # warm-up
    (s_k, pool_k, _), t_k, launches = counted_run(
        quality_kernels(), lambda: run_loop(dev, ref_np, dis_np, chunk, "kernel"))
    torch.cuda.empty_cache()
    (s_p, pool_p, _), t_p = wall_s(lambda: run_loop(dev, ref_np, dis_np, chunk, "plain"))
    torch.cuda.empty_cache()
    check_quality("wide quality", WIDE_N, s_k, pool_k, s_p, pool_p)
    n_chunks = WIDE_N // chunk
    check_launches("wide quality", launches, {}, {
        "quality_fused_cuda": n_chunks, "vif_tail_cuda": n_chunks, "adm_scale_cuda": n_chunks,
        "adm_tail_cuda": n_chunks, "vif_scale_cuda": 0})
    mem = peak_gib(lambda: run_loop(dev, ref_np, dis_np, chunk, "kernel"))
    print(f"wide_quality: {WIDE_N}x{WIDE_H}x{WIDE_W} in {n_chunks} chunks of {chunk}: kernel path "
          f"{t_k:.4f} s, plain path {t_p:.4f} s; peak {mem:.2f} GiB (kernel path); launches {launches}; "
          f"psnr {pool_k['psnr']:.6f} ssim {pool_k['ssim']:.6f} vmaf {pool_k['vmaf']:.6f} (plain "
          f"{pool_p['psnr']:.6f} {pool_p['ssim']:.6f} {pool_p['vmaf']:.6f})")
    profile_device("wide quality, kernel path", lambda: run_loop(dev, ref_np, dis_np, chunk, "kernel"), top=12)


def phase_trace(dev, ref_np, dis_np, s_alone) -> None:
    """``obs/profiler.py::device_trace`` around one kernel-path run of the
    quality loop: the exported Chrome trace must name every ``__global__``
    kernel of the route, and the series must equal the untraced run's."""
    from rtvqa_tpu_torch.metrics.full_reference import auto_chunk
    from rtvqa_tpu_torch.obs.profiler import device_trace

    chunk = auto_chunk(W, H)
    with tempfile.TemporaryDirectory() as log_dir:
        def traced():
            with device_trace(log_dir, dev) as path:
                return run_loop(dev, ref_np, dis_np, chunk, "kernel"), path

        ((series, _, _), path), t, launches = counted_run(quality_kernels(), traced)
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = {e["name"] for e in kernels}
    missing = [k for k in ROUTE_KERNELS if not any(k in name for name in names)]
    if missing:
        raise AssertionError(f"trace: no kernel event names {missing} (kernel names: {sorted(names)[:20]})")
    for key, a in s_alone.items():
        if not np.array_equal(series[key], a):
            raise AssertionError(f"trace: series {key} differs from the untraced loop")
    check_launches("trace", launches, {k: 1 for k in ("quality_fused_cuda", "vif_tail_cuda",
                                                      "adm_scale_cuda", "adm_tail_cuda")})
    busy_ms = sum(e.get("dur", 0.0) for e in kernels) / 1e3
    print(f"trace: {N}x{H}x{W} quality loop under device_trace in {t:.4f} s; {size} bytes, "
          f"{len(events)} events, {len(kernels)} kernel events ({busy_ms:.3f} ms), names all of "
          f"{list(ROUTE_KERNELS)}; series equal to the untraced loop")


def phase_probes(dev, ref_y, dis_y) -> list[dict]:
    """Kernels 6a, 8 and 9 against their plain versions at the probes'
    shapes (6a at the quality chunk's, beside kernel 6), then the
    measurement path: the three probe entry points at their default shapes,
    with the launch counts set to 0 before and read after."""
    from rtvqa_tpu_torch.kernels.adm import (
        adm_input_cuda,
        adm_input_plain,
        adm_scale_cuda,
        adm_strip_plan,
    )
    from rtvqa_tpu_torch.kernels.probes import (
        strip_floor_cuda,
        strip_floor_plain,
        strip_sum_cuda,
        strip_sum_plain,
    )
    from rtvqa_tpu_torch.obs.roofline import (
        adm_input_work,
        strip_floor_windows,
        strip_floor_work,
        strip_sum_work,
    )
    from rtvqa_tpu_torch.probes import adm_stages, device_ms, dma_floor, fmt_ms, int8_dma, time_ms

    # Kernel 6a on the 64-frame 1080p luma pair, exact.
    ry, dy = (torch.from_numpy(a).to(dev) for a in (ref_y, dis_y))
    b, h, w = ry.shape
    got, want = adm_input_cuda(ry, dy), adm_input_plain(ry, dy)
    torch.cuda.synchronize()
    for key, g, p in zip(("num", "den", "a_ref", "a_dis"), got, want):
        if g.shape != p.shape or not torch.equal(g, p):
            raise AssertionError(f"adm_input {key}: kernel {g.flatten()[:4]} vs plain {p.flatten()[:4]}")
    ms = time_ms(lambda _: adm_input_cuda(ry, dy), [None], 20, dev)
    plain_ms = time_ms(lambda _: adm_input_plain(ry, dy), [None], 5, dev)
    k6_ms = time_ms(lambda _: adm_scale_cuda(ry, dy, 0), [None], 10, dev)
    dev_ms = [device_ms(lambda p: fn(*p), [(ry, dy)], 10, dev) for fn in (adm_input_cuda, adm_scale_cuda)]
    rec6a = record("adm_input", "rtvqa_tpu_torch/csrc/adm.cu", "rtvqa_tpu/kernels/adm_pallas.py:590",
                   0.0, ms, plain_ms, adm_input_work(b, h, w, adm_strip_plan(h, w)[1]))
    print(f"adm_input: {(b, h, w)} u8 pair, num equal to plain ({got[0][:2].tolist()} ...); kernel "
          f"{ms:.4f} ms (device {fmt_ms(dev_ms[0])}), plain {plain_ms:.4f} ms, bound {rec6a['bound_ms']:.4f} "
          f"ms; kernel 6 (adm_scale_cuda) {k6_ms:.4f} ms (device {fmt_ms(dev_ms[1])}): the input path is "
          f"{ms / k6_ms:.1%} of it")
    del ry, dy, got, want

    # Kernel 8 at the script's shape, u8 and f32; three inputs per type (> L2).
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    shape8 = (16, 1080, 1920)
    xs = [torch.randint(0, 256, shape8, generator=gen, device=dev, dtype=torch.uint8) for _ in range(3)]

    def library(x):
        return torch.sum(x, (1, 2), dtype=torch.float32)

    rec8, line = [], []
    for name, inputs in (("u8", xs), ("f32", [x.float() for x in xs])):
        got, want = strip_sum_cuda(inputs[0]), strip_sum_plain(inputs[0])
        torch.cuda.synchronize()
        check_close(f"strip_sum {name}", got, want, rtol=STRIP_SUM_RTOL)
        ms = time_ms(strip_sum_cuda, inputs, 20, dev)
        plain_ms = time_ms(strip_sum_plain, inputs, 3, dev)
        lib_ms = time_ms(library, inputs, 20, dev)
        dev_ms = [device_ms(fn, inputs, 20, dev) for fn in (strip_sum_cuda, library)]
        rec = record(f"strip_sum_{name}", "rtvqa_tpu_torch/csrc/probes.cu",
                     "scripts/probe_int8_dma.py:68", max_abs(got, want), ms, plain_ms,
                     strip_sum_work(*shape8, inputs[0].element_size()), lib_ms)
        rec8.append(rec)
        frames = strip_sum_work(*shape8, inputs[0].element_size())[0]
        line.append(f"{name} kernel {ms:.4f} ms (device {fmt_ms(dev_ms[0])}; bound {rec['bound_ms']:.4f}, "
                    f"{rec['bound_ms'] / ms:.1%} of it; frames read at {frames / ms / 1e6:.1f} GB/s; "
                    f"rel err {max_rel(got, want):.3g}), plain {plain_ms:.4f}, torch.sum {lib_ms:.4f} "
                    f"(device {fmt_ms(dev_ms[1])})")
    print(f"strip_sum: {shape8}: " + "; ".join(line))
    del xs, inputs

    # Kernel 9 at the script's shape in f32, bf16 and u8, exact.
    shape9 = (128, 1088, 2176)
    rec9, line = None, []
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16), ("u8", torch.uint8)):
        x = (torch.rand(shape9, generator=gen, device=dev) * 255.0).to(dtype)
        got, want = strip_floor_cuda(x), strip_floor_plain(x)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"strip_floor {name}: kernel {float(got)} vs plain {float(want)}")
        ms = time_ms(strip_floor_cuda, [x], 20, dev)
        dms = device_ms(strip_floor_cuda, [x], 20, dev)
        plain_ms = time_ms(strip_floor_plain, [x], 5, dev)
        work = strip_floor_work(*shape9, x.element_size())
        rec = record(f"strip_floor_{name}", "rtvqa_tpu_torch/csrc/probes.cu",
                     "scripts/probe_dma_floor.py:119", 0.0, ms, plain_ms, work)
        rec9 = rec9 or rec
        windows = strip_floor_windows(*shape9, x.element_size())
        line.append(f"{name} kernel {ms:.4f} ms ({rec['bound_ms'] / ms:.1%} of the bound "
                    f"{rec['bound_ms']:.4f}; windows read at {windows / ms / 1e6:.1f} GB/s; device "
                    f"{fmt_ms(dms)}), plain {plain_ms:.4f}")
        del x
    print(f"strip_floor: {shape9}, equal to plain: " + "; ".join(line))
    torch.cuda.empty_cache()

    # The measurement path through its entry points.
    kernels = (adm_input_cuda, adm_scale_cuda, strip_sum_cuda, strip_floor_cuda)
    rcs, t, launches = counted_run(
        kernels, lambda: [m.main(["--reps", "5"]) for m in (adm_stages, int8_dma, dma_floor)])
    if any(rcs):
        raise AssertionError(f"probe entry points returned {rcs}")
    check_launches("probes", launches, {k: 1 for k in launches})
    print(f"probes: adm_stages, int8_dma, dma_floor at their default shapes in {t:.4f} s; "
          f"launches {launches}")
    torch.cuda.empty_cache()
    for rec, wrapper in ((rec6a, "adm_input_cuda"), (rec8[0], "strip_sum_cuda[u8]"),
                         (rec8[1], "strip_sum_cuda[f32]"), (rec9, "strip_floor_cuda")):
        rec["launches"] = launches[wrapper]
    return [rec6a, *rec8, rec9]


def score_bound(res) -> float:
    """The scorer's tolerance from its values' (MOTION_RTOL on motion and
    edge, SUITE_RTOL on the rest): sum of weight x tolerance x |value| /
    range."""
    from rtvqa_tpu_torch.metrics.complexity import SCORE_RANGES, SCORE_WEIGHTS

    bound = 0.0
    for key, weight in SCORE_WEIGHTS.items():
        lo, hi = SCORE_RANGES[key]
        tol = MOTION_RTOL if key in ("motion", "edge") else SUITE_RTOL
        bound += weight * tol * abs(getattr(res, key)) / (hi - lo)
    return bound


def corner_gray(n: int, h: int, w: int, seed: int):
    """(n, h, w) f32 gray with FAST corners: the gradient + noise luma with
    flat squares of random levels pasted in, through the YUV420 -> gray
    conversion (non-integer values)."""
    from rtvqa_tpu_torch.ops.color import yuv420_to_gray

    y, u, v = make_frames(n, h, w, seed)
    rng = np.random.default_rng(seed + 1)
    for frame in y:
        for _ in range(400):
            cy, cx, side = rng.integers(40, h - 40), rng.integers(40, w - 40), rng.integers(4, 12)
            frame[cy - side:cy + side, cx - side:cx + side] = rng.integers(0, 256)
    return yuv420_to_gray(*(torch.from_numpy(a) for a in (y, u, v)))


def feature_peak_bytes(dev, ry, dy, impl: str) -> int:
    """Peak device bytes one chunk's features take above their u8 inputs:
    ``_frame_features`` and the motion SADs, as ``extract_features`` runs
    them on an uploaded chunk."""
    from rtvqa_tpu_torch.vmaf.motion import motion_sads
    from rtvqa_tpu_torch.vmaf.predictor import _frame_features

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _frame_features(ry, dy, impl)
    motion_sads(ry)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def phase_api(dev, ref_np, dis_np, suite_res, series, pooled) -> dict:
    """The JAX package's API on the card at 1080p: the scorer on the suite's
    N frames (kernels 1 and 2), the pairwise pyramid on API_PAIRS pairs
    (kernel 2), ``compute_quality`` on the N pairs, ``extract_features`` /
    ``compute_vmaf`` on API_PAIRS pairs (kernels 4, 6 and 7) and
    ``orb_features`` on ORB_FRAMES frames against the CPU. Returns the
    ``extract_features`` kernel run's launches (kernel 4 by scale)."""
    from rtvqa_tpu_torch.io.video import DecodedClip
    from rtvqa_tpu_torch.kernels.adm import adm_scale_cuda, adm_tail_cuda
    from rtvqa_tpu_torch.kernels.gray import yuv420_to_gray_cuda
    from rtvqa_tpu_torch.kernels.motion import block_match_motion_cuda
    from rtvqa_tpu_torch.kernels.vif import vif_scale_cuda
    from rtvqa_tpu_torch.metrics.complexity import (
        calculate_average_scene_complexity,
        calculate_scene_complexity_score,
        scene_complexity_score,
    )
    from rtvqa_tpu_torch.metrics.quality import compute_quality
    from rtvqa_tpu_torch.ops.color import yuv420_to_gray
    from rtvqa_tpu_torch.ops.motion import (
        block_match_motion,
        block_match_motion_pyramid,
        block_match_motion_pyramid_series,
        down2_mean,
    )
    from rtvqa_tpu_torch.ops.orb import orb_features
    from rtvqa_tpu_torch.vmaf.model import builtin_model
    from rtvqa_tpu_torch.vmaf.predictor import (
        FRAME_KEYS,
        MEMORY_SHARE,
        compute_vmaf,
        default_chunk,
        extract_features,
    )

    # The scorer: the suite on the kernels, then the weighted score.
    clip = suite_clip(*ref_np)
    calculate_scene_complexity_score(clip, 64, 64, device=dev)  # warm-up
    score, t_score, counts = counted_run(
        (yuv420_to_gray_cuda, block_match_motion_cuda),
        lambda: calculate_scene_complexity_score(clip, 64, 64, device=dev))
    check_launches("api scorer", counts, {"yuv420_to_gray_cuda": 1, "block_match_motion_cuda": 1})
    if score != scene_complexity_score(suite_res):
        raise AssertionError(f"api scorer {score} != the suite phase's score {scene_complexity_score(suite_res)}")
    plain_res, t_plain = wall_s(lambda: calculate_average_scene_complexity(
        clip, 64, 64, motion_impl="plain", device=dev))
    plain_score, bound = scene_complexity_score(plain_res), score_bound(plain_res)
    if not (np.isfinite(score) and abs(score - plain_score) <= bound):
        raise AssertionError(f"api scorer: kernel path {score} vs plain {plain_score} beyond {bound:.3g}")
    print(f"api scorer: {N}x{H}x{W}: score {score!r} (equal to the suite phase's; plain path {plain_score!r}, "
          f"|diff| {abs(score - plain_score):.3g} <= {bound:.3g}); kernel path {t_score:.4f} s, plain suite "
          f"{t_plain:.4f} s; launches {counts}")

    # The pairwise pyramid on API_PAIRS consecutive pairs.
    planes = [torch.from_numpy(a[:API_PAIRS + 1]).to(dev) for a in ref_np]
    gray = yuv420_to_gray(*planes)
    prev, curr = gray[:-1], gray[1:]
    block_match_motion_pyramid(prev, curr)  # warm-up
    got, t_k, counts = counted_run((block_match_motion_cuda,), lambda: block_match_motion_pyramid(prev, curr))
    check_launches("api pyramid", counts, {}, {"block_match_motion_cuda": 1})
    series_form = block_match_motion_pyramid_series(gray, BLOCK, RADIUS, impl="kernel")
    if not torch.equal(got, series_form):
        raise AssertionError("api pyramid: pairwise kernel route differs from the series form")
    plain, t_p = wall_s(lambda: 2.0 * block_match_motion(down2_mean(prev), down2_mean(curr), BLOCK // 2,
                                                          RADIUS // 2))
    check_close("api pyramid vs plain", got, plain, rtol=MOTION_RTOL)
    print(f"api pyramid: {tuple(prev.shape)} pairs: equal to the series form; max rel vs plain "
          f"{max_rel(got, plain):.3g} (equal: {torch.equal(got, plain)}); kernel route {t_k:.4f} s, plain "
          f"{t_p:.4f} s; launches {counts}")
    del planes, gray, prev, curr, got, series_form, plain

    # compute_quality on the N pairs against the quality loop's kernel path.
    ref_clip, dis_clip = (DecodedClip(y=p[0], u=p[1], v=p[2], timestamps_ms=np.arange(N) * 1000.0 / FPS,
                                      width=W, height=H, n_frames_total=N, bit_rate=0, avg_fps=FPS)
                          for p in (ref_np, dis_np))
    compute_quality(ref_clip, dis_clip, device=dev)  # warm-up
    q, t_q = wall_s(lambda: compute_quality(ref_clip, dis_clip, device=dev))
    if q["n_frames"] != N or not np.array_equal(q["psnr_frames"], series["psnr_y"]):
        raise AssertionError("api compute_quality: psnr_frames differ from the quality loop's psnr_y")
    if q["psnr"] != pooled["psnr"]:
        raise AssertionError(f"api compute_quality: psnr {q['psnr']} vs the quality loop's {pooled['psnr']}")
    ssim_err = float(np.abs(q["ssim_frames"].astype(np.float64) - series["ssim_all"]).max())
    if not ssim_err <= API_SSIM_ATOL or abs(q["ssim"] - pooled["ssim"]) > API_SSIM_ATOL:
        raise AssertionError(f"api compute_quality: ssim max abs err {ssim_err} > {API_SSIM_ATOL}")
    print(f"api compute_quality: {N}x{H}x{W} pairs in {t_q:.4f} s: psnr {q['psnr']!r} and psnr_frames equal "
          f"to the quality loop's; ssim {q['ssim']!r}, frames max abs err {ssim_err:.3g}")
    profile_device("api compute_quality", lambda: compute_quality(ref_clip, dis_clip, device=dev))

    # extract_features / compute_vmaf on API_PAIRS pairs, kernel route vs plain route.
    ref_v, dis_v = (first_frames(c, API_PAIRS) for c in (ref_clip, dis_clip))
    chunk = default_chunk(H, W, dev, "kernel")
    extract_features(ref_v, dis_v, device=dev), extract_features(ref_v, dis_v, impl="plain", device=dev)
    kernels = (vif_scale_cuda, adm_scale_cuda, adm_tail_cuda)
    feats_k, t_k, feature_counts = counted_run(kernels, lambda: extract_features(ref_v, dis_v, device=dev))
    feats_p, t_p = wall_s(lambda: extract_features(ref_v, dis_v, impl="plain", device=dev))
    n_chunks = -(-API_PAIRS // chunk)
    check_launches("api extract_features", feature_counts, {}, {
        "vif_scale_cuda": 4 * n_chunks, "adm_scale_cuda": n_chunks, "adm_tail_cuda": n_chunks,
        **{f"vif_scale_cuda[scale{k}]": n_chunks for k in range(4)}})
    rels = {}
    for key in (*FRAME_KEYS, "motion", "motion2"):
        rtol = API_MOTION_RTOL if key.startswith("motion") else API_VQ_RTOL
        a, b = torch.from_numpy(feats_k[key]), torch.from_numpy(feats_p[key])
        if a.shape != (API_PAIRS,):
            raise AssertionError(f"api extract_features {key}: shape {tuple(a.shape)}")
        check_close(f"api extract_features {key}", a, b, rtol=rtol)
        rels[key] = float(f"{max_rel(a, b):.3g}")
    again = extract_features(ref_v, dis_v, chunk=API_PAIRS // 4, device=dev)
    for key, value in feats_k.items():
        if not np.array_equal(again[key], value):
            raise AssertionError(f"api extract_features {key}: chunk {API_PAIRS // 4} differs from chunk {chunk}")
    (score_k, details), t_vmaf = wall_s(lambda: compute_vmaf(ref_v, dis_v, return_details=True, device=dev))
    score_p = float(builtin_model().predict(feats_p).numpy().mean())
    if not (np.isfinite(score_k) and abs(score_k - score_p) <= API_VMAF_ATOL):
        raise AssertionError(f"api compute_vmaf: kernel route {score_k} vs plain {score_p}")
    mem = {impl: peak_gib(lambda impl=impl: extract_features(ref_v, dis_v, impl=impl, device=dev))
           for impl in ("kernel", "plain")}
    budget = torch.cuda.get_device_properties(dev).total_memory / MEMORY_SHARE / 2**30
    if mem["kernel"] > budget:
        raise AssertionError(f"api extract_features: peak {mem['kernel']:.2f} GiB over the chunk budget "
                             f"{budget:.2f} GiB")
    per_px = {}
    ry, dy = (torch.from_numpy(a[0][:8]).to(dev) for a in (ref_np, dis_np))
    for impl in ("kernel", "plain"):
        for b in (2, 8):
            per_px[f"{impl} {b}"] = round(feature_peak_bytes(dev, ry[:b], dy[:b], impl) / (b * H * W), 2)
    del ry, dy
    print(f"api extract_features: {API_PAIRS}x{H}x{W} pairs, default chunk {chunk} ({n_chunks} chunks): kernel "
          f"route {t_k:.4f} s, plain route {t_p:.4f} s; peak {mem['kernel']:.2f} GiB vs {mem['plain']:.2f} GiB "
          f"(budget {budget:.2f} GiB); peak bytes per pixel over a chunk's inputs {json.dumps(per_px)}; max rel "
          f"vs plain {json.dumps(rels)}; chunk {API_PAIRS // 4} equal; launches {feature_counts}; compute_vmaf "
          f"{score_k!r} in {t_vmaf:.4f} s (plain features {score_p!r}, model {details['model']})")
    profile_device("api extract_features, kernel route", lambda: extract_features(ref_v, dis_v, device=dev))
    profile_device("api extract_features, plain route",
                   lambda: extract_features(ref_v, dis_v, impl="plain", device=dev))

    # orb_features on ORB_FRAMES 1080p frames, the card against the CPU.
    g = corner_gray(ORB_FRAMES, H, W, SEED + 40)
    want = orb_features(g, k=ORB_K)
    got, t_orb = wall_s(lambda: orb_features(g.to(dev), k=ORB_K))
    got = {k: v.cpu() for k, v in got.items()}
    for key in ("ys", "xs", "valid", "fast_score", "score"):
        if not torch.equal(got[key], want[key]):
            raise AssertionError(f"api orb_features {key}: card differs from the CPU")
    angle_err = max_abs(got["angle"], want["angle"])
    bits = int((got["desc"] != want["desc"]).sum())
    if not angle_err <= ORB_ANGLE_ATOL or bits > ORB_DESC_BITS:
        raise AssertionError(f"api orb_features: angle err {angle_err}, {bits} descriptor bits differ")
    print(f"api orb_features: {tuple(g.shape)}, K {ORB_K}: {int(want['valid'].sum())} valid keypoints; ys, xs, "
          f"valid, fast_score and score equal to the CPU's, angle max abs err {angle_err:.3g}, {bits} of "
          f"{got['desc'].numel()} descriptor bits differ; card {t_orb:.4f} s")
    return feature_counts


def sharded_quality_run(mesh, ref_np, dis_np, chunk: int):
    """``analyze_full_reference_sharded``'s loop after opening the streams:
    rank 0 reads prefetched batches of the in-memory pairs, scatters each
    chunk and every rank runs the sharded chunk step. Returns (series,
    pooled) on rank 0, (None, None) elsewhere."""
    import torch.distributed as dist

    from rtvqa_tpu_torch.io.stream import prefetch, stage_to_device
    from rtvqa_tpu_torch.metrics.full_reference import pool_full_reference
    from rtvqa_tpu_torch.parallel.sharding import sharded_quality_chunk_step
    from rtvqa_tpu_torch.pipeline.quality_sharded import sharded_quality_loop

    def open_pair(stage):
        its = [prefetch(stage_to_device(frame_batches(p, chunk), chunk, stage), depth=1)
               for p in (ref_np, dis_np)]
        return (chunk, *its)

    rank0 = dist.get_rank() == 0
    series, n = sharded_quality_loop(mesh, sharded_quality_chunk_step(mesh), open_pair if rank0 else None)
    return series, (pool_full_reference(series, n) if rank0 else None)


def sharded_clips(y, u, v, mesh):
    """This rank's block of the suite's N frames as SHARDED_CLIPS clips of
    N / SHARDED_CLIPS frames, 333.3 ms apart: (y, u, v, ts, n_valid) on its
    device."""
    c_all, per = SHARDED_CLIPS, N // SHARDED_CLIPS
    n_clip, n_frame = mesh.shape
    cl, fl = c_all // n_clip, per // n_frame
    c0, f0 = mesh.rank("clip") * cl, mesh.rank("frame") * fl
    ts = np.tile((np.arange(per) * 333.3).astype(np.float32), c_all)

    def block(a):
        a = a.reshape(c_all, per, *a.shape[1:])[c0:c0 + cl, f0:f0 + fl]
        return torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device)

    return (*(block(a) for a in (y, u, v, ts)), torch.full((cl,), per))


def sharded_complexity_run(mesh, y, u, v):
    """The sharded suite over the SHARDED_CLIPS clips: (C, 8) values in
    METRIC_ORDER on every rank."""
    from rtvqa_tpu_torch.metrics.complexity import METRIC_ORDER
    from rtvqa_tpu_torch.parallel.sharding import sharded_complexity_suite

    fn = sharded_complexity_suite(mesh, resize_h=64, resize_w=64, block=BLOCK, radius=RADIUS)
    out = fn(*sharded_clips(y, u, v, mesh))
    return torch.stack([out[k] for k in METRIC_ORDER], 1).cpu().numpy()


def check_complexity(label, got, want) -> dict:
    """(C, 8) values against per-clip results within the suite's
    tolerances (motion MOTION_RTOL, every other metric SUITE_RTOL, edge
    included, as phase_suite holds them); returns the max rel per metric."""
    from rtvqa_tpu_torch.metrics.complexity import METRIC_ORDER

    worst = {}
    for j, key in enumerate(METRIC_ORDER):
        tol = MOTION_RTOL if key == "motion" else SUITE_RTOL
        for c in range(got.shape[0]):
            a, b = float(got[c, j]), float(want[c, j])
            if not (np.isfinite(a) and abs(a - b) <= tol * max(abs(b), 1e-12)):
                raise AssertionError(f"{label} clip {c} {key}: {a} vs {b}")
            worst[key] = max(worst.get(key, 0.0), abs(a - b) / max(abs(b), 1e-12))
    return worst


def _sharded_world2(seed: int) -> dict:
    """One rank of the world-2 run (gloo, both ranks on cuda:0): the quality
    loop on a 1 x 2 mesh, rank 0 holding the frames, then the suite on 2 x 1
    and 1 x 2 meshes; every rank checks that its kernels launched."""
    import torch.distributed as dist

    from rtvqa_tpu_torch.parallel.launch import init_from_env
    from rtvqa_tpu_torch.parallel.sharding import make_mesh

    dev = init_from_env("cuda")
    rank0 = dist.get_rank() == 0
    y, u, v = make_frames(N, H, W, seed)
    ref_np, dis_np = (y, u, v), (distort((y, u, v), seed + 3) if rank0 else None)
    chunk = 64
    mesh = make_mesh(1, 2, device=dev)
    (series, pooled), t_q, launches = counted_run(
        quality_kernels(), lambda: sharded_quality_run(mesh, ref_np, dis_np, chunk))
    check_launches(f"sharded world 2 quality, rank {dist.get_rank()}", launches,
                   {k: 1 for k in ("quality_fused_cuda", "vif_tail_cuda", "adm_scale_cuda", "adm_tail_cuda")})
    out = {"series": series, "pooled": pooled, "quality_s": t_q, "launches": {"quality": launches}}
    for shape in ((2, 1), (1, 2)):
        m = make_mesh(*shape, device=dev)
        vals, t_c, counts = counted_run(quality_kernels(), lambda m=m: sharded_complexity_run(m, y, u, v))
        check_launches(f"sharded world 2 complexity {shape}, rank {dist.get_rank()}", counts,
                       {"yuv420_to_gray_cuda": 1, "block_match_motion_cuda": 1})
        out[f"complexity {shape[0]}x{shape[1]}"] = vals
        out[f"complexity_s {shape[0]}x{shape[1]}"] = t_c
    return out if rank0 else {k: out[k] for k in out if k not in ("series", "pooled")}


def phase_sharded(dev, ref_np, dis_np, series, pooled, smi) -> None:
    """The multi-device paths at 1080p. World 1 on NCCL in this process: the
    sharded quality loop over the N pairs at chunk 64 (bit for bit the
    single-device kernel loop's series and pooled values; kernels 3, 5, 6
    and 7), and the sharded suite on a 1 x 1 mesh over SHARDED_CLIPS clips
    of the suite's frames against ``calculate_average_scene_complexity``
    per clip (kernels 1 and 2). World 2 on gloo, both ranks on this card
    (spawned): the same loop on a 1 x 2 mesh against world 1, and the suite
    on 2 x 1 and 1 x 2 meshes. World 2 checks the halo, scatter and
    lockstep logic on the real kernels; its walls are no speed figure (two
    processes share one card and gloo stages through the host)."""
    import torch.distributed as dist

    from rtvqa_tpu_torch.io.video import DecodedClip
    from rtvqa_tpu_torch.metrics.complexity import METRIC_ORDER, calculate_average_scene_complexity
    from rtvqa_tpu_torch.metrics.full_reference import CHUNK_KEYS
    from rtvqa_tpu_torch.parallel.launch import spawn, world
    from rtvqa_tpu_torch.parallel.sharding import make_mesh

    chunk, per = 64, N // SHARDED_CLIPS
    y, u, v = ref_np  # the suite's frames
    with world("cuda") as dev1:
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            raise AssertionError(f"world 1: backend {dist.get_backend()}, size {dist.get_world_size()}")
        mesh = make_mesh(1, 1, device=dev1)
        sharded_quality_run(mesh, ref_np, dis_np, chunk)  # warm-up
        (s_sh, pool_sh), t_sh, launches = counted_run(
            quality_kernels(), lambda: sharded_quality_run(mesh, ref_np, dis_np, chunk))
        _, t_single = wall_s(lambda: run_loop(dev, ref_np, dis_np, chunk, "kernel"))
        check_launches("sharded world 1 quality", launches,
                       {k: 1 for k in ("quality_fused_cuda", "vif_tail_cuda", "adm_scale_cuda", "adm_tail_cuda")})
        for key in CHUNK_KEYS:
            if not np.array_equal(s_sh[key], series[key]):
                raise AssertionError(f"sharded world 1 series {key} differs from the single-device loop's")
        for key in ("psnr", "ssim", "vmaf"):
            if pool_sh[key] != pooled[key]:
                raise AssertionError(f"sharded world 1 pooled {key}: {pool_sh[key]} vs {pooled[key]}")
        print(f"sharded world 1 (NCCL) quality: {N}x{H}x{W} pairs in chunks of {chunk}: {t_sh:.4f} s, "
              f"single-device loop {t_single:.4f} s ({smi}); series and pooled values bit for bit the "
              f"single-device loop's; launches {launches}")

        sharded_complexity_run(mesh, y, u, v)  # warm-up
        c1, t_c1, counts = counted_run(quality_kernels(), lambda: sharded_complexity_run(mesh, y, u, v))
        check_launches("sharded world 1 complexity", counts,
                       {"yuv420_to_gray_cuda": 1, "block_match_motion_cuda": 1})

        def per_clip():
            res = []
            for c in range(SHARDED_CLIPS):
                sl = slice(c * per, (c + 1) * per)
                clip = DecodedClip(y=y[sl], u=u[sl], v=v[sl], timestamps_ms=np.arange(per) * 333.3,
                                   width=W, height=H, n_frames_total=per, bit_rate=0, avg_fps=3.0)
                r = calculate_average_scene_complexity(clip, 64, 64, device=dev)
                res.append([getattr(r, k) for k in METRIC_ORDER])
            return np.array(res)

        single, t_c_single = wall_s(per_clip)
        worst = check_complexity("sharded world 1 complexity", c1, single)
        print(f"sharded world 1 (NCCL) complexity: {SHARDED_CLIPS} clips x {per} frames on a 1 x 1 mesh "
              f"{t_c1:.4f} s, per-clip suite {t_c_single:.4f} s ({smi}); launches {counts}; max rel "
              f"vs the per-clip suite {json.dumps(worst)}")

    t0 = time.perf_counter()
    ranks = spawn(_sharded_world2, 2, "gloo", "cuda", SEED, timeout=SHARDED_TIMEOUT_S)
    t_w2 = time.perf_counter() - t0
    s2, pool2 = ranks[0]["series"], ranks[0]["pooled"]
    boundary = np.zeros(N, bool)
    boundary[chunk // 2::chunk] = True      # each chunk's first frame on frame rank 1
    diffs = {}
    for key in CHUNK_KEYS:
        a, b = s2[key], s_sh[key]
        if a.shape != (N,) or not np.isfinite(a).all():
            raise AssertionError(f"sharded world 2 series {key}: shape {a.shape}")
        if key == "motion_sad":
            check_close("sharded world 2 boundary SADs", torch.from_numpy(a[boundary]),
                        torch.from_numpy(b[boundary]), rtol=1e-4)
            a, b = a[~boundary], b[~boundary]
        check_close(f"sharded world 2 series {key}", torch.from_numpy(a), torch.from_numpy(b), 2e-4, 2e-4)
        diffs[key] = max_abs(torch.from_numpy(s2[key]), torch.from_numpy(s_sh[key]))
    for key in ("psnr", "ssim", "vmaf"):
        if not abs(pool2[key] - pool_sh[key]) <= 2e-4 + 2e-4 * abs(pool_sh[key]):
            raise AssertionError(f"sharded world 2 pooled {key}: {pool2[key]} vs {pool_sh[key]}")
    comp = {}
    for shape in ("2x1", "1x2"):
        for r, rec in enumerate(ranks):
            comp[f"{shape} rank {r}"] = check_complexity(f"sharded world 2 complexity {shape} rank {r}",
                                                         rec[f"complexity {shape}"], c1)
    print(f"sharded world 2 (gloo, both ranks on one card; checks the halo and lockstep logic, not speed): "
          f"quality on a 1 x 2 mesh, {N} pairs in chunks of {chunk}: max abs vs world 1 "
          f"{json.dumps(diffs)}; boundary SADs within rel 1e-4; pooled psnr {pool2['psnr']:.6f} ssim "
          f"{pool2['ssim']:.6f} vmaf {pool2['vmaf']:.6f}; complexity on 2 x 1 and 1 x 2 meshes, max rel "
          f"vs world 1 {json.dumps(comp)}; walls rank 0: quality {ranks[0]['quality_s']:.4f} s, "
          f"complexity 2x1 {ranks[0]['complexity_s 2x1']:.4f} s, 1x2 {ranks[0]['complexity_s 1x2']:.4f} s; "
          f"the spawned world {t_w2:.2f} s ({smi})")


def first_frames(clip, n: int):
    """``clip``'s first ``n`` frames."""
    import dataclasses

    return dataclasses.replace(clip, y=clip.y[:n], u=clip.u[:n], v=clip.v[:n],
                               timestamps_ms=clip.timestamps_ms[:n], n_frames_total=n)


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
    launches, suite_res = phase_suite(dev, y_np, u_np, v_np)
    gray_rec["launches"] = launches["yuv420_to_gray_cuda"]
    motion_rec["launches"] = launches["block_match_motion_cuda"]

    from rtvqa_tpu_torch.metrics.full_reference import auto_chunk

    ref_np = (y_np, u_np, v_np)
    dis_np = distort(ref_np, SEED + 3)
    first = slice(0, auto_chunk(W, H))
    quality_recs = phase_quality_kernels(dev, [a[first] for a in ref_np], [a[first] for a in dis_np])
    torch.cuda.empty_cache()
    phase_quality_content(dev, first.stop, quality_recs)
    phase_quality_oracle(dev)
    phase_float64_oracle(dev, y_np, u_np, v_np)
    torch.cuda.empty_cache()
    launches, series, pooled = phase_quality(dev, ref_np, dis_np)
    for rec, wrapper in zip(quality_recs, ("quality_fused_cuda", "vif_tail_cuda",
                                           "adm_scale_cuda", "adm_tail_cuda")):
        rec["launches"] = launches[wrapper]
    torch.cuda.empty_cache()
    phase_combined(dev, ref_np, dis_np, series)
    torch.cuda.empty_cache()
    phase_trace(dev, ref_np, dis_np, series)
    torch.cuda.empty_cache()
    probe_recs = phase_probes(dev, ref_np[0][first], dis_np[0][first])
    torch.cuda.empty_cache()
    feature_counts = phase_api(dev, ref_np, dis_np, suite_res, series, pooled)
    torch.cuda.empty_cache()
    phase_sharded(dev, ref_np, dis_np, series, pooled, smi)
    torch.cuda.empty_cache()

    wide_ref = make_frames(WIDE_N, WIDE_H, WIDE_W, SEED + 7)
    wide_dis = distort(wide_ref, SEED + 8)
    wide_chunk = slice(0, auto_chunk(WIDE_W, WIDE_H))
    vif_recs = phase_vif_scale(dev, [a[wide_chunk] for a in wide_ref], [a[wide_chunk] for a in wide_dis],
                               [a[first] for a in ref_np], [a[first] for a in dis_np])
    vif_recs[0]["launches"] = feature_counts["vif_scale_cuda[scale0]"]
    vif_recs[1]["launches"] = sum(feature_counts[f"vif_scale_cuda[scale{k}]"] for k in (1, 2, 3))
    del y_np, u_np, v_np, ref_np, dis_np
    phase_wide_quality(dev, wide_ref, wide_dis)
    print(smi)
    print(json.dumps({"kernels": [gray_rec, motion_rec, *quality_recs, *vif_recs, *probe_recs]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
