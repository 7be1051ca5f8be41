"""One run of one cell: set-up, warm-up, the measured window, the check,
and the result.

The window opens after warm-up and closes at the end of the clip in flight
when ``seconds`` have passed; every clip and frame of the window counts
against that whole time. With ``trace``, a profiled stretch of whole clips
(at least ``PROFILE_SECONDS``) whose spans are profiler ranges only comes
first, then the window, whose spans are timed; the answers of both are
checked.
"""

from __future__ import annotations

import dataclasses
import gc
import statistics
import sys
import time

import torch

from . import check, entry, frames, profile, spans, traffic
from .spec import Cell, metric_reader

PROFILE_SECONDS = 3.0
WARM_CHUNKS = 4
FORBIDDEN = ("jax", "jaxlib", "flax", "rtvqa_tpu")


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    answers: list         # the window's clips, in order
    window_s: float
    setup_s: float
    peak_bytes: int
    height: int
    width: int
    trace: dict | None    # the traced part: counters, span totals, device profile


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def first_clip_ratios(answers: list) -> list[tuple[float, int]]:
    """For each clip length dealt more than once, the seconds of its first
    clip over the median of its later ones, with the length: above 1 where
    a first clip still paid for something the warm-up left cold."""
    by_len = {}
    for a in answers:
        by_len.setdefault(a.clip.frames, []).append(a.seconds)
    return sorted((s[0] / statistics.median(s[1:]), n) for n, s in by_len.items() if len(s) > 1)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float,
        prog=None) -> dict:
    cuda = device.type == "cuda"
    parts = {"start_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    prog = prog or entry.Program()
    cfg = prog.config(cell.config)
    if cuda:
        torch.cuda.init()
        prog.build()
    parts["import_build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    pool = frames.make_pool(cell.config, cell.traffic, seed, device)
    parts["pool_s"] = time.perf_counter() - t
    h, w = pool.ref[0].shape[1:]
    chunk = prog.full_reference.auto_chunk(w, h)
    t = time.perf_counter()
    # A few chunks and one flush of the accumulator's batch of sampled frames.
    cover = max(WARM_CHUNKS * chunk, cfg.batch_size * cfg.frame_interval + chunk)
    for clip in traffic.warmup_clips(cell.traffic, cover):
        entry.analyze_clip(prog, cfg, pool, clip, device)
    if cuda:
        torch.cuda.synchronize()
    parts["warmup_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    log("setup " + " ".join(f"{k} {v:.3f}" for k, v in parts.items()) + f" total {setup_s:.3f} s")

    answers, prof, tracer = [], None, None
    clips = traffic.clips(cell.traffic, seed, pool.frames, chunk)
    if trace:
        tracer = spans.Tracer(prog, cuda)
        tracer.install()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]
                                    + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])) as prof:
            t_stretch = time.perf_counter()
            with torch.profiler.record_function("bench.stretch"):
                while True:
                    answers.append(entry.analyze_clip(prog, cfg, pool, next(clips), device, tracer))
                    if time.perf_counter() - t_stretch >= PROFILE_SECONDS:
                        break
            if cuda:
                torch.cuda.synchronize()
        tracer.timing = True
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_open = time.perf_counter()
    n_profiled = len(answers)
    while time.perf_counter() - t_open < seconds:
        answers.append(entry.analyze_clip(prog, cfg, pool, next(clips), device, tracer))
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t_open
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    log(f"window: {len(answers) - n_profiled} clips, {sum(a.clip.frames for a in answers[n_profiled:])} frames "
        f"in {window_s:.3f} s; peak allocated {peak} B, peak reserved "
        f"{torch.cuda.max_memory_reserved() if cuda else 0} B")
    ratios = first_clip_ratios(answers[n_profiled:])
    if ratios:
        log(f"first clip of each length over its later median: median "
            f"{statistics.median(r for r, _ in ratios):.4f}, max {ratios[-1][0]:.4f} (length {ratios[-1][1]}; "
            f"{len(ratios)} lengths)")

    traced = None
    if trace:
        tracer.uninstall()
        timed = answers[n_profiled:]
        traced = {
            "frames": sum(a.clip.frames for a in timed), "clips": len(timed),
            "chunks": tracer.counts["chunks"], "h2d_bytes": tracer.counts["h2d_bytes"],
            "staging_wait_s": tracer.totals["staging_wait_s"],
            "complexity_s": tracer.totals["complexity_s"], "pool_s": tracer.totals["pool_s"],
            "stretch_frames": sum(a.clip.frames for a in answers[:n_profiled]),
            "device": profile.read_profile(prof) if cuda else None,
        }
        if traced["device"]:
            d = traced["device"]
            log(f"stretch: {d['window_s']:.3f} s, {traced['stretch_frames']} frames, device busy "
                f"{d['busy_s']:.4f} s, quality {d['quality_s']:.4f} s from {d['quality_launches']} launches")
        prof = tracer = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    record = Run(answers, window_s, setup_s, peak, h, w, traced)

    t = time.perf_counter()
    verdict = check.run_check(pool, answers, cell.config, cell.limits, seed, device, chunk)
    log(f"check: {verdict['sampled_frames']} frames and {verdict['sampled_slots']} slots "
        f"recomputed in {time.perf_counter() - t:.3f} s")

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = metric_reader(m["name"], cell.bench_dir)(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": verdict["correct"], "attempted": len(answers), "failed": verdict["failed"],
           "metrics": metrics, "device": dev}
    if trace and traced["device"]:
        dev["busy_s"] = traced["device"]["busy_s"]
        dev["window_s"] = traced["device"]["window_s"]
        out["breakdown"] = {k: traced["device"][k] for k in ("device_ops", "idle_gaps")}
    out["checks"] = {k: {"value": verdict["numbers"][k], "limit": cell.limits[k]} for k in check.NUMBERS}
    return out
