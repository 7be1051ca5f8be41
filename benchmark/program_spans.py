"""One cell driven with the program's own tracer active
(``rtvqa_tpu_torch/obs/profiler.py``): the numbers the benchmark will read
from the program's spans and counters once ``harness/bench.py`` activates
that tracer in its traced run, the cost of tracing, and where the profiler's
trace loses copies.

    python3 benchmark/program_spans.py --workload <cell> --seed <n> --seconds <s>

Set-up and warm-up as ``harness/bench.py`` runs them, then four closed-loop
windows of ``--seconds`` each through ``harness/entry.py``, the program's
tracer off, on, on, off, then a
profiled stretch of whole clips (at least ``PROFILE_SECONDS``, tracer on)
under ``torch.profiler``, then the harness's check of every answer. Prints
one JSON line:

* ``windows``: each window's tracer state, clips, frames and frames/s;
  ``tracing_cost``: 1 − (median rate on) / (median rate off);
* ``metrics``, over the tracer-on windows: ``fetch_wait_ms`` (``fetch``
  seconds per chunk), ``stage_ms_per_chunk`` (``stage`` seconds on both
  producer threads per lockstep chunk), ``pad_ms_per_clip``,
  ``padded_frame_pct`` (``padded_frames`` over frames + ``padded_frames``)
  beside ``padded_frame_pct_host`` (the same from the dealt clips' lengths),
  ``h2d_bytes_per_frame``; from the stretch, ``idle_untraced_ms_per_frame``
  (device idle in gaps where the main thread was in no span or in
  ``rtvqa.clip`` alone, per stretch frame) and ``device_idle_pct``;
* ``spans``: seconds and calls per span name, and ``counters``, over the
  tracer-on windows;
* ``breakdown``: the stretch's ten busiest device operations and ten longest
  device gaps, each gap named by the main thread's innermost ``rtvqa.*``
  range at its middle (``loop``: none);
* ``copies``: the stretch's ``Memcpy HtoD`` events in the trace against the
  program's ``h2d_copies`` (those on the producer threads: 3 per
  ``staged_chunks``), and the runtime calls that issued them per thread;
* ``span_cost``: host microseconds per span site with the tracer off and
  on, and ``spans_per_clip`` over the tracer-on windows;
* on the card, ``copy_probe``: 64 pinned host-to-device copies each from
  the main thread, from a thread started inside the profile and from one
  started before it, and how many of each the exported trace and
  ``key_averages()`` hold; ``host_probe``: how long the main thread waits
  while another thread pins or uploads one UHD chunk's luma plane.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import tempfile
import threading
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark.harness import bench, check, entry, frames, profile, spec, traffic  # noqa: E402

PROFILE_SECONDS = 3.0
WINDOWS = 4
UNTRACED = ("loop", "clip")


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def window(prog, cfg, pool, clips, device, seconds: float) -> tuple[list, float]:
    answers, t0 = [], time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        answers.append(entry.analyze_clip(prog, cfg, pool, next(clips), device))
    sync(device)
    return answers, time.perf_counter() - t0


def trace_events(prof) -> list:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])


def named_gaps(events: list) -> dict:
    """The stretch's device gaps, each named by the main thread's innermost
    ``rtvqa.*`` range at its middle; the idle seconds of the untraced ones,
    by the innermost operator or runtime call of the main thread at their
    middle (``python``: none)."""
    stretch = next(e for e in events if e.get("name") == "bench.stretch" and e.get("ph") == "X")
    s0, s1, main = float(stretch["ts"]), float(stretch["ts"]) + float(stretch["dur"]), stretch.get("tid")
    dev = [(max(float(e["ts"]), s0), min(float(e["ts"]) + float(e.get("dur", 0.0)), s1)) for e in events
           if e.get("ph") == "X" and e.get("cat") in profile.DEVICE_CATS]
    busy = profile._union([(a, b) for a, b in dev if b > a])
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][len("rtvqa."):]) for e in events
              if e.get("ph") == "X" and e.get("tid") == main and str(e.get("name", "")).startswith("rtvqa.")]
    ops = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
           if e.get("ph") == "X" and e.get("tid") == main and e.get("cat") in ("cpu_op",) + profile.LAUNCH_CATS]
    gaps, untraced_ops, prev = [], {}, s0
    for a, b in busy + [[s1, s1]]:
        if a > prev:
            mid = (prev + a) / 2
            inside = [(e - s, name) for s, e, name in ranges if s <= mid <= e]
            gaps.append((min(inside)[1] if inside else "loop", (a - prev) / 1e6))
            if gaps[-1][0] in UNTRACED:
                op = min([(e - s, name) for s, e, name in ops if s <= mid <= e], default=(0, "python"))[1]
                untraced_ops[op] = untraced_ops.get(op, 0.0) + (a - prev) / 1e6
        prev = max(prev, b)
    by_name = {}
    for name, s in gaps:
        by_name[name] = by_name.get(name, 0.0) + s
    return {"gaps": sorted(gaps, key=lambda g: -g[1])[:profile.TOP],
            "idle_by_name_s": dict(sorted(by_name.items(), key=lambda kv: -kv[1])),
            "untraced_s": sum(s for n, s in gaps if n in UNTRACED),
            "untraced_by_op_s": dict(sorted(untraced_ops.items(), key=lambda kv: -kv[1])[:profile.TOP])}


def copy_counts(events: list, main_tid) -> dict:
    """The trace's host-to-device copies, by the thread whose runtime call
    issued them (linked by correlation id) and by size (1 MiB and up: the
    program's planes and tables; smaller: kernels' arguments)."""
    issued_by = {(e.get("args") or {}).get("correlation"): ("main" if e.get("tid") == main_tid else "other")
                 for e in events if e.get("ph") == "X" and e.get("cat") in profile.LAUNCH_CATS}
    out = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", ""):
            args = e.get("args") or {}
            size = "large" if float(args.get("bytes", 0)) >= 1 << 20 else "small"
            key = f"{issued_by.get(args.get('correlation'), 'unlinked')}_{size}"
            out[key] = out.get(key, 0) + 1
    return {"trace_htod": dict(sorted(out.items()))}


def copy_probe(device, k: int = 64, nbytes: int = 8 << 20) -> dict:
    """``k`` pinned host-to-device copies from the main thread, from a
    thread started inside the profile and from one started before it, each
    case in a profile of its own: how many the exported trace holds, and
    how many ``key_averages()`` counts (its events are the operators the
    profiler recorded, on the threads it follows, with their device work)."""
    src = torch.empty(nbytes, dtype=torch.uint8).pin_memory()

    def copies():
        for _ in range(k):
            src.to(device, non_blocking=True)
        torch.cuda.synchronize()

    out = {}
    for case in ("main", "thread_started_inside", "thread_started_before"):
        go = threading.Event()
        early = threading.Thread(target=lambda: (go.wait(), copies()))
        early.start()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            if case == "main":
                copies()
            elif case == "thread_started_inside":
                t = threading.Thread(target=copies)
                t.start()
                t.join()
            else:
                go.set()
                early.join()
            torch.cuda.synchronize()
        go.set()
        early.join()
        in_trace = sum(1 for e in trace_events(prof) if e.get("ph") == "X" and e.get("cat") == "gpu_memcpy"
                       and "HtoD" in e.get("name", ""))
        averaged = sum(e.count for e in prof.key_averages() if "HtoD" in e.key)
        out[case] = {"issued": k, "in_trace": in_trace, "in_key_averages": averaged}
    return out


def host_probe(upload, device, reps: int = 8) -> dict:
    """Whether a producer thread's staging holds up the main thread: while
    another thread runs ``op`` ``reps`` times on one UHD chunk's luma plane
    (16 x 2160 x 3840 u8), the main thread spins on the clock. Per op: its
    milliseconds, and the main thread's longest wait between two clock
    reads and its reads per second (``sleep``: the thread sleeps as long)."""
    import numpy as np

    plane = np.random.default_rng(0).integers(0, 256, (16, 2160, 3840), np.uint8)
    ops = {"pin": lambda: torch.from_numpy(plane).pin_memory(),
           "upload": lambda: (upload(plane, device), torch.cuda.synchronize())}
    took = {}
    out = {}
    for name in ("pin", "upload", "sleep"):
        done = threading.Event()

        def producer():
            t0 = time.perf_counter()
            for _ in range(reps):
                ops[name]() if name != "sleep" else time.sleep(took["upload"] / 1e3)
            took[name] = 1e3 * (time.perf_counter() - t0) / reps
            done.set()

        t = threading.Thread(target=producer)
        longest, reads, last = 0.0, 0, time.perf_counter()
        t0 = last
        t.start()
        while not done.is_set():
            now = time.perf_counter()
            longest, last, reads = max(longest, now - last), now, reads + 1
        t.join()
        out[name] = {"op_ms": took[name], "main_longest_wait_ms": 1e3 * longest,
                     "main_reads_per_s": reads / (time.perf_counter() - t0)}
    return out


def span_cost(profiler, n: int = 200_000) -> dict:
    """Host microseconds per span site, tracer off and on (no profiler)."""
    out = {}
    for on in (False, True):
        timer = profiler.StageTimer()
        with timer.active() if on else contextlib.nullcontext():
            t0 = time.perf_counter()
            for _ in range(n):
                with profiler.span("x"):
                    pass
            out["on_us" if on else "off_us"] = 1e6 * (time.perf_counter() - t0) / n
    return out


def run(cell, seed: int, seconds: float, device) -> dict:
    """Everything the module docstring lists, for ``cell`` on ``device``
    (the CPU only in the tests: no device trace there)."""
    from rtvqa_tpu_torch.obs import profiler

    prog = entry.Program()
    cfg = prog.config(cell.config)
    if device.type == "cuda":
        prog.build()
    pool = frames.make_pool(cell.config, cell.traffic, seed, device)
    h, w = pool.ref[0].shape[1:]
    chunk = prog.full_reference.auto_chunk(w, h)
    cover = max(bench.WARM_CHUNKS * chunk, cfg.batch_size * cfg.frame_interval + chunk)
    for c in traffic.warmup_clips(cell.traffic, cover):
        entry.analyze_clip(prog, cfg, pool, c, device)
    sync(device)
    bench.log(f"setup {time.perf_counter() - T_START:.3f} s")

    clips = traffic.clips(cell.traffic, seed, pool.frames, chunk)
    timer, answers, wins = profiler.StageTimer(), [], []
    on_spans, on_counts, on = {}, {}, {"clips": 0, "frames": 0, "padded_host": 0, "chunks": 0}
    for i in range(WINDOWS):
        traced = i in (1, 2)
        timer.reset()
        with timer.active() if traced else contextlib.nullcontext():
            got, secs = window(prog, cfg, pool, clips, device, seconds)
        n = sum(a.clip.frames for a in got)
        wins.append({"traced": traced, "clips": len(got), "frames": n, "seconds": secs, "frames_per_s": n / secs})
        answers += got
        if traced:
            for name, t in timer.span_totals().items():
                s = on_spans.setdefault(name, {"seconds": 0.0, "calls": 0})
                s["seconds"] += t["seconds"]
                s["calls"] += t["calls"]
            for name, v in timer.counters.items():
                on_counts[name] = on_counts.get(name, 0) + v
            on["clips"] += len(got)
            on["frames"] += n
            on["padded_host"] += sum(-a.clip.frames % chunk for a in got)
            on["chunks"] += sum(-(-a.clip.frames // chunk) for a in got)
        bench.log(f"window {i} traced {traced}: {wins[-1]['frames_per_s']:.2f} frames/s")

    timer.reset()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with timer.active(), torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        stretch = []
        with torch.profiler.record_function("bench.stretch"):
            while time.perf_counter() - t0 < PROFILE_SECONDS:
                stretch.append(entry.analyze_clip(prog, cfg, pool, next(clips), device))
        sync(device)
    answers += stretch
    stretch_counts = dict(timer.counters)
    stretch_frames = sum(a.clip.frames for a in stretch)
    events = trace_events(prof)
    device_summary = profile.summarize(events)
    gaps = named_gaps(events) if device_summary else None
    main_tid = next(e.get("tid") for e in events if e.get("name") == "bench.stretch")
    copies = copy_counts(events, main_tid)
    copies.update(program_h2d_copies=stretch_counts.get("h2d_copies", 0),
                  program_producer_copies=3 * stretch_counts.get("staged_chunks", 0),
                  program_suite_builds=stretch_counts.get("suite_builds", 0))

    verdict = check.run_check(pool, answers, cell.config, cell.limits, seed, device, chunk)
    rate = {t: statistics.median(x["frames_per_s"] for x in wins if x["traced"] == t) for t in (False, True)
            if any(x["traced"] == t for x in wins)}
    padded = on_counts.get("padded_frames", 0)
    chunks = on_spans.get("fetch", {}).get("calls", 0)
    metrics = {
        "fetch_wait_ms": 1e3 * on_spans.get("fetch", {}).get("seconds", 0.0) / max(chunks, 1),
        "stage_ms_per_chunk": 1e3 * on_spans.get("stage", {}).get("seconds", 0.0) / max(chunks, 1),
        "pad_ms_per_clip": 1e3 * on_spans.get("pad", {}).get("seconds", 0.0) / max(on["clips"], 1),
        "padded_frame_pct": 100.0 * padded / max(on["frames"] + padded, 1),
        "padded_frame_pct_host": 100.0 * on["padded_host"] / max(on["frames"] + on["padded_host"], 1),
        "h2d_bytes_per_frame": on_counts.get("h2d_bytes", 0) / max(on["frames"], 1),
        "idle_untraced_ms_per_frame": 1e3 * gaps["untraced_s"] / max(stretch_frames, 1) if gaps else None,
        "device_idle_pct": 100.0 * (1 - device_summary["busy_s"] / device_summary["window_s"])
        if device_summary else None,
    }
    out = {
        "workload": cell.name, "seed": seed, "correct": verdict["correct"],
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
        "chunk": chunk, "windows": wins,
        "tracing_cost": (1 - rate[True] / rate[False]) if len(rate) == 2 else None,
        "metrics": metrics, "lockstep_chunks": {"fetch_calls": chunks, "from_lengths": on["chunks"]},
        "spans": on_spans, "counters": on_counts,
        "stretch": {"frames": stretch_frames, "clips": len(stretch),
                    **({"busy_s": device_summary["busy_s"], "window_s": device_summary["window_s"],
                        "idle_by_name_s": gaps["idle_by_name_s"],
                        "untraced_by_op_s": gaps["untraced_by_op_s"]} if gaps else {})},
        "breakdown": {"device_ops": device_summary["device_ops"], "idle_gaps": gaps["gaps"]} if gaps else None,
        "copies": copies,
        "span_cost": span_cost(profiler),
        "spans_per_clip": sum(t["calls"] for t in on_spans.values()) / max(on["clips"], 1),
        "checks": {k: verdict["numbers"][k] for k in check.NUMBERS},
    }
    if device.type == "cuda":
        out["copy_probe"] = copy_probe(device)
        out["host_probe"] = host_probe(prog.stream.upload, device)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        bench.log("needs a CUDA device")
        return 2
    torch.cuda.set_device(0)
    out = run(spec.load_cell(args.workload), args.seed, args.seconds, torch.device("cuda", 0))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
