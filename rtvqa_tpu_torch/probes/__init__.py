"""Measurement probes: where a quality kernel's time goes on the card, the
input path or the arithmetic (the port of ``scripts/probe_adm_stages.py``,
``probe_int8_dma.py`` and ``probe_dma_floor.py``).

    python -m rtvqa_tpu_torch.probes.adm_stages   # kernel 6a vs kernel 6
    python -m rtvqa_tpu_torch.probes.int8_dma     # kernel 8: u8 vs f32 windows
    python -m rtvqa_tpu_torch.probes.dma_floor    # kernel 9 vs torch's reductions

Each runs on the card at the JAX scripts' shapes by default; ``--device
cpu`` and the shape flags run the plain versions at small shapes. Inputs
come from a ``torch.Generator`` on the device seeded with ``SEED``. Times on the card are
CUDA events around ``--reps`` calls after a warm-up, cycling through
distinct inputs so that repeat calls do not find them in the 50 MB L2; on
the CPU they are the host clock and are labelled so.
"""

from __future__ import annotations

import argparse
import itertools
import time

import torch

from rtvqa_tpu_torch.device import get_device

SEED = 0


def parser(description: str, n: int, h: int, w: int) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="Where the probe runs (default: cuda; cpu only when asked).")
    p.add_argument("--n", type=int, default=n, help=f"Frames (default {n}).")
    p.add_argument("--height", type=int, default=h, help=f"Rows (default {h}).")
    p.add_argument("--width", type=int, default=w, help=f"Columns (default {w}).")
    p.add_argument("--reps", type=int, default=10, help="Timed calls per measurement (default 10).")
    return p


def setup(args) -> tuple[torch.device, torch.Generator, str]:
    """(device, seeded generator on it, label of where the times come from)."""
    dev = get_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu, host clock"
    return dev, gen, where


def time_ms(fn, inputs, reps: int, dev: torch.device) -> float:
    """Mean ms per call of ``fn(x)`` over ``reps`` calls, cycling through
    ``inputs``, after one warm-up call on each: CUDA events on a GPU, the
    host clock on the CPU."""
    for x in inputs:
        fn(x)
    cycle = itertools.cycle(inputs)
    args = [next(cycle) for _ in range(reps)]
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for x in args:
            fn(x)
        return (time.perf_counter() - t0) * 1e3 / reps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for x in args:
        fn(x)
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def device_ms(fn, inputs, reps: int, dev: torch.device) -> float | None:
    """Device time per call of ``fn(x)``: the durations of the kernels,
    copies and memsets that ``torch.profiler`` records over ``reps`` calls
    (cycling through ``inputs``, after a warm-up), summed, over ``reps``.
    Unlike :func:`time_ms` it leaves out the host's time between launches,
    which bounds a call of a few tens of microseconds. None on the CPU, or
    when two profiled windows in a row record no device time."""
    if dev.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for x in inputs:
        fn(x)
    cycle = itertools.cycle(inputs)
    args = [next(cycle) for _ in range(reps)]
    for _ in range(2):
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for x in args:
                fn(x)
            torch.cuda.synchronize(dev)
        total_us = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA)
        if total_us > 0:
            return total_us / 1e3 / reps
    return None


def fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def rate(nbytes: float, ms: float) -> str:
    return f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s"
