"""Kernel 1 (``yuv420_to_gray_cuda``) at the frame shapes users send, and
what a plain elementwise stream reaches on the same card.

    python -m rtvqa_tpu_torch.probes.gray_shapes [--reps 20] [--shapes BxHxW ...] [--device cpu]

Default shapes: 128x1080x1920 and 32x2160x3840 (both 1.46 GB of traffic,
the vector path) and 128x480x854 (480p, the general path). For each shape,
on seeded random YUV420 planes: the kernel's output against its plain
version (exact equality), its time by CUDA events and by device time, and
its share of the bound (``obs/roofline.py::gray_work``). Then, on the
first shape's luma, the time of ``y.to(torch.float32)``, which moves 5 of
the kernel's 5.5 B per pixel, and of ``fill_`` of an f32 tensor of that
shape, its 4 B of writes alone: yardsticks of an elementwise stream on
this card, not calls that compute the kernel's function.

It uses only ``kernels/gray.py::yuv420_to_gray_cuda``, ``ops/color.py``,
``obs/roofline.py`` and ``probes/__init__.py``, so with ``PYTHONPATH``
naming another checkout, run by its path, it times that checkout's kernel
with the same inputs.
"""

from __future__ import annotations

import argparse
import sys

import torch

import rtvqa_tpu_torch
from rtvqa_tpu_torch.device import get_device
from rtvqa_tpu_torch.kernels.gray import yuv420_to_gray_cuda
from rtvqa_tpu_torch.obs.roofline import gray_work, kernel_bound
from rtvqa_tpu_torch.ops.color import yuv420_to_gray
from rtvqa_tpu_torch.probes import SEED, device_ms, fmt_ms, time_ms

SHAPES = ("128x1080x1920", "32x2160x3840", "128x480x854")


def planes(b: int, h: int, w: int, dev: torch.device):
    """Random (y, u, v) uint8 YUV420 planes from a generator on ``dev``
    seeded with ``SEED``."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    hc, wc = (h + 1) // 2, (w + 1) // 2
    return tuple(torch.randint(0, 256, s, generator=gen, device=dev, dtype=torch.uint8)
                 for s in ((b, h, w), (b, hc, wc), (b, hc, wc)))


def measure(y, u, v, reps: int, dev: torch.device) -> dict:
    """The kernel on (y, u, v): equality with the plain version, event and
    device ms per call, the bound (ms, by) and the share of it."""
    equal = torch.equal(yuv420_to_gray_cuda(y, u, v), yuv420_to_gray(y, u, v))
    ms = time_ms(lambda _: yuv420_to_gray_cuda(y, u, v), [None], reps, dev)
    dev_ms = device_ms(lambda _: yuv420_to_gray_cuda(y, u, v), [None], reps, dev)
    bound_ms, by = kernel_bound(*gray_work(*y.shape, *u.shape[-2:]))
    return {"shape": tuple(y.shape), "equal": equal, "ms": ms, "dev_ms": dev_ms,
            "bound_ms": bound_ms, "bound_by": by, "on_card": dev.type == "cuda"}


def describe(m: dict) -> str:
    share = "the card's bound is not compared with a CPU time"
    if m["on_card"]:
        share = f"{m['bound_ms'] / m['ms']:.1%} by events"
    if m["dev_ms"]:
        share += f", {m['bound_ms'] / m['dev_ms']:.1%} by device"
    return (f"{'x'.join(map(str, m['shape']))}: equal to plain: {m['equal']}; kernel "
            f"{m['ms']:.4f} ms, device {fmt_ms(m['dev_ms'])}; bound {m['bound_ms']:.4f} ms "
            f"({m['bound_by']}): {share}")


def yardstick(y, reps: int, dev: torch.device) -> str:
    """``y.to(torch.float32)`` (1 B read and 4 B written per pixel) and
    ``fill_`` of an f32 tensor of y's shape (4 B written), timed."""
    out = torch.empty(y.shape, dtype=torch.float32, device=dev)
    parts = []
    for label, fn in (("y.to(torch.float32)", lambda _: y.to(torch.float32)),
                      ("f32 fill_", lambda _: out.fill_(1.0))):
        ms, dev_ms = time_ms(fn, [None], reps, dev), device_ms(fn, [None], reps, dev)
        parts.append(f"{label} {ms:.4f} ms, device {fmt_ms(dev_ms)}")
    return f"on {'x'.join(map(str, y.shape))}: " + "; ".join(parts)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="Where the probe runs (default: cuda; cpu only when asked).")
    p.add_argument("--shapes", nargs="+", default=list(SHAPES), help="Frame batches as BxHxW.")
    p.add_argument("--reps", type=int, default=20, help="Timed calls per measurement (default 20).")
    args = p.parse_args(argv)
    dev = get_device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu, host clock"
    print(f"[gray] rtvqa_tpu_torch from {rtvqa_tpu_torch.__file__}; on {where}", flush=True)
    ok = True
    for i, spec in enumerate(args.shapes):
        y, u, v = planes(*map(int, spec.split("x")), dev)
        m = measure(y, u, v, args.reps, dev)
        ok &= m["equal"]
        print(f"[gray] {describe(m)}", flush=True)
        if i == 0:
            print(f"[gray] {yardstick(y, args.reps, dev)}", flush=True)
        del y, u, v
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
