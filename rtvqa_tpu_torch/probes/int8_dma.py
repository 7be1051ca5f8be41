"""What frames cost to read and sum as u8 against f32 (kernel 8,
``strip_sum_cuda``): per-frame sums over 32-row strips, each frame read
once. The port of ``scripts/probe_int8_dma.py``, whose TPU kernel read each
strip as a 48-row window at an 8-aligned row and had to bitcast the u8
frames to int8 to DMA them; here the kernel reads u8 as it is.

    python -m rtvqa_tpu_torch.probes.int8_dma [--n 16] [--reps 10] [--device cpu]

Prints the correctness of both types against a float64 sum of the frames
(the script's check, rel 1e-6), then the times: u8 as it is, the f32 copy
alone, and the f32 path with its ``x.float()`` conversion (the script's
"astype prep"), each with the frames' bytes read per second.
"""

from __future__ import annotations

import sys

import torch

from rtvqa_tpu_torch.kernels.probes import strip_sum_cuda
from rtvqa_tpu_torch.obs.roofline import strip_sum_work
from rtvqa_tpu_torch.probes import device_ms, fmt_ms, parser, rate, setup, time_ms

N, H, W = 16, 1080, 1920
RTOL = 1e-6


def main(argv: list[str] | None = None) -> int:
    args = parser(__doc__.splitlines()[0], N, H, W).parse_args(argv)
    dev, gen, where = setup(args)
    shape = (args.n, args.height, args.width)
    xs = [torch.randint(0, 256, shape, generator=gen, device=dev, dtype=torch.uint8) for _ in range(3)]
    xf = [x.float() for x in xs]
    want = xs[0].double().sum(dim=(1, 2))
    ok = True
    for name, x in (("u8", xs[0]), ("f32", xf[0])):
        err = float(((strip_sum_cuda(x).double() - want).abs() / want.clamp_min(1.0)).max())
        ok &= err < RTOL
        print(f"[probe] {name} strip-sum correctness: max_rel_err={err:.3g} "
              f"{'PASS' if err < RTOL else 'FAIL'}", flush=True)
    print(f"[probe] {args.n}x{args.height}x{args.width} on {where}", flush=True)
    for name, fn, inputs, itemsize in (("u8 raw", strip_sum_cuda, xs, 1),
                                       ("f32 (strips only)", strip_sum_cuda, xf, 4),
                                       ("f32 (astype prep)", lambda x: strip_sum_cuda(x.float()), xs, 4)):
        ms, dms = time_ms(fn, inputs, args.reps, dev), device_ms(fn, inputs, args.reps, dev)
        nbytes = strip_sum_work(*shape, itemsize)[0]
        on_device = f" = {rate(nbytes, dms)}" if dms else ""
        print(f"[probe] {name}: {ms:.4f} ms ({rate(nbytes, ms)} of frames); device "
              f"{fmt_ms(dms)}{on_device}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
