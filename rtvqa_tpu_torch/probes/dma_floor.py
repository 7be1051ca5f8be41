"""The strip-read floor (kernel 9, ``strip_floor_cuda``: every 56-row
window at a 48-row stride read into shared memory, one touch each) in f32,
bf16 and u8, against torch's own reduction and copy bandwidth on the same
arrays. The port of ``scripts/probe_dma_floor.py``.

    python -m rtvqa_tpu_torch.probes.dma_floor [--n 128] [--reps 10] [--device cpu]

Per type: ``torch_sum`` is ``x.float().sum()`` (the script's xla_sum; for
bf16 and u8 it writes an f32 copy first), ``torch_sum_f32acc`` is
``torch.sum(x, dtype=torch.float32)`` (one pass), ``torch_copy`` is
``(x + 1)[::64, ::64, ::64].float().sum()`` (the script's xla_copy: a full
read and write); then the floor kernel, checked exactly against its plain
version, with the windows' bytes per second. Default shape (128, 1088,
2176): 1080p luma padded as the TPU's ADM input was.
"""

from __future__ import annotations

import sys

import torch

from rtvqa_tpu_torch.kernels.probes import strip_floor_cuda, strip_floor_plain
from rtvqa_tpu_torch.obs.roofline import strip_floor_windows
from rtvqa_tpu_torch.probes import device_ms, fmt_ms, parser, rate, setup, time_ms

N, H, W = 128, 1088, 2176
DTYPES = (("f32", torch.float32), ("bf16", torch.bfloat16), ("u8", torch.uint8))


def main(argv: list[str] | None = None) -> int:
    args = parser(__doc__.splitlines()[0], N, H, W).parse_args(argv)
    dev, gen, where = setup(args)
    shape = (args.n, args.height, args.width)
    print(f"[dma] {args.n}x{args.height}x{args.width} on {where}", flush=True)
    ok = True
    for name, dtype in DTYPES:
        xs = [(torch.rand(shape, generator=gen, device=dev) * 255.0).to(dtype) for _ in range(3)]
        nbytes = xs[0].numel() * xs[0].element_size()
        for label, fn, moved in (
            ("torch_sum", lambda x: x.float().sum(), nbytes),
            ("torch_sum_f32acc", lambda x: torch.sum(x, dtype=torch.float32), nbytes),
            ("torch_copy", lambda x: (x + 1)[::64, ::64, ::64].float().sum(), 2 * nbytes),
        ):
            ms = time_ms(fn, xs, args.reps, dev)
            print(f"[dma] {label}[{name}]: {ms:.4f} ms ({rate(moved, ms)} read{'+write' if moved > nbytes else ''})",
                  flush=True)
        got, want = strip_floor_cuda(xs[0]), strip_floor_plain(xs[0])
        equal = torch.equal(got.cpu(), want.cpu())
        ok &= equal
        ms, dms = time_ms(strip_floor_cuda, xs, args.reps, dev), device_ms(strip_floor_cuda, xs, args.reps, dev)
        print(f"[dma] strip_floor[{name}]: {ms:.4f} ms ({rate(strip_floor_windows(*shape, dtype.itemsize), ms)} "
              f"of windows); device {fmt_ms(dms)}; equal to plain: {equal} ({float(got)})", flush=True)
        del xs
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
