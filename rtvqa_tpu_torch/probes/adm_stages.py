"""Where ADM scale 0's time goes: its input path (kernel 6a,
``adm_input_cuda``) against the whole kernel (kernel 6,
``adm_scale_cuda(..., 0)``) on a u8 1080p pair; the delta is the
arithmetic and the output writes. The port of ``scripts/probe_adm_stages.py``
at its stages 0 and 6 (its stages 1-5 are TPU bisection knobs, ROADMAP.md,
'Not ported (deliberate)').

    python -m rtvqa_tpu_torch.probes.adm_stages [--n 64] [--reps 10] [--device cpu]

Default shape: one 64-frame 1080p chunk, what the quality loop hands
kernel 6. The pair is ref and ref plus integer noise in [-4, 4].
"""

from __future__ import annotations

import sys

import torch

from rtvqa_tpu_torch.kernels.adm import adm_input_cuda, adm_input_plain, adm_scale_cuda
from rtvqa_tpu_torch.probes import device_ms, fmt_ms, parser, rate, setup, time_ms

N, H, W = 64, 1080, 1920


def make_pair(n, h, w, gen, dev):
    ref = torch.randint(0, 256, (n, h, w), generator=gen, device=dev, dtype=torch.uint8)
    noise = torch.randint(-4, 5, (n, h, w), generator=gen, device=dev, dtype=torch.int16)
    return ref, (ref.to(torch.int16) + noise).clamp_(0, 255).to(torch.uint8)


def main(argv: list[str] | None = None) -> int:
    args = parser(__doc__.splitlines()[0], N, H, W).parse_args(argv)
    dev, gen, where = setup(args)
    pairs = [make_pair(args.n, args.height, args.width, gen, dev) for _ in range(2)]
    got, want = adm_input_cuda(*pairs[0]), adm_input_plain(*pairs[0])
    ok = all(torch.equal(g.cpu(), p.cpu()) for g, p in zip(got, want))
    print(f"[stg] stage 0 checksum equal to the plain version: {ok} "
          f"({got[0][:4].tolist()} ...)", flush=True)
    stages = {0: lambda p: adm_input_cuda(*p), 6: lambda p: adm_scale_cuda(*p, 0)}
    ms = {k: time_ms(fn, pairs, args.reps, dev) for k, fn in stages.items()}
    dev_ms = {k: device_ms(fn, pairs, args.reps, dev) for k, fn in stages.items()}
    nbytes = 2 * args.n * args.height * args.width
    print(f"[stg] {args.n}x{args.height}x{args.width} u8 pair on {where}", flush=True)
    for k, label in ((0, "input path (adm_input_cuda)"), (6, "full kernel (adm_scale_cuda)")):
        print(f"[stg] stage[{k}] {label}: {ms[k]:.4f} ms ({rate(nbytes, ms[k])} of input); "
              f"device {fmt_ms(dev_ms[k])}", flush=True)
    print(f"[stg] delta[arithmetic + output writes]: {ms[6] - ms[0]:+.4f} ms", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
