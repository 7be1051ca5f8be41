"""The frame pool: decoded YUV420 ref/dis pairs held on the host, as a
decoder would hand them over, made from the seed at set-up.

Content (``content.recipe`` "gradient_noise", the JAX bench's recipe,
``bench.py:59-69``): luma ``(3x + 2y + phase_k) mod 256`` plus seeded noise
in [0, noise_k), clipped, for pool frame k, where ``phase_k`` is the sum
of the steps of frames 0..k; chroma seeded in [low, high). With
``letterbox_aspect`` the picture is that aspect ratio, centred, and the
rows above and below are black (Y 16, U/V 128), the same in ref and dis.
dis is ref plus the configuration's distortion: seeded integers in
[-amplitude_k, amplitude_k], clipped, inside the picture only.

The step (``levels_per_frame``), the noise (``noise_levels``) and the
distortion (``amplitude``) are each a range ``[lo, hi]`` drawn per pool
frame from the seed: content moves and an encode's quality swings
from frame to frame (I/P/B frames), so every frame's quality values and
SAD differ from its neighbours' by far more than a check's limit, and an
answer for the wrong frame cannot pass for the right one.

The planes are generated on the device in blocks, from one seeded
generator, and copied into pageable host arrays. A clip reads pool frames
``offset, offset+1, ...`` (wrapping), in ``FrameBatch``es of the chunk size
as ``io/stream.py::VideoStream`` yields them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

PLANES = ("y", "u", "v")


def bar_rows(height: int, width: int, aspect) -> int:
    """Black rows above (and below) a picture of ``aspect`` centred in the
    frame, even so the chroma rows split too; 0 without letterbox."""
    if not aspect:
        return 0
    rows = int((height - width / float(aspect)) / 2)
    return max(0, rows - rows % 2)


@dataclasses.dataclass
class Pool:
    ref: tuple          # (y, u, v) uint8 arrays (P, H, W), (P, H/2, W/2) x2
    dis: tuple
    fps: float

    @property
    def frames(self) -> int:
        return self.ref[0].shape[0]

    def indices(self, offset: int, start: int, n: int) -> np.ndarray:
        return (offset + start + np.arange(n)) % self.frames

    def planes(self, side: str, idx: np.ndarray) -> tuple:
        """(y, u, v) of pool frames ``idx``: views where they run in order,
        copies where they wrap."""
        arrs = self.ref if side == "ref" else self.dis
        if idx.size and idx[-1] == idx[0] + idx.size - 1:
            return tuple(a[idx[0]: idx[-1] + 1] for a in arrs)
        return tuple(np.take(a, idx, axis=0) for a in arrs)

    def batches(self, side: str, clip, chunk: int, frame_batch):
        """The clip's ``FrameBatch``es of ``chunk`` frames (the last may be
        shorter), timestamps 1/fps apart from 0."""
        for s in range(0, clip.frames, chunk):
            n = min(chunk, clip.frames - s)
            ts = (s + np.arange(n)) * (1000.0 / self.fps)
            yield frame_batch(*self.planes(side, self.indices(clip.offset, s, n)), ts, s)


def per_frame(bounds, n: int, gen, device) -> torch.Tensor:
    """A frame parameter for ``n`` pool frames, drawn per frame from ``gen``
    in ``[lo, hi]`` (both ends included)."""
    return torch.randint(int(bounds[0]), int(bounds[1]) + 1, (n,), generator=gen, device=device,
                         dtype=torch.int32)


def make_pool(config: dict, traffic: dict, seed: int, device, block: int = 8) -> Pool:
    """The pool of ``config["frame_pool_pairs"]`` ref/dis pairs at the
    configuration's frame size, from ``seed``."""
    h, w = int(config["height"]), int(config["width"])
    n = int(config["frame_pool_pairs"])
    content = traffic["content"]
    bars = bar_rows(h, w, traffic.get("letterbox_aspect"))
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    shapes = {"y": (n, h, w), "u": (n, h2, w2), "v": (n, h2, w2)}
    ref = {p: np.empty(s, np.uint8) for p, s in shapes.items()}
    dis = {p: np.empty(s, np.uint8) for p, s in shapes.items()}
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    phase = torch.cumsum(per_frame(content["levels_per_frame"], n, gen, device), 0)
    noise = per_frame(content["noise_levels"], n, gen, device)
    amp = per_frame(config["distortion"]["amplitude"], n, gen, device)

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=device, dtype=torch.int16)

    def below(top, shape):
        """Seeded integers in [0, top) per frame, ``top`` of shape (b,)."""
        top = top.view(-1, *([1] * (len(shape) - 1)))
        r = torch.rand(shape, generator=gen, device=device)
        return torch.minimum((r * top).floor(), top - 1).to(torch.int16)

    yy = torch.arange(h, device=device, dtype=torch.int32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.int32)[None, :]
    base = (xx * 3 + yy * 2) % 256
    for k0 in range(0, n, block):
        b = min(block, n - k0)
        y = ((base[None] + phase[k0:k0 + b, None, None]) % 256).to(torch.int16)
        planes = {
            "y": (y + below(noise[k0:k0 + b], (b, h, w))).clamp(0, 255),
            "u": randint(int(content["chroma_low"]), int(content["chroma_high"]), (b, h2, w2)),
            "v": randint(int(content["chroma_low"]), int(content["chroma_high"]), (b, h2, w2)),
        }
        a = amp[k0:k0 + b]
        for p, r in planes.items():
            d = (r + below(2 * a + 1, r.shape) - a.view(-1, 1, 1).to(torch.int16)).clamp(0, 255)
            if bars:
                rows = bars if p == "y" else bars // 2
                black = 16 if p == "y" else 128
                r[:, :rows] = black
                r[:, r.shape[1] - rows:] = black
                d[:, :rows] = black
                d[:, d.shape[1] - rows:] = black
            ref[p][k0:k0 + b] = r.to(torch.uint8).cpu().numpy()
            dis[p][k0:k0 + b] = d.to(torch.uint8).cpu().numpy()
    return Pool(tuple(ref[p] for p in PLANES), tuple(dis[p] for p in PLANES), float(config["fps"]))
