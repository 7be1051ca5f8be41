"""The one traffic generator: a closed loop of clips whose lengths, content
and framing a mix's data file sets (``traffic/<name>.json``).

``clip_frames`` gives the lengths:

* ``{"kind": "fixed", "frames": n}``: every clip has n frames;
* ``{"kind": "lognormal", "median": m, "sigma": s, "min": a, "max": b,
  "deck": k}``: a deck of k lengths at the lognormal's quantiles
  (i + 0.5) / k, rounded and clipped to [a, b].

Every seed plays the same deck, reshuffled by the seed each time it is
dealt, so every seed offers the same set of lengths in another order, and
a window of a few decks sees nearly the same lengths whatever the seed.
Each clip starts at a seeded frame of the frame pool, which is its content
phase, on a multiple of ``align`` (the chunk size, where the pool holds a
whole number of chunks): every chunk is then a view of the pool and no seed
makes the program's staging copy more than another's.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class Clip:
    frames: int     # length
    offset: int     # first frame in the pool


def deck(traffic: dict) -> np.ndarray:
    """The mix's clip lengths, one deck, in quantile order."""
    spec = traffic["clip_frames"]
    if spec["kind"] == "fixed":
        return np.array([int(spec["frames"])], np.int64)
    if spec["kind"] == "lognormal":
        k = int(spec["deck"])
        z = [statistics.NormalDist().inv_cdf((i + 0.5) / k) for i in range(k)]
        lengths = [round(spec["median"] * math.exp(spec["sigma"] * zi)) for zi in z]
        return np.clip(np.array(lengths, np.int64), spec["min"], spec["max"])
    raise ValueError(f"unknown clip_frames kind {spec['kind']!r}")


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent generator per use of the seed (any size of seed)."""
    return np.random.default_rng([int(seed) % 2**64, stream])


def clips(traffic: dict, seed: int, pool_frames: int, align: int = 1) -> Iterator[Clip]:
    """The closed loop's clips, endlessly: the deck reshuffled by the seed
    at every deal; each clip's first pool frame drawn by the seed, a
    multiple of ``align`` when the pool holds a whole number of them."""
    if traffic.get("loop", "closed") != "closed":
        raise ValueError("only closed loops are generated: one clip at a time")
    d = deck(traffic)
    step = align if pool_frames % align == 0 else 1
    r = rng(seed, 1)
    while True:
        for length in r.permutation(d):
            yield Clip(int(length), int(r.integers(0, pool_frames // step)) * step)


def warmup_clips(traffic: dict, cover: int) -> list[Clip]:
    """The warm-up: for each octave [2**j, 2**(j+1)) of the lengths the mix
    deals, one clip of its longest length, cut to ``cover`` frames. The
    device sees only full chunks (a ragged tail is padded to one on the
    host), so what differs between lengths is the size of the uploads that
    grow with the clip (the accumulator's flush of the sampled frames), and
    the caching host allocator keeps its pinned buffers in power-of-two
    size classes: one clip an octave fills each class the window will ask
    for. ``cover`` (a few chunks and one accumulator flush) is all a longer
    clip adds. Longest first."""
    d = sorted(set(deck(traffic).tolist()))
    top = {}
    for n in d:
        top[int(n).bit_length()] = int(n)
    return [Clip(n, 0) for n in sorted({min(n, int(cover)) for n in top.values()}, reverse=True)]
