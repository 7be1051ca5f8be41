"""The port's quality chunk on camera-plausible 1080p content against a
golden frozen from the JAX package's CPU chunk path.

Frames: 8 of the ``bench.py::make_video_frames`` recipe, copied below
(smooth sinusoidal luma with two moving flat 160x160 squares, flat
chroma), and dis = ref plus seeded uniform integer noise (luma [-3, 3],
chroma [-2, 2]). The flat squares and chroma give the flat ref windows
that gradient + noise frames lack. The golden,
``tests/golden/torch_synthetic_1080p_features.npz``, holds the JAX
package's ``_program_a`` + ``_program_b`` (exact f32, on the CPU) per-frame
``CHUNK_KEYS`` for one chunk without a previous frame, and sha256 digests
of the inputs. Refreeze it with

    JAX_PLATFORMS=cpu python -m tests.test_torch_synthetic_golden

Here the JAX programs recompute it, which must give the stored bits, and
the port's plain chunk (``chunk_plain``, on the CPU) is held to it with
the tolerances of ``test_torch_full_reference.py`` against the JAX plain
programs; ``tests/test_torch_cuda.py`` holds the kernel chunk
(``chunk_kernels``) on the card with ROADMAP C's.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden", "torch_synthetic_1080p_features.npz")
N_FRAMES, H, W = 8, 1080, 1920
SEED = 61
# key prefix -> (rtol, atol) against the JAX plain programs (as
# test_torch_full_reference.py::check_packed holds chunk_plain).
PLAIN_TOLS = {"mse": (1e-6, 0.0), "psnr": (1e-6, 0.0), "ssim": (1e-6, 0.0),
              "motion": (1e-5, 1e-6), "vif": (1e-4, 0.0), "adm": (1e-4, 0.0)}


def make_video_frames(n, variant=0, h=H, w=W):
    """Camera-plausible content (bench.py::make_video_frames): smooth
    structured luma with global motion and two moving flat squares."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = np.empty((n, h, w), np.uint8)
    for i in range(n):
        t = i + 31.0 * variant
        img = (
            120.0
            + 55.0 * np.sin(2 * np.pi * (xx + 2.5 * t) / 240.0)
            + 35.0 * np.cos(2 * np.pi * (yy + 1.5 * t) / 180.0)
        )
        bx = int(300 + 6 * t) % (w - 200)
        by = int(200 + 4 * t) % (h - 200)
        img[by : by + 160, bx : bx + 160] = 230.0
        img[(h - by - 160) : (h - by), (w - bx - 160) : (w - bx)] = 25.0
        frames[i] = np.clip(img, 0, 255).astype(np.uint8)
    u = np.full((n, h // 2, w // 2), 120, np.uint8)
    v = np.full((n, h // 2, w // 2), 132, np.uint8)
    return frames, u, v


def make_pair():
    """(ref planes, dis planes): uint8 (y, u, v) of the golden's chunk."""
    ref = make_video_frames(N_FRAMES)
    rng = np.random.default_rng(SEED)
    dis = tuple(
        np.clip(a.astype(np.int16) + rng.integers(-k, k + 1, a.shape, dtype=np.int16), 0, 255).astype(np.uint8)
        for a, k in zip(ref, (3, 2, 2))
    )
    return ref, dis


def digest(planes) -> str:
    h = hashlib.sha256()
    for a in planes:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def tolerance(key: str, tols: dict) -> tuple[float, float]:
    return next(v for prefix, v in tols.items() if key.startswith(prefix))


def check_golden(packed, golden, keys, tols) -> dict:
    """Every key's per-frame values within its (rtol, atol); returns the max
    relative error per key."""
    worst = {}
    for i, key in enumerate(keys):
        got, want = np.asarray(packed[i], np.float64), np.asarray(golden[key], np.float64)
        rtol, atol = tolerance(key, tols)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=key)
        worst[key] = float((np.abs(got - want) / np.maximum(np.abs(want), 1e-30)).max())
    return worst


def test_chunk_plain_matches_synthetic_golden():
    from rtvqa_tpu_torch.metrics.full_reference import CHUNK_KEYS, chunk_plain

    golden = np.load(GOLDEN_PATH)
    ref, dis = make_pair()
    assert digest(ref) == str(golden["digest_ref"]) and digest(dis) == str(golden["digest_dis"])
    planes = [torch.from_numpy(a) for a in (*ref, *dis)]
    packed, _ = chunk_plain(*planes, torch.zeros((H, W)), False)
    check_golden(packed.numpy(), golden, CHUNK_KEYS, PLAIN_TOLS)


def jax_packed(ref, dis) -> tuple[np.ndarray, tuple]:
    """(packed per-frame features, keys) of the JAX package's plain chunk
    programs on the CPU for one chunk without a previous frame."""
    import jax.numpy as jnp

    from rtvqa_tpu.metrics import full_reference as jfr

    pa, _ = jfr._program_a(*ref, *dis, np.zeros((H, W), np.float32), jnp.asarray(False))
    pb = jfr._program_b(ref[0], dis[0])
    return np.concatenate([np.asarray(pa), np.asarray(pb)]).astype(np.float32), jfr.CHUNK_KEYS


def test_synthetic_golden_matches_jax_reference():
    """The stored golden is still what the JAX package's programs give on
    these inputs (f32 bits; the programs run on the CPU here as when the
    golden was frozen)."""
    golden = np.load(GOLDEN_PATH)
    packed, keys = jax_packed(*make_pair())
    for i, key in enumerate(keys):
        np.testing.assert_array_equal(packed[i], golden[key], err_msg=key)


def freeze(path: str = GOLDEN_PATH) -> None:
    """Compute the golden with the JAX package's plain chunk programs on the
    CPU and write it to ``path``."""
    ref, dis = make_pair()
    packed, keys = jax_packed(ref, dis)
    np.savez(path, digest_ref=digest(ref), digest_dis=digest(dis),
             **{key: packed[i] for i, key in enumerate(keys)})


if __name__ == "__main__":
    freeze()
    print(f"wrote {GOLDEN_PATH}")
