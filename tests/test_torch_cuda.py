"""The CUDA kernels vs their plain PyTorch versions on the card.

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is False (the
check runs inside a fixture, never at import). On a machine with a GPU and
nvcc, and without jax, run them alone with:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: gray exact (``torch.equal``: on both of its paths the kernel
rounds every operation as the plain ops do); motion rel 5e-3 on smooth
frames (docs/PARITY.md: near-tie argmins), exact on integer-valued frames and 0 on
a static scene, and its index fields on smoothed non-integer frames equal
to an earlier kernel's (MOTION_INDEX_DIGEST; kernels 5 and 6 are held to
digests of their own as well). Quality kernels, those of the JAX package's own kernel
tests: SSEs equal (integer sums); SSIM means abs 2e-6; VIF scale 0 rel
2e-4; SAD rel 1e-5 / abs 1e-5; blur carry abs 1e-4; decimated planes rel
1e-4 / abs 1e-3; VIF scales 1-3 rel 3e-4 (kernel 4, VIF at one scale:
rel 2e-4 at scale 0, 3e-4 after, its planes as the decimated ones); ADM
num/den rel 2e-4, the
approximation bands rel 1e-4 / abs 1e-3, adm2 rel 3e-4. The kernels sum
per tile in float64 where the plain ops sum in f32, so the sums differ by
f32 rounding; repeat runs of a kernel are bit-identical. The probe
kernels: 6a and 9 exact, 8 rel 1e-6 (scripts/probe_int8_dma.py's check).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from rtvqa_tpu_torch.device import get_device

    return get_device("cuda")


def _yuv(rng, n, h, w, dev):
    y = rng.integers(0, 256, (n, h, w), dtype=np.uint8)
    u = rng.integers(0, 256, (n, -(-h // 2), -(-w // 2)), dtype=np.uint8)
    v = rng.integers(0, 256, (n, -(-h // 2), -(-w // 2)), dtype=np.uint8)
    return tuple(torch.from_numpy(a).to(dev) for a in (y, u, v))


@pytest.mark.parametrize(
    "shape,path",
    [
        ((64, 96), "vector"),
        ((67, 131), "general"),
        ((1, 1), "general"),
        ((1080, 1920), "vector"),
        ((1081, 1920), "vector"),    # odd h: a last row pair of one row
        ((480, 854), "general"),     # w % 4 != 0
        ((2160, 3840), "vector"),
        ((2160, 4096), "vector"),
    ],
)
def test_gray_kernel_matches_plain(dev, shape, path):
    from rtvqa_tpu_torch.kernels.gray import gray_path, yuv420_to_gray_cuda
    from rtvqa_tpu_torch.ops.color import yuv420_to_gray

    y, u, v = _yuv(np.random.default_rng(0), 3, *shape, dev)
    assert gray_path(shape[1], y.data_ptr(), u.data_ptr(), v.data_ptr()) == path
    before = yuv420_to_gray_cuda.launches
    got = yuv420_to_gray_cuda(y, u, v)
    torch.cuda.synchronize()
    assert yuv420_to_gray_cuda.launches == before + 1
    assert torch.equal(got, yuv420_to_gray(y, u, v))


def test_gray_kernel_misaligned_view_takes_the_general_path(dev):
    """Planes that are contiguous views from byte 1 of a flat buffer: 1920
    columns, but not the vector path's 4-byte (luma) and 2-byte (chroma)
    alignment."""
    from rtvqa_tpu_torch.kernels.gray import gray_path, yuv420_to_gray_cuda
    from rtvqa_tpu_torch.ops.color import yuv420_to_gray

    planes = []
    for a in _yuv(np.random.default_rng(2), 2, 1080, 1920, dev):
        flat = torch.empty(a.numel() + 1, dtype=torch.uint8, device=dev)
        view = flat[1:].view(a.shape)
        view.copy_(a)
        assert view.is_contiguous() and view.data_ptr() % 2 == 1
        planes.append(view)
    y, u, v = planes
    assert gray_path(1920, y.data_ptr(), u.data_ptr(), v.data_ptr()) == "general"
    assert torch.equal(yuv420_to_gray_cuda(y, u, v), yuv420_to_gray(y, u, v))


@pytest.mark.parametrize("shape", [(70000, 2, 16), (70000, 1, 5)])
def test_gray_kernel_takes_more_than_65535_frames(dev, shape):
    """The launch puts no frame or row count on a grid axis."""
    from rtvqa_tpu_torch.kernels.gray import yuv420_to_gray_cuda
    from rtvqa_tpu_torch.ops.color import yuv420_to_gray

    y, u, v = _yuv(np.random.default_rng(3), *shape, dev)
    assert torch.equal(yuv420_to_gray_cuda(y, u, v), yuv420_to_gray(y, u, v))


@pytest.mark.parametrize(
    "shape,block,radius",
    [((540, 960), 8, 4), ((75, 101), 8, 4), ((1080, 1920), 16, 8), ((48, 40), 16, 1)],
)
def test_motion_kernel_matches_plain(dev, shape, block, radius):
    from rtvqa_tpu_torch.kernels.motion import block_match_motion_cuda
    from rtvqa_tpu_torch.ops.motion import block_match_motion

    rng = np.random.default_rng(1)
    tex = torch.from_numpy(rng.integers(0, 256, (3, *shape)).astype(np.float32)).to(dev)
    prev = tex[:2].contiguous()
    curr = torch.roll(prev, shifts=(2, -3), dims=(1, 2)).contiguous()
    before = block_match_motion_cuda.launches
    got = block_match_motion_cuda(prev, curr, block, radius)
    torch.cuda.synchronize()
    assert block_match_motion_cuda.launches == before + 1
    # Integer-valued frames: every SAD is exact in f32, so equal fields.
    assert torch.equal(got, block_match_motion(prev, curr, block, radius))
    assert bool((block_match_motion_cuda(prev, prev, block, radius) == 0).all())

    smooth = torch.nn.functional.avg_pool2d(tex[:, None], 3, 1, 1)[:, 0].contiguous() / 3.0
    got = block_match_motion_cuda(smooth[:-1], smooth[1:], block, radius)
    want = block_match_motion(smooth[:-1], smooth[1:], block, radius)
    torch.testing.assert_close(got, want, rtol=5e-3, atol=0)


# Seeded, smoothed, non-integer pairs of kernel 2's search, (seed, (h, w),
# block, radius): the pyramid's search at 1080p, the full search at 1080p,
# a frame with ragged block rows and columns, and the general path.
MOTION_DIGEST_CASES = [(50, (540, 960), 8, 4), (51, (1080, 1920), 16, 8), (52, (75, 101), 8, 4),
                       (53, (48, 40), 16, 1)]
# sha256 of the int32 best-index fields that rtvqa_block_match_motion wrote
# on MOTION_DIGEST_CASES before the search held its candidates in registers:
# commit e0d36da's sources, through motion_index_digest, printed it on an
# H100.
MOTION_INDEX_DIGEST = "67a69496bccc851a458a31adcdbfe4bccb59a6ce7f3d2717d61ded3b3435c0cc"


def motion_digest_frames(seed, shape):
    """(prev, curr), each (2, H, W) f32: integer texture under a 3x3 box
    mean (edges replicated) divided by 3, so no value is an integer; curr is
    prev moved by (2, -3) plus a tenth of another such texture."""
    rng = np.random.default_rng(seed)
    tex = rng.integers(0, 256, (3, *shape)).astype(np.float64)
    pad = np.pad(tex, ((0, 0), (1, 1), (1, 1)), mode="edge")
    smooth = sum(pad[:, i:i + shape[0], j:j + shape[1]] for i in range(3) for j in range(3)) / 27.0
    prev = smooth[:2]
    curr = np.roll(prev, (2, -3), (1, 2)) + 0.1 * smooth[2]
    return prev.astype(np.float32), curr.astype(np.float32)


def motion_index_digest(launch, dev) -> str:
    """sha256 over the index fields ``launch(prev, curr, block, radius)``
    returns (int32, (2, H/block, W/block)) on every case of
    MOTION_DIGEST_CASES."""
    import hashlib

    digest = hashlib.sha256()
    for seed, shape, block, radius in MOTION_DIGEST_CASES:
        prev, curr = (torch.from_numpy(a).to(dev) for a in motion_digest_frames(seed, shape))
        best = launch(prev, curr, block, radius)
        assert best.dtype == torch.int32 and best.shape == (2, shape[0] // block, shape[1] // block)
        digest.update(best.cpu().numpy().tobytes())
    return digest.hexdigest()


def test_motion_index_field_unchanged(dev):
    """Kernel 2 picks the same candidate for every block as before its
    candidates moved into registers, on frames whose SADs are not integers."""
    from rtvqa_tpu_torch.kernels.motion import _launch

    assert motion_index_digest(lambda *a: _launch(*a)[0], dev) == MOTION_INDEX_DIGEST


def test_suite_kernel_path_matches_plain(dev):
    from rtvqa_tpu_torch.io.video import DecodedClip
    from rtvqa_tpu_torch.metrics.complexity import (
        METRIC_ORDER,
        calculate_average_scene_complexity,
    )

    rng = np.random.default_rng(2)
    n, h, w = 9, 120, 176
    tex = rng.integers(0, 256, (h + 40, w + 40))
    clip = DecodedClip(
        y=np.stack([np.roll(tex, (2 * i, -i), (0, 1))[:h, :w] for i in range(n)]).astype(np.uint8),
        u=rng.integers(60, 200, (n, h // 2, w // 2), np.uint8),
        v=rng.integers(60, 200, (n, h // 2, w // 2), np.uint8),
        timestamps_ms=np.arange(n) * 333.3, width=w, height=h, n_frames_total=n,
        bit_rate=0, avg_fps=3.0,
    )
    k = calculate_average_scene_complexity(clip, 64, 64, device=dev)
    p = calculate_average_scene_complexity(clip, 64, 64, motion_impl="plain", device=dev)
    for key in METRIC_ORDER:
        tol = 5e-3 if key == "motion" else 1e-4
        assert getattr(k, key) == pytest.approx(getattr(p, key), rel=tol, abs=1e-6), key


def _quality_inputs(rng, b, h, w, dev, noise=4):
    hc, wc = -(-h // 2), -(-w // 2)
    ref = [rng.integers(0, 256, s, np.uint8) for s in ((b, h, w), (b, hc, wc), (b, hc, wc))]
    dis = [np.clip(a.astype(np.int16) + rng.integers(-noise, noise + 1, a.shape), 0, 255).astype(np.uint8)
           for a in ref]
    prev_blur = (rng.random((h, w)) * 255).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (*ref, *dis, prev_blur)]


def _rel(got, want):
    return float(((got.double() - want.double()).abs() / want.double().abs().clamp_min(1e-30)).max())


# DCI 4K's last luma tile holds 16 of its 240 columns; 3856 lies just past 3840.
QUALITY_SHAPES = [(3, 48, 64), (2, 50, 71), (3, 1080, 1920), (4, 1440, 2560), (2, 2160, 3840),
                  (2, 2160, 4096), (2, 40, 3856)]


@pytest.mark.parametrize("b,h,w", QUALITY_SHAPES)
@pytest.mark.parametrize("egl", [None, 1.0])
def test_quality_kernel_matches_plain(dev, b, h, w, egl):
    from rtvqa_tpu_torch.kernels.quality import quality_fused_cuda, quality_fused_plain

    x = _quality_inputs(np.random.default_rng(3), b, h, w, dev)
    before = quality_fused_cuda.launches
    got = quality_fused_cuda(*x, egl=egl)
    torch.cuda.synchronize()
    assert quality_fused_cuda.launches == before + 1
    want = quality_fused_plain(*x, egl=egl)
    for key in ("sse_y", "sse_u", "sse_v"):
        assert torch.equal(got[key], want[key]), key
    hc, wc = x[1].shape[-2:]
    for key, n_win in (("ssim_y_sum", (h // 4 - 1) * (w // 4 - 1)),
                       ("ssim_u_sum", (hc // 4 - 1) * (wc // 4 - 1)),
                       ("ssim_v_sum", (hc // 4 - 1) * (wc // 4 - 1))):
        torch.testing.assert_close(got[key] / n_win, want[key] / n_win, rtol=0, atol=2e-6)
    assert _rel(got["vif_scale0"], want["vif_scale0"]) < 2e-4
    torch.testing.assert_close(got["sad_sum"], want["sad_sum"], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got["blur_carry"], want["blur_carry"], rtol=0, atol=1e-4)
    for key in ("dec_ref", "dec_dis"):
        torch.testing.assert_close(got[key], want[key], rtol=1e-4, atol=1e-3)


def _assert_quality_close(got, want, h, w, hc, wc):
    """Kernel 3's tolerances against its plain version (module docstring)."""
    for key in ("sse_y", "sse_u", "sse_v"):
        assert torch.equal(got[key], want[key]), key
    for key, n_win in (("ssim_y_sum", (h // 4 - 1) * (w // 4 - 1)),
                       ("ssim_u_sum", (hc // 4 - 1) * (wc // 4 - 1)),
                       ("ssim_v_sum", (hc // 4 - 1) * (wc // 4 - 1))):
        torch.testing.assert_close(got[key] / n_win, want[key] / n_win, rtol=0, atol=2e-6)
    assert _rel(got["vif_scale0"], want["vif_scale0"]) < 2e-4
    torch.testing.assert_close(got["sad_sum"], want["sad_sum"], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got["blur_carry"], want["blur_carry"], rtol=0, atol=1e-4)
    for key in ("dec_ref", "dec_dis"):
        torch.testing.assert_close(got[key], want[key], rtol=1e-4, atol=1e-3)


def _flat_inputs(rng, b, h, w, levels, dev):
    """Flat ref fields (one level per quadrant) with one textured square
    that moves a pixel per frame; dis = ref + noise on the left half and
    dis = ref on the right; chroma as _quality_inputs makes it."""
    x = _quality_inputs(rng, b, h, w, dev)
    ref = np.empty((b, h, w), np.uint8)
    for k, (ys, xs) in enumerate(((slice(0, h // 2), slice(0, w // 2)), (slice(0, h // 2), slice(w // 2, w)),
                                  (slice(h // 2, h), slice(0, w // 2)), (slice(h // 2, h), slice(w // 2, w)))):
        ref[:, ys, xs] = levels[k]
    side = min(h, w) // 4
    tex = rng.integers(0, 256, (side, side + b), dtype=np.uint8)
    for i in range(b):
        ref[i, h // 3:h // 3 + side, w // 3:w // 3 + side] = tex[:, i:i + side]
    dis = ref.copy()
    noise = rng.integers(-4, 5, (b, h, w // 2))
    dis[:, :, :w // 2] = np.clip(ref[:, :, :w // 2].astype(np.int16) + noise, 0, 255).astype(np.uint8)
    x[0], x[3] = torch.from_numpy(ref).to(dev), torch.from_numpy(dis).to(dev)
    return x


@pytest.mark.parametrize("b,h,w", [(2, 270, 480), (2, 1080, 1920)])
@pytest.mark.parametrize("levels", [(255, 128, 16, 235), (255, 255, 255, 255)])
def test_quality_kernel_flat_regions(dev, b, h, w, levels):
    """Flat ref windows, where sigma1^2 is rounding noise: the kernel's VIF
    scale 0 still holds rel 2e-4 against the plain version (FMA moments
    alone do not here), and every other output its tolerance."""
    from rtvqa_tpu_torch.kernels.quality import quality_fused_cuda, quality_fused_plain

    x = _flat_inputs(np.random.default_rng(14), b, h, w, levels, dev)
    got = quality_fused_cuda(*x)
    torch.cuda.synchronize()
    _assert_quality_close(got, quality_fused_plain(*x), h, w, *x[1].shape[-2:])


@pytest.mark.parametrize("b,h,w", [(65, 72, 200), (1, 48, 64), (130, 50, 71)])
def test_quality_kernel_frame_runs(dev, b, h, w):
    """Chunks whose frames split into runs of blocks in several ways (runs
    of one frame, of two, a single frame), each run blurring the frame
    before it, against the plain version."""
    from rtvqa_tpu_torch.kernels.quality import quality_fused_cuda, quality_fused_plain

    x = _quality_inputs(np.random.default_rng(15), b, h, w, dev)
    got = quality_fused_cuda(*x)
    torch.cuda.synchronize()
    _assert_quality_close(got, quality_fused_plain(*x), h, w, *x[1].shape[-2:])


@pytest.mark.parametrize("b,h,w", [(64, 1080, 1920), (9, 50, 71)])
def test_quality_kernel_carry_between_calls(dev, b, h, w):
    """A chunk split into two calls, the first call's carry handed to the
    second, gives one call's SAD (within 1e-5) and carry (within 1e-4)."""
    from rtvqa_tpu_torch.kernels.quality import quality_fused_cuda

    x = _quality_inputs(np.random.default_rng(16), b, h, w, dev)
    whole = quality_fused_cuda(*x)
    cut = b // 2 + 1
    first = quality_fused_cuda(*[t[:cut] for t in x[:6]], x[6])
    second = quality_fused_cuda(*[t[cut:] for t in x[:6]], first["blur_carry"])
    torch.cuda.synchronize()
    sad = torch.cat([first["sad_sum"], second["sad_sum"]])
    torch.testing.assert_close(sad, whole["sad_sum"], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(second["blur_carry"], whole["blur_carry"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("b,h,w", QUALITY_SHAPES)
@pytest.mark.parametrize("egl", [None, 1.0])
def test_vif_tail_kernel_matches_plain(dev, b, h, w, egl):
    from rtvqa_tpu_torch.kernels.quality import quality_fused_plain
    from rtvqa_tpu_torch.kernels.vif import vif_tail_cuda, vif_tail_plain

    q = quality_fused_plain(*_quality_inputs(np.random.default_rng(4), b, h, w, dev))
    before = vif_tail_cuda.launches
    got = vif_tail_cuda(q["dec_ref"], q["dec_dis"], egl=egl)
    torch.cuda.synchronize()
    assert vif_tail_cuda.launches == before + 1
    want = vif_tail_plain(q["dec_ref"], q["dec_dis"], egl=egl)
    for key in want:
        assert _rel(got[key], want[key]) < 3e-4, key


@pytest.mark.parametrize("b,h,w", QUALITY_SHAPES)
@pytest.mark.parametrize("egl", [None, 1.0])
def test_adm_kernels_match_plain(dev, b, h, w, egl):
    from rtvqa_tpu_torch.kernels.adm import (
        adm_scale_cuda,
        adm_scale_plain,
        adm_tail_cuda,
        adm_tail_plain,
    )

    x = _quality_inputs(np.random.default_rng(5), b, h, w, dev)
    ry, dy = x[0], x[3]
    before = adm_scale_cuda.launches, adm_tail_cuda.launches
    num, den, a_ref, a_dis = adm_scale_cuda(ry, dy, 0, egl)
    tail = adm_tail_cuda(a_ref, a_dis, egl)
    torch.cuda.synchronize()
    assert (adm_scale_cuda.launches, adm_tail_cuda.launches) == (before[0] + 1, before[1] + 1)
    pn, pd, pa_ref, pa_dis = adm_scale_plain(ry, dy, 0, egl)
    assert _rel(num, pn) < 2e-4 and _rel(den, pd) < 2e-4
    torch.testing.assert_close(a_ref, pa_ref, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(a_dis, pa_dis, rtol=1e-4, atol=1e-3)
    ptail = adm_tail_plain(pa_ref, pa_dis, egl)
    assert _rel(tail["num"], ptail["num"]) < 2e-4 and _rel(tail["den"], ptail["den"]) < 2e-4
    assert _rel((num + tail["num"]) / (den + tail["den"]), (pn + ptail["num"]) / (pd + ptail["den"])) < 3e-4


def test_quality_kernels_identity(dev):
    from rtvqa_tpu_torch.kernels.adm import adm_scale_cuda, adm_tail_cuda
    from rtvqa_tpu_torch.kernels.quality import quality_fused_cuda
    from rtvqa_tpu_torch.kernels.vif import vif_tail_cuda

    x = _quality_inputs(np.random.default_rng(6), 2, 72, 96, dev)
    ry, ru, rv = x[:3]
    one = (ry[:1], ru[:1], rv[:1])
    blur0 = quality_fused_cuda(*one, *one, x[6])["blur_carry"]
    assert float(quality_fused_cuda(*one, *one, blur0)["sad_sum"][0]) == 0.0
    q = quality_fused_cuda(ry, ru, rv, ry, ru, rv, x[6])
    assert float(q["sse_y"].sum() + q["sse_u"].sum() + q["sse_v"].sum()) == 0.0
    torch.testing.assert_close(q["ssim_y_sum"] / (17 * 23), torch.ones_like(q["ssim_y_sum"]),
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(q["vif_scale0"], torch.ones_like(q["vif_scale0"]), rtol=0, atol=1e-5)
    for v in vif_tail_cuda(q["dec_ref"], q["dec_dis"]).values():
        torch.testing.assert_close(v, torch.ones_like(v), rtol=0, atol=1e-5)
    num, den, a_ref, a_dis = adm_scale_cuda(ry, ry)
    tail = adm_tail_cuda(a_ref, a_dis)
    torch.testing.assert_close(num + tail["num"], den + tail["den"], rtol=1e-6, atol=0)


def test_quality_kernels_repeat_bit_equal(dev):
    from rtvqa_tpu_torch.kernels.adm import adm_scale_cuda, adm_tail_cuda
    from rtvqa_tpu_torch.kernels.quality import quality_fused_cuda
    from rtvqa_tpu_torch.kernels.vif import vif_tail_cuda

    x = _quality_inputs(np.random.default_rng(8), 4, 270, 480, dev)
    runs = []
    for _ in range(2):
        q = quality_fused_cuda(*x)
        out = dict(q)
        out.update(vif_tail_cuda(q["dec_ref"], q["dec_dis"]))
        num, den, a_ref, a_dis = adm_scale_cuda(x[0], x[3])
        tail = adm_tail_cuda(a_ref, a_dis)
        out.update(num=num, den=den, a_ref=a_ref, tnum=tail["num"], tden=tail["den"])
        runs.append(out)
    torch.cuda.synchronize()
    for key in runs[0]:
        assert torch.equal(runs[0][key], runs[1][key]), key


def test_quality_chunk_kernel_body_matches_plain(dev):
    from rtvqa_tpu_torch.metrics.full_reference import CHUNK_KEYS, chunk_kernels, chunk_plain

    x = _quality_inputs(np.random.default_rng(9), 5, 120, 176, dev)
    got, blur_k = chunk_kernels(*x, True)
    want, blur_p = chunk_plain(*x, True)
    torch.cuda.synchronize()
    for i, key in enumerate(CHUNK_KEYS):
        tol = 1e-6 if key.startswith(("mse", "psnr")) else 3e-4
        assert _rel(got[i], want[i]) < tol, key
    torch.testing.assert_close(blur_k, blur_p, rtol=0, atol=1e-4)


# Kernel 4: small and odd frames; the smallest frame each scale takes (H, W
# >= 2^(3-s)+1: 9x9 at scale 0, 5x5, 3x3, 2x2 after), which the scales
# above it refuse; DCI 4K, an unaligned DCI width (u8 and f32 rows that are
# not whole 16-byte pieces: the gathered stage) and 3841, the narrowest
# frame past 3840.
VIF_SCALE_SHAPES = [(3, 48, 64), (2, 53, 71), (2, 9, 9), (2, 5, 5), (2, 3, 3), (2, 2, 2), (2, 2160, 4096),
                    (2, 2160, 4095), (2, 2160, 3841)]


@pytest.mark.parametrize("b,h,w", VIF_SCALE_SHAPES)
@pytest.mark.parametrize("scale", [0, 1, 2, 3])
@pytest.mark.parametrize("egl", [None, 1.0])
def test_vif_scale_kernel_matches_plain(dev, b, h, w, scale, egl):
    """Kernel 4 per scale, on the u8 pair and on its f32 copy; repeat runs
    are bit-identical. A frame smaller than the scale's window is refused."""
    from rtvqa_tpu_torch.kernels.vif import vif_scale_cuda, vif_scale_plain

    x = _quality_inputs(np.random.default_rng(10 + scale), b, h, w, dev)
    if min(h, w) < 2 ** (3 - scale) + 1:
        with pytest.raises(ValueError, match=f"scale {scale} needs"):
            vif_scale_cuda(x[0], x[3], scale, egl)
        return
    for ref, dis in ((x[0], x[3]), (x[0].float(), x[3].float())):
        before = vif_scale_cuda.launches
        got = vif_scale_cuda(ref, dis, scale, egl)
        again = vif_scale_cuda(ref, dis, scale, egl)
        torch.cuda.synchronize()
        assert vif_scale_cuda.launches == before + 2
        want = vif_scale_plain(ref, dis, scale, egl)
        assert _rel(got[0], want[0]) < (2e-4 if scale == 0 else 3e-4)
        assert torch.equal(got[0], again[0])
        if scale == 3:
            assert got[1] is None and got[2] is None
            continue
        for g, a, p in zip(got[1:], again[1:], want[1:]):
            assert g.shape == (b, (h + 1) // 2, (w + 1) // 2)
            torch.testing.assert_close(g, p, rtol=1e-4, atol=1e-3)
            assert torch.equal(g, a)


@pytest.mark.parametrize("content", ["quadrants", "letterbox"])
def test_vif_scale_kernel_flat_content(dev, content):
    """Kernel 4 at DCI 4K on flat quadrants and on letterboxed 2.39:1 scope
    content (4096 x 1716 in a 4096 x 2160 frame: 222-row bars), whose flat
    ref windows send its tiles to the plain-order moments at every scale:
    the four scales chained on the kernel's own planes, each against the
    plain version on the same inputs."""
    from rtvqa_tpu_torch.kernels.vif import vif_scale_cuda, vif_scale_plain

    rng = np.random.default_rng(17)
    b, h, w = 2, 2160, 4096
    if content == "letterbox":
        ref, dis = _letterbox_inputs(rng, b, h, w, dev, bar=222)
    else:
        x = _flat_inputs(rng, b, h, w, (255, 128, 16, 235), dev)
        ref, dis = x[0], x[3]
    for scale in range(4):
        got, want = vif_scale_cuda(ref, dis, scale), vif_scale_plain(ref, dis, scale)
        torch.cuda.synchronize()
        assert _rel(got[0], want[0]) < (2e-4 if scale == 0 else 3e-4), scale
        if scale < 3:
            for g, p in zip(got[1:], want[1:]):
                torch.testing.assert_close(g, p, rtol=1e-4, atol=1e-3)
        ref, dis = got[1], got[2]


def test_vif_features_kernel_identity(dev):
    """Identical ref and dis: VIF 1 at every scale of the four-scale chain."""
    from rtvqa_tpu_torch.kernels.vif import vif_features_cuda

    y = _quality_inputs(np.random.default_rng(12), 2, 72, 96, dev)[0]
    for v in vif_features_cuda(y, y).values():
        torch.testing.assert_close(v, torch.ones_like(v), rtol=0, atol=1e-5)


@pytest.mark.parametrize("b,h,w", [(2, 40, 3856), (2, 2160, 4096)])
def test_wide_chunk_kernel_body_matches_plain(dev, b, h, w):
    """Frames wider than 3840 on the card: the fused route (kernel 3 once,
    the VIF tail, ADM scale 0 + chain; kernel 4 not at all) against the
    plain chunk. The blur carry is kernel 3's, held to its abs 1e-4."""
    from rtvqa_tpu_torch.kernels.quality import quality_fused_cuda
    from rtvqa_tpu_torch.kernels.vif import vif_scale_cuda
    from rtvqa_tpu_torch.metrics.full_reference import CHUNK_KEYS, chunk_kernels, chunk_plain

    x = _quality_inputs(np.random.default_rng(13), b, h, w, dev)
    before = quality_fused_cuda.launches, vif_scale_cuda.launches
    got, blur_k = chunk_kernels(*x, True)
    torch.cuda.synchronize()
    assert (quality_fused_cuda.launches, vif_scale_cuda.launches) == (before[0] + 1, before[1])
    want, blur_p = chunk_plain(*x, True)
    for i, key in enumerate(CHUNK_KEYS):
        tol = 1e-6 if key.startswith(("mse", "psnr")) else 3e-4
        assert _rel(got[i], want[i]) < tol, key
    torch.testing.assert_close(blur_k, blur_p, rtol=0, atol=1e-4)


ADM_INPUT_CASES = [((2, 72, 160), "u8"), ((1, 100, 130), "u8"), ((2, 64, 200), "f32"),
                   ((1, 33, 40), "u8"), ((64, 1080, 1920), "u8")]


@pytest.mark.parametrize("shape,kind", ADM_INPUT_CASES)
def test_adm_input_kernel_matches_plain(dev, shape, kind):
    """Kernel 6a: the checksum, the zero den and planes equal the plain
    version's exactly (u8 sums and eighth-integer f32 sums are exact)."""
    from rtvqa_tpu_torch.kernels.adm import adm_input_cuda, adm_input_plain

    rng = np.random.default_rng(20)
    if kind == "u8":
        ref, dis = (torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(dev) for _ in range(2))
    else:
        ref, dis = (torch.from_numpy((rng.integers(0, 2040, shape) / 8).astype(np.float32)).to(dev)
                    for _ in range(2))
    before = adm_input_cuda.launches
    got = adm_input_cuda(ref, dis)
    torch.cuda.synchronize()
    assert adm_input_cuda.launches == before + 1
    for g, p in zip(got, adm_input_plain(ref, dis)):
        assert g.shape == p.shape and torch.equal(g, p)


# Seeded inputs of kernel 6's per-scale launch: u8 1080p at scale 0, odd u8
# with a gain limit, odd f32 at scale 1.
ADM_DIGEST_CASES = [(30, (2, 1080, 1920), False, None, 0), (31, (2, 50, 71), False, 1.0, 0),
                    (32, (2, 53, 71), True, None, 1)]
# sha256 of the raw outputs of adm.py::_launch on ADM_DIGEST_CASES, as the
# kernel gave them before its staging loop became adm_stage_window: commit
# abb6119's sources, with adm_kernel_digest loaded by path, printed it on an
# H100.
ADM_SCALE_DIGEST = "38fc2b067ccc64a090eecd852a0668d6d005de7c213bdd880e0c82d90503f2ea"


def adm_kernel_digest(dev) -> str:
    """sha256 over the six f32 sums and the two approximation planes of
    every launch in ADM_DIGEST_CASES."""
    import hashlib

    from rtvqa_tpu_torch.kernels.adm import _launch

    digest = hashlib.sha256()
    for seed, shape, as_f32, egl, scale in ADM_DIGEST_CASES:
        x = _quality_inputs(np.random.default_rng(seed), *shape, dev)
        ref, dis = (x[0].float(), x[3].float()) if as_f32 else (x[0], x[3])
        sums, a_ref, a_dis = _launch(ref, dis, scale, egl)
        for t in (*sums, a_ref, a_dis):
            digest.update(t.cpu().numpy().tobytes())
    return digest.hexdigest()


# Kernel 5's inputs, (seed, (b, h1, w1), bar rows, egl): a 1080p chunk's
# scale-1 size, an odd small frame with a gain limit, and a frame whose flat
# bars send tiles to the plain-order retry.
VIF_TAIL_DIGEST_CASES = [(60, (2, 540, 960), 0, None), (61, (2, 25, 36), 0, 1.0), (62, (2, 135, 240), 17, None)]
# sha256 of the (b, 6) f64 sums of vif.py::_tail_sums on VIF_TAIL_DIGEST_CASES,
# as kernel 5 gave them before kernel 4 came to share its stencil: commit
# e0d36da's sources, through vif_tail_kernel_digest, printed it on an H100.
VIF_TAIL_DIGEST = "359c86e9e9f26cc0de75254963b04d4b69d032a44a0db3d43094fb07e81ffcb5"


def vif_tail_digest_inputs(seed, shape, bar):
    """(ref, dis) f32, built in numpy: a gradient plus noise in thirds, dis
    = ref + other noise in thirds, with ``bar`` rows of 16.0 at the top and
    bottom of both."""
    rng = np.random.default_rng(seed)
    b, h, w = shape
    yy, xx = np.mgrid[0:h, 0:w]
    ref = (xx * 0.75 + yy * 0.5)[None] % 224 + rng.integers(0, 32, shape) / 3.0
    dis = ref + rng.integers(-4, 5, shape) / 3.0
    for a in (ref, dis):
        a[:, :bar] = 16.0
        a[:, h - bar:] = 16.0
    return ref.astype(np.float32), dis.astype(np.float32)


def vif_tail_kernel_digest(launch, dev) -> str:
    """sha256 over ``launch(ref, dis, egl)``'s (b, 6) f64 sums on every case
    of VIF_TAIL_DIGEST_CASES."""
    import hashlib

    digest = hashlib.sha256()
    for seed, shape, bar, egl in VIF_TAIL_DIGEST_CASES:
        ref, dis = (torch.from_numpy(a).to(dev) for a in vif_tail_digest_inputs(seed, shape, bar))
        sums = launch(ref, dis, egl)
        assert sums.dtype == torch.float64 and sums.shape == (shape[0], 6)
        digest.update(sums.cpu().numpy().tobytes())
    return digest.hexdigest()


def test_vif_tail_kernel_unchanged(dev):
    """Kernel 5 gives the same bits as before kernel 4 came to share its
    stencil."""
    from rtvqa_tpu_torch.kernels.vif import _tail_sums

    assert vif_tail_kernel_digest(_tail_sums, dev) == VIF_TAIL_DIGEST


def test_adm_scale_kernel_unchanged(dev):
    """Kernel 6 gives the same bits as before kernel 6a came to share its
    input path."""
    assert adm_kernel_digest(dev) == ADM_SCALE_DIGEST


@pytest.mark.parametrize("shape", [(2, 72, 256), (3, 104, 130), (1, 48, 7), (16, 1080, 1920)])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_strip_sum_kernel_matches_plain(dev, shape, dtype):
    """Kernel 8 against its plain version (rel 1e-6, the script's check;
    exact here, as the values are integers), and repeat runs bit-equal."""
    from rtvqa_tpu_torch.kernels.probes import strip_sum_cuda, strip_sum_plain

    x = torch.from_numpy(np.random.default_rng(21).integers(0, 256, shape, np.uint8)).to(dev).to(dtype)
    before = strip_sum_cuda.launches
    got, again = strip_sum_cuda(x), strip_sum_cuda(x)
    torch.cuda.synchronize()
    assert strip_sum_cuda.launches == before + 2
    want = strip_sum_plain(x)
    assert got.shape == (shape[0],) and _rel(got, want) < 1e-6
    assert torch.equal(got, again)
    # An unaligned start: the same frames one byte / element into storage.
    flat = torch.cat([x.new_zeros(1), x.flatten()])
    torch.testing.assert_close(strip_sum_cuda(flat[1:].view(shape)), got, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(2, 104, 256), (3, 152, 131), (128, 1088, 2176)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8])
def test_strip_floor_kernel_matches_plain(dev, shape, dtype):
    """Kernel 9 against its plain version, exactly; a window past H raises."""
    from rtvqa_tpu_torch.kernels.probes import strip_floor_cuda, strip_floor_plain

    gen = torch.Generator(device=dev).manual_seed(22)
    x = (torch.rand(shape, generator=gen, device=dev) * 255.0).to(dtype)
    before = strip_floor_cuda.launches
    got = strip_floor_cuda(x)
    torch.cuda.synchronize()
    assert strip_floor_cuda.launches == before + 1
    assert torch.equal(got, strip_floor_plain(x))
    with pytest.raises(ValueError, match="window"):
        strip_floor_cuda(x[:, :96].contiguous())


@pytest.mark.parametrize("shape", [(16, 1080, 1920), (3, 72, 1919), (3, 72, 1921)])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_strip_sum_kernel_full_and_odd_widths(dev, shape, dtype):
    """Kernel 8 on all-255 1080p frames (the u8 count's headroom) and on odd
    widths, at an aligned base and one byte / element into storage, against
    the plain version at rel 1e-6."""
    from rtvqa_tpu_torch.kernels.probes import strip_sum_cuda, strip_sum_plain

    if shape[2] == 1920:
        x = torch.full(shape, 255, dtype=torch.uint8, device=dev).to(dtype)
    else:
        x = torch.from_numpy(np.random.default_rng(23).integers(0, 256, shape, np.uint8)).to(dev).to(dtype)
    flat = torch.cat([x.new_zeros(1), x.flatten()])
    for frames in (x, flat[1:].view(shape)):
        got = strip_sum_cuda(frames)
        torch.cuda.synchronize()
        assert _rel(got, strip_sum_plain(frames)) < 1e-6


# Kernels 5, 6 and 7 at shapes that cut their tiles unevenly (kernel 6:
# 16 x 32 subband tiles in runs of 4 down a band; kernel 5: 8 x 240 tiles
# of each scale) and at the widths of the 1080p, 1440p and UHD routes.
TAIL_SHAPES = [(2, 50, 71), (1, 33, 40), (3, 1080, 1920), (4, 1440, 2560), (2, 2160, 3840)]


def _scale1(x):
    """The VIF scale-1 input of a luma plane: the 9-tap filter, even rows and
    columns kept (what kernel 3 writes)."""
    from rtvqa_tpu_torch.kernels.vif import TAPS
    from rtvqa_tpu_torch.vmaf.filters import decimate2, filter1d_sep

    return decimate2(filter1d_sep(x.float(), TAPS[1])).contiguous()


def _letterbox_inputs(rng, b, h, w, dev, bar=None):
    """Gradient + noise luma, dis = ref + noise, with black bars (Y 16) of
    ``bar`` rows (default 138/1080 of them) at the top and bottom, equal in
    ref and dis."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((xx * 3 + yy * 2)[None] + 7 * np.arange(b)[:, None, None]) % 256
    ref = np.clip(base + rng.integers(0, 8, (b, h, w)), 0, 255).astype(np.uint8)
    dis = np.clip(ref.astype(np.int16) + rng.integers(-4, 5, (b, h, w)), 0, 255).astype(np.uint8)
    bar = bar or max(1, 138 * h // 1080)
    for a in (ref, dis):
        a[:, :bar] = 16
        a[:, h - bar:] = 16
    return torch.from_numpy(ref).to(dev), torch.from_numpy(dis).to(dev)


def _check_tail_kernels(ry, dy, egl=None):
    """Kernels 5, 6 and 7 on a luma pair against their plain versions
    (module docstring's tolerances); kernel 5 on the pair's scale-1 input.
    Each wrapper launches once per call, and a repeat call gives the same
    bits."""
    from rtvqa_tpu_torch.kernels.adm import adm_scale_cuda, adm_scale_plain, adm_tail_cuda, adm_tail_plain
    from rtvqa_tpu_torch.kernels.vif import vif_tail_cuda, vif_tail_plain

    dec = (_scale1(ry), _scale1(dy))
    before = vif_tail_cuda.launches, adm_scale_cuda.launches, adm_tail_cuda.launches
    vk = vif_tail_cuda(*dec, egl=egl)
    num, den, a_ref, a_dis = adm_scale_cuda(ry, dy, 0, egl)
    tk = adm_tail_cuda(a_ref, a_dis, egl)
    torch.cuda.synchronize()
    assert (vif_tail_cuda.launches, adm_scale_cuda.launches, adm_tail_cuda.launches) == tuple(
        n + 1 for n in before)
    vp = vif_tail_plain(*dec, egl=egl)
    for key in vp:
        assert _rel(vk[key], vp[key]) < 3e-4, key
    pn, pd, pa_ref, pa_dis = adm_scale_plain(ry, dy, 0, egl)
    assert _rel(num, pn) < 2e-4 and _rel(den, pd) < 2e-4
    torch.testing.assert_close(a_ref, pa_ref, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(a_dis, pa_dis, rtol=1e-4, atol=1e-3)
    # Kernel 7 on the kernel's own bands, as the chunk runs it.
    tp = adm_tail_plain(a_ref, a_dis, egl)
    assert _rel(tk["num"], tp["num"]) < 2e-4 and _rel(tk["den"], tp["den"]) < 2e-4
    assert _rel((num + tk["num"]) / (den + tk["den"]), (pn + tp["num"]) / (pd + tp["den"])) < 3e-4
    again = vif_tail_cuda(*dec, egl=egl), adm_scale_cuda(ry, dy, 0, egl), adm_tail_cuda(a_ref, a_dis, egl)
    torch.cuda.synchronize()
    for key in vk:
        assert torch.equal(vk[key], again[0][key]), key
    for g, a in zip((num, den, a_ref, a_dis), again[1]):
        assert torch.equal(g, a)
    for key in tk:
        assert torch.equal(tk[key], again[2][key]), key


@pytest.mark.parametrize("b,h,w", TAIL_SHAPES)
@pytest.mark.parametrize("egl", [None, 1.0])
def test_tail_kernels_uneven_tiles(dev, b, h, w, egl):
    x = _quality_inputs(np.random.default_rng(40), b, h, w, dev)
    _check_tail_kernels(x[0], x[3], egl)


@pytest.mark.parametrize("b,h,w", [(2, 270, 480), (2, 1080, 1920)])
@pytest.mark.parametrize("content", ["quadrants", "white", "letterbox"])
def test_tail_kernels_flat_content(dev, b, h, w, content):
    """Flat and letterboxed frames, whose flat ref windows at scales 1-3
    send kernel 5's tiles to the plain-order moments, and give kernel 6 and
    7 constant bands."""
    rng = np.random.default_rng(41)
    if content == "letterbox":
        ry, dy = _letterbox_inputs(rng, b, h, w, dev)
    else:
        levels = (255, 128, 16, 235) if content == "quadrants" else (255, 255, 255, 255)
        x = _flat_inputs(rng, b, h, w, levels, dev)
        ry, dy = x[0], x[3]
    _check_tail_kernels(ry, dy)


@pytest.mark.parametrize("shape", [(2, 50, 71), (2, 64, 482), (1, 1080, 1921)])
@pytest.mark.parametrize("wrapper", ["adm_scale", "adm_tail"])
def test_adm_scale_kernel_f32_unaligned(dev, shape, wrapper):
    """The ADM kernel on f32 frames whose rows are not whole 16-byte pieces,
    and on aligned-width frames one element into storage: the gathered
    stage, against the plain version. Through adm_scale_cuda at scale 1
    (kernel 6 on f32, as ADM_DIGEST_CASES launches it) and adm_tail_cuda
    (kernel 7, the f32 launches of the quality route)."""
    from rtvqa_tpu_torch.kernels.adm import adm_scale_cuda, adm_scale_plain, adm_tail_cuda, adm_tail_plain

    x = _quality_inputs(np.random.default_rng(42), *shape, dev)
    ref, dis = x[0].float(), x[3].float()
    b, h, w = shape
    even = w - w % 4
    store = torch.zeros(2, b * h * even + 1, device=dev)
    store[0, 1:] = ref[..., :even].flatten()
    store[1, 1:] = dis[..., :even].flatten()
    cases = [(ref, dis), (store[0, 1:].view(b, h, even), store[1, 1:].view(b, h, even))]
    for r, d in cases:
        if wrapper == "adm_tail":
            got, want = adm_tail_cuda(r, d), adm_tail_plain(r, d)
            torch.cuda.synchronize()
            assert _rel(got["num"], want["num"]) < 2e-4 and _rel(got["den"], want["den"]) < 2e-4
            continue
        got, want = adm_scale_cuda(r, d, 1), adm_scale_plain(r, d, 1)
        torch.cuda.synchronize()
        assert _rel(got[0], want[0]) < 2e-4 and _rel(got[1], want[1]) < 2e-4
        for g, p in zip(got[2:], want[2:]):
            torch.testing.assert_close(g, p, rtol=1e-4, atol=1e-3)


def test_chunk_kernels_match_synthetic_golden(dev):
    """ROADMAP C1: the kernel chunk on camera-plausible 1080p frames (flat
    squares and chroma) against the golden frozen from the JAX package's CPU
    chunk path, within ROADMAP C's tolerances: MSE/PSNR rel 1e-6 (integer
    sums), SSIM abs 1e-4, motion SAD rel 1e-5 / abs 1e-5 (kernel 3's SAD
    tolerance), VIF and ADM rel 3e-4."""
    import importlib.util
    import os

    from rtvqa_tpu_torch.metrics.full_reference import CHUNK_KEYS, chunk_kernels

    # Loaded by path: the card's machine runs this file without the tests package.
    spec = importlib.util.spec_from_file_location(
        "torch_synthetic_golden", os.path.join(os.path.dirname(__file__), "test_torch_synthetic_golden.py"))
    g = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(g)
    golden = np.load(g.GOLDEN_PATH)
    ref, dis = g.make_pair()
    assert g.digest(ref) == str(golden["digest_ref"]) and g.digest(dis) == str(golden["digest_dis"])
    planes = [torch.from_numpy(a).to(dev) for a in (*ref, *dis)]
    packed, _ = chunk_kernels(*planes, torch.zeros((g.H, g.W), device=dev), False)
    tols = {"mse": (1e-6, 0.0), "psnr": (1e-6, 0.0), "ssim": (0.0, 1e-4), "motion": (1e-5, 1e-5),
            "vif": (3e-4, 0.0), "adm": (3e-4, 0.0)}
    worst = g.check_golden(packed.cpu().numpy(), golden, CHUNK_KEYS, tols)
    print(f"max rel errors against the golden: {worst}")


# --- the JAX package's API on the card ---------------------------------------


@pytest.mark.parametrize("shape", [(64, 96), (75, 101)])
def test_pairwise_pyramid_kernel_route_matches_plain(dev, shape):
    """ops/motion.py::block_match_motion_pyramid on CUDA tensors: kernel 2,
    the leading dimensions folded into its batch; equal to the series form
    on the same pairs, and to the plain search: exactly on integer-valued
    frames, rel 5e-3 on smoothed ones (near-tie argmins)."""
    from rtvqa_tpu_torch.kernels.motion import block_match_motion_cuda
    from rtvqa_tpu_torch.ops.motion import (
        block_match_motion,
        block_match_motion_pyramid,
        block_match_motion_pyramid_series,
        down2_mean,
    )

    rng = np.random.default_rng(40)
    tex = rng.integers(0, 256, (shape[0] + 32, shape[1] + 32))
    integer = np.stack([np.roll(tex, (2 * i, -4 * i), (0, 1))[: shape[0], : shape[1]] for i in range(7)])
    smooth = torch.nn.functional.avg_pool2d(torch.from_numpy(integer.astype(np.float32))[:, None], 3, 1, 1)
    for frames, rtol in ((integer.astype(np.float32), 0.0), (smooth[:, 0].numpy() / 3.0, 5e-3)):
        g = torch.from_numpy(np.ascontiguousarray(frames)).to(dev)
        before = block_match_motion_cuda.launches
        got = block_match_motion_pyramid(g[:-1], g[1:])
        torch.cuda.synchronize()
        assert block_match_motion_cuda.launches == before + 1
        assert torch.equal(got, block_match_motion_pyramid_series(g, impl="kernel"))
        plain = 2.0 * block_match_motion(down2_mean(g[:-1]), down2_mean(g[1:]), 8, 4)
        torch.testing.assert_close(got, plain, rtol=rtol, atol=0)
        folded = block_match_motion_pyramid(g[:-1].reshape(2, 3, *shape), g[1:].reshape(2, 3, *shape))
        assert folded.shape == (2, 3) and torch.equal(folded.reshape(-1), got)


def _api_clip(rng, n, h, w, dis: bool):
    from rtvqa_tpu_torch.io.video import DecodedClip

    yy, xx = np.mgrid[0:h, 0:w]
    y = np.stack([128 + 60 * np.sin(xx / 5.0 + i) * np.cos(yy / 7.0) + rng.normal(0, 12, (h, w))
                  for i in range(n)])
    y = np.clip(y, 0, 255).astype(np.uint8)
    if dis:
        y = np.clip(y.astype(np.int16) + rng.integers(-6, 7, y.shape), 0, 255).astype(np.uint8)
    u = rng.integers(90, 170, (n, h // 2, w // 2), np.uint8)
    return DecodedClip(y=y, u=u, v=u.copy(), timestamps_ms=np.arange(n) * 40.0, width=w, height=h,
                       n_frames_total=n, bit_rate=0, avg_fps=25.0)


@pytest.mark.parametrize("shape", [(72, 128), (1080, 1920)])
def test_extract_features_kernel_route_matches_plain(dev, shape):
    """vmaf/predictor.py on the card: kernels 4, 6 and 7 against the plain
    route on the same device, VIF/ADM rel 3e-4, motion rel 1e-6; the chunk
    size moves no value; compute_vmaf runs on the card by default."""
    from rtvqa_tpu_torch.kernels.adm import adm_scale_cuda, adm_tail_cuda
    from rtvqa_tpu_torch.kernels.vif import vif_scale_cuda
    from rtvqa_tpu_torch.vmaf.model import builtin_model
    from rtvqa_tpu_torch.vmaf.predictor import FRAME_KEYS, compute_vmaf, extract_features

    rng = np.random.default_rng(42)
    ref, dis = _api_clip(rng, 5, *shape, False), _api_clip(rng, 5, *shape, True)
    before = vif_scale_cuda.launches, adm_scale_cuda.launches, adm_tail_cuda.launches
    got = extract_features(ref, dis, chunk=2, device=dev)
    assert (vif_scale_cuda.launches, adm_scale_cuda.launches, adm_tail_cuda.launches) == (
        before[0] + 12, before[1] + 3, before[2] + 3)
    want = extract_features(ref, dis, impl="plain", device=dev)
    for key in FRAME_KEYS:
        assert _rel(torch.from_numpy(got[key]), torch.from_numpy(want[key])) < 3e-4, key
    for key in ("motion", "motion2"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)
    for again in (extract_features(ref, dis, device=dev), extract_features(ref, dis, chunk=3, device="cuda")):
        for key, value in got.items():
            np.testing.assert_array_equal(again[key], value, err_msg=key)
    score = compute_vmaf(ref, dis)
    assert score == pytest.approx(float(builtin_model().predict(got).numpy().mean()), abs=1e-5)


def test_orb_features_card_matches_cpu(dev):
    """ops/orb.py on the card against the CPU on non-integer frames: the
    ops are elementwise, shifts and a stable sort (angles through float64),
    so keypoints, scores and descriptors are equal."""
    from rtvqa_tpu_torch.ops.orb import orb_features

    rng = np.random.default_rng(43)
    yy, xx = np.mgrid[0:240, 0:320]
    g = np.stack([(xx * 0.37 + yy * 0.23 + 9 * i) % 256 + rng.uniform(0, 8, (240, 320)) for i in range(3)])
    for frame in g:
        for _ in range(60):
            cy, cx, s = rng.integers(8, 232), rng.integers(8, 312), rng.integers(3, 7)
            frame[cy - s:cy + s, cx - s:cx + s] = rng.uniform(0, 255)
    g = torch.from_numpy(g.astype(np.float32))
    got = orb_features(g.to(dev), k=200)
    want = orb_features(g, k=200)
    assert int(want["valid"].sum()) > 100
    for key, w in want.items():
        if key == "angle":
            torch.testing.assert_close(got[key].cpu(), w, rtol=0, atol=1e-5)
        else:
            assert torch.equal(got[key].cpu(), w), key


def _batches(planes, chunk):
    from rtvqa_tpu_torch.io.stream import FrameBatch

    n = planes[0].shape[0]
    for s in range(0, n, chunk):
        k = min(chunk, n - s)
        yield FrameBatch(*(a[s:s + k] for a in planes), (s + np.arange(k)) * 40.0, s)


@pytest.mark.parametrize("n", [1, 30, 64, 94])
def test_staged_tails_are_padded_on_the_card(dev, n):
    """1080p batches staged at chunk 64 on a prefetch thread: every plane
    on the card is the batch's frames then copies of its last, byte for
    byte, whole chunks and ragged tails alike."""
    from rtvqa_tpu_torch.io.stream import prefetch, stage_to_device

    rng = np.random.default_rng(n)
    planes = (rng.integers(0, 256, (n, 1080, 1920), dtype=np.uint8),
              *(rng.integers(0, 256, (n, 540, 960), dtype=np.uint8) for _ in range(2)))
    it = prefetch(stage_to_device(_batches(planes, 64), 64, dev), depth=1)
    try:
        got = list(it)
    finally:
        it.close()
    assert len(got) == -(-n // 64)
    for sb in got:
        k = sb.host.y.shape[0]
        for a, p in zip((sb.host.y, sb.host.u, sb.host.v), (sb.y, sb.u, sb.v)):
            assert p.device.type == dev.type and p.shape[0] == 64
            want = np.concatenate([a, np.repeat(a[-1:], 64 - k, 0)])
            assert p.cpu().numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("merged", [False, True])
def test_chunk_loop_on_the_card_pads_tails_as_the_host_did(dev, merged):
    """The combined loop on the kernels over 11 frames at chunk 4: tails
    staged and padded on the card give the series and complexity of
    chunks repeat-padded on the host, bit for bit."""
    from rtvqa_tpu_torch.io.stream import StagedFrameBatch, prefetch, stage_to_device, upload
    from rtvqa_tpu_torch.metrics.complexity_streaming import ComplexityAccumulator
    from rtvqa_tpu_torch.metrics.full_reference import combined_chunk_loop

    rng = np.random.default_rng(7)
    ref = (rng.integers(0, 256, (11, 64, 96), dtype=np.uint8),
           *(rng.integers(0, 256, (11, 32, 48), dtype=np.uint8) for _ in range(2)))
    dis = (np.clip(ref[0].astype(np.int16) + rng.integers(-6, 7, ref[0].shape), 0, 255).astype(np.uint8),
           *ref[1:])

    def host_padded(side):
        for fb in _batches(side, 4):
            pad = 4 - fb.y.shape[0]
            yield StagedFrameBatch(fb, *(upload(np.concatenate([a, np.repeat(a[-1:], pad, 0)]), dev)
                                         for a in (fb.y, fb.u, fb.v)))

    def run(stage):
        acc = ComplexityAccumulator(32, 32, 0.8, 4, device=dev)
        its = [stage(side) for side in (ref, dis)]
        try:
            return combined_chunk_loop(*its, 4, acc, 1 if merged else 2, "dis", None, None, dev, "kernel", merged)
        finally:
            for it in its:
                it.close()

    want = run(host_padded)
    got = run(lambda side: prefetch(stage_to_device(_batches(side, 4), 4, dev), depth=1))
    assert got[1] == want[1] == 11
    for key, w in want[0].items():
        np.testing.assert_array_equal(got[0][key], w, err_msg=key)
    assert got[2] == want[2]


def test_merged_step_at_dci_4k_matches_the_cpu_plain_path(dev):
    """The merged step on a 14 x 2160 x 4096 chunk (``chunk_combined``: the
    fused route, then the accumulator's suite on the dis planes with carried
    tail frames) on the card against the same inputs through the plain
    path on the CPU: the 16 quality rows at the wide chunk test's
    tolerances, the 7 complexity rows at the suite's (motion rel 5e-3,
    the others 1e-4); one ``quality_fused_cuda`` launch and no
    ``vif_scale_cuda`` a chunk."""
    from rtvqa_tpu_torch.kernels.quality import quality_fused_cuda
    from rtvqa_tpu_torch.kernels.vif import vif_scale_cuda
    from rtvqa_tpu_torch.metrics.complexity_streaming import VALUE_KEYS, ComplexityAccumulator
    from rtvqa_tpu_torch.metrics.full_reference import CHUNK_KEYS, auto_chunk, chunk_combined

    h, w = 2160, 4096
    b = auto_chunk(w, h)
    assert b == 14
    rng = np.random.default_rng(16)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (3 * xx + 2 * yy) % 256
    ry = np.stack([np.clip((base + 5 * k) % 256 + rng.integers(0, 8, (h, w)), 0, 255) for k in range(b + 1)])
    ry = ry.astype(np.uint8)
    ru, rv = (rng.integers(100, 156, (b + 1, h // 2, w // 2), np.uint8) for _ in range(2))
    dy, du, dv = (np.clip(a.astype(np.int16) + rng.integers(-4, 5, a.shape), 0, 255).astype(np.uint8)
                  for a in (ry, ru, rv))
    prev_blur = (rng.random((h, w)) * 255).astype(np.float32)
    # Frame 0 is the carried tail (the last dis frame of a chunk before); frames 1..b the chunk.
    chunk = [torch.from_numpy(np.ascontiguousarray(a[1:])) for a in (ry, ru, rv, dy, du, dv)]
    tails = [torch.from_numpy(np.ascontiguousarray(a[0])) for a in (dy, du, dv)]
    blur = torch.from_numpy(prev_blur)

    def step(device, impl):
        suite = ComplexityAccumulator(64, 64, 0.8, 128, device=device).suite(h, w)
        out = chunk_combined(*(t.to(device) for t in chunk), blur.to(device), True,
                             *(t.to(device) for t in tails), suite=suite, impl=impl)
        return [t.cpu() if t is not None else None for t in out]

    before = quality_fused_cuda.launches, vif_scale_cuda.launches
    got = step(dev, "kernel")
    torch.cuda.synchronize()
    assert (quality_fused_cuda.launches, vif_scale_cuda.launches) == (before[0] + 1, before[1])
    want = step(torch.device("cpu"), "plain")
    assert got[0].shape == want[0].shape == (len(CHUNK_KEYS) + len(VALUE_KEYS), b)
    for i, key in enumerate(CHUNK_KEYS):
        tol = 1e-6 if key.startswith(("mse", "psnr")) else 3e-4
        assert _rel(got[0][i], want[0][i]) < tol, key
    for j, key in enumerate(VALUE_KEYS):
        tol = 5e-3 if key == "motion" else 1e-4
        g, p = got[0][len(CHUNK_KEYS) + j].double(), want[0][len(CHUNK_KEYS) + j].double()
        assert bool(((g - p).abs() <= tol * p.abs().clamp_min(1e-12)).all()), (key, g, p)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-4)  # the blur carry
    for g, p in zip(got[2:], want[2:]):
        assert torch.equal(g, p)  # the next chunk's tails: the last dis frame
