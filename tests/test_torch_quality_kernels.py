"""The quality chunk's CUDA kernels: their plain versions vs the Pallas
kernels they replace, and the wrappers' CPU/CUDA routing.

VIF at one scale (``vif_scale_plain``, kernel 4's plain version) is held to
the acceptance tolerances of the JAX package's own tests: rel 2e-4 at scale
0 and 3e-4 at scales 1-3, the next scale's planes at rel 1e-4 / abs 1e-3.

The Pallas kernels run in interpret mode on the CPU, with exact f32
filters (``fast3=False``), as tests/test_quality_pallas.py runs them. On a
CPU tensor each CUDA wrapper takes its plain version; on any other device
that is not CUDA it raises, and it never falls back.

Tolerances: the SSEs are integer sums (equal); SSIM window sums rel 1e-6
(per-window f32 rationals, summed in another order); the blur SAD, blur
carry and decimated planes rel 1e-5 / abs 1e-4 (f32 ULPs of the tap
chain); VIF and ADM rel 3e-4 against the Pallas kernels (their banded MXU
filters and per-strip partial sums).
"""

import numpy as np
import pytest
import torch

from rtvqa_tpu.kernels.adm_pallas import adm_scale_pallas, adm_tail_pallas
from rtvqa_tpu.kernels.quality_pallas import quality_fused_pallas
from rtvqa_tpu.kernels.vif_pallas import vif_features_pallas, vif_scale_pallas, vif_tail_pallas
from rtvqa_tpu_torch.kernels import _build
from rtvqa_tpu_torch.kernels.adm import (
    adm_scale_cuda,
    adm_scale_plain,
    adm_tail_cuda,
    adm_tail_plain,
)
from rtvqa_tpu_torch.kernels.quality import quality_fused_cuda, quality_fused_plain
from rtvqa_tpu_torch.kernels.vif import (
    vif_features_cuda,
    vif_features_plain,
    vif_scale_cuda,
    vif_scale_plain,
    vif_tail_cuda,
    vif_tail_plain,
)
from tests.test_torch_quality import rel_err, t, yuv_pair

torch.set_num_threads(1)

CASES = [((48, 64), None), ((48, 64), 1.0), ((50, 70), None), ((50, 70), 1.0)]
EXACT = ("sse_y", "sse_u", "sse_v")
RTOL = {"ssim_y_sum": 1e-6, "ssim_u_sum": 1e-6, "ssim_v_sum": 1e-6, "vif_scale0": 3e-4}


@pytest.fixture(scope="module")
def quality_cases():
    """Per case: inputs, the Pallas outputs and the plain outputs (shared by
    the tests below, so each interpret-mode kernel runs once per case)."""
    rng = np.random.default_rng(7)
    out = {}
    for shape, egl in CASES:
        planes = yuv_pair(rng, 2, *shape)
        prev_blur = (rng.random(shape) * 255).astype(np.float32)
        want = quality_fused_pallas(*planes, prev_blur, egl=egl, interpret=True, fast3=False)
        got = quality_fused_plain(*map(t, planes), t(prev_blur), egl=egl)
        out[(shape, egl)] = (planes, prev_blur, want, got)
    return out


@pytest.mark.parametrize("shape,egl", CASES)
def test_quality_plain_matches_pallas(quality_cases, shape, egl):
    _, _, want, got = quality_cases[(shape, egl)]
    assert set(got) == set(want)
    for key in want:
        w, g = np.asarray(want[key]), got[key].numpy()
        assert g.shape == w.shape, key
        if key in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=key)
        elif key in RTOL:
            assert rel_err(g, w) < RTOL[key], key
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("shape,egl", CASES)
def test_vif_tail_plain_matches_pallas(quality_cases, shape, egl):
    _, _, want_q, got_q = quality_cases[(shape, egl)]
    want = vif_tail_pallas(want_q["dec_ref"], want_q["dec_dis"], egl=egl, interpret=True, fast3=False)
    got = vif_tail_plain(got_q["dec_ref"], got_q["dec_dis"], egl=egl)
    for key in want:
        assert rel_err(got[key].numpy(), want[key]) < 3e-4, key


@pytest.mark.parametrize("shape,egl", CASES)
def test_adm_plain_matches_pallas(quality_cases, shape, egl):
    planes = quality_cases[(shape, egl)][0]
    ry, dy = planes[0], planes[3]
    jn, jd, jar, jad = adm_scale_pallas(ry, dy, 0, egl=egl, interpret=True)
    tn, td, tar, tad = adm_scale_plain(t(ry), t(dy), 0, egl)
    assert rel_err(tn.numpy(), jn) < 3e-4 and rel_err(td.numpy(), jd) < 3e-4
    np.testing.assert_allclose(tar.numpy(), np.asarray(jar), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(tad.numpy(), np.asarray(jad), rtol=1e-5, atol=1e-3)
    want = adm_tail_pallas(jar, jad, egl=egl, interpret=True)
    got = adm_tail_plain(tar, tad, egl)
    assert rel_err(got["num"].numpy(), want["num"]) < 3e-4
    assert rel_err(got["den"].numpy(), want["den"]) < 3e-4


VIF_SCALE_CASES = [  # (dtype, egl, (h, w)): u8 and f32, egl None and 1.0, one odd size
    (np.uint8, None, (48, 64)),
    (np.float32, 1.0, (48, 64)),
    (np.uint8, 1.0, (53, 71)),
]


@pytest.mark.parametrize("scale", [0, 1, 2, 3])
@pytest.mark.parametrize("dtype,egl,shape", VIF_SCALE_CASES)
def test_vif_scale_plain_matches_pallas(scale, dtype, egl, shape):
    rng = np.random.default_rng(31 + scale)
    ry, _, _, dy, _, _ = yuv_pair(rng, 2, *shape)
    ref, dis = ry.astype(dtype), dy.astype(dtype)
    want = vif_scale_pallas(ref, dis, scale, egl=egl, interpret=True, fast3=False, crop=True)
    got = vif_scale_plain(t(ref), t(dis), scale, egl)
    assert rel_err(got[0].numpy(), want[0]) < (2e-4 if scale == 0 else 3e-4)
    if scale == 3:
        assert got[1] is None and got[2] is None and want[1] is None
        return
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == w.shape == (2, (shape[0] + 1) // 2, (shape[1] + 1) // 2)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("egl", [None, 1.0])
def test_vif_features_cuda_on_cpu_matches_pallas(egl):
    """The four-scale chain: on CPU tensors ``vif_features_cuda`` is its
    plain version, held against ``vif_features_pallas`` (interpret mode)."""
    rng = np.random.default_rng(37)
    ry, _, _, dy, _, _ = yuv_pair(rng, 2, 56, 70)
    want = vif_features_pallas(ry.astype(np.float32), dy.astype(np.float32), enhn_gain_limit=egl,
                               fast3=False)
    got = vif_features_cuda(t(ry), t(dy), egl)
    plain = vif_features_plain(t(ry), t(dy), egl)
    for k in range(4):
        key = f"vif_scale{k}"
        assert torch.equal(got[key], plain[key]), key
        assert rel_err(got[key].numpy(), want[key]) < (2e-4 if k == 0 else 3e-4), key


def test_identity_pair(rng):
    """Identical ref and dis: SSE 0, SSIM 1, VIF 1 at every scale, ADM
    num = den; frame 0's SAD against its own blur is 0."""
    planes = yuv_pair(rng, 2, 48, 64)
    ry, ru, rv = map(t, planes[:3])
    one = (ry[:1], ru[:1], rv[:1])
    blur0 = quality_fused_plain(*one, *one, torch.zeros(48, 64))["blur_carry"]
    first = quality_fused_plain(*one, *one, blur0)
    assert float(first["sad_sum"][0]) == 0.0
    q = quality_fused_plain(ry, ru, rv, ry, ru, rv, blur0)
    assert float(q["sse_y"].sum() + q["sse_u"].sum() + q["sse_v"].sum()) == 0.0
    np.testing.assert_allclose(q["ssim_y_sum"].numpy() / ((48 // 4 - 1) * (64 // 4 - 1)), 1.0, atol=1e-6)
    np.testing.assert_allclose(q["vif_scale0"].numpy(), 1.0, atol=1e-5)
    for v in vif_tail_plain(q["dec_ref"], q["dec_dis"]).values():
        np.testing.assert_allclose(v.numpy(), 1.0, atol=1e-5)
    num, den, a_ref, a_dis = adm_scale_plain(ry, ry)
    tail = adm_tail_plain(a_ref, a_dis)
    np.testing.assert_allclose((num + tail["num"]).numpy(), (den + tail["den"]).numpy(), rtol=1e-6)


def test_wrappers_on_cpu_are_plain(rng):
    planes = tuple(map(t, yuv_pair(rng, 2, 24, 40)))
    blur = torch.zeros(24, 40)
    counts = [k.launches for k in (quality_fused_cuda, vif_tail_cuda, adm_scale_cuda, adm_tail_cuda,
                                   vif_scale_cuda)]
    q, qp = quality_fused_cuda(*planes, blur), quality_fused_plain(*planes, blur)
    for key in qp:
        assert torch.equal(q[key], qp[key]), key
    for key, v in vif_tail_cuda(q["dec_ref"], q["dec_dis"]).items():
        assert torch.equal(v, vif_tail_plain(q["dec_ref"], q["dec_dis"])[key])
    a = adm_scale_cuda(planes[0], planes[3])
    for x, y in zip(a, adm_scale_plain(planes[0], planes[3])):
        assert torch.equal(x, y)
    for key, v in adm_tail_cuda(a[2], a[3]).items():
        assert torch.equal(v, adm_tail_plain(a[2], a[3])[key])
    for scale in range(4):
        for x, y in zip(vif_scale_cuda(planes[0], planes[3], scale), vif_scale_plain(planes[0], planes[3], scale)):
            assert (x is None and y is None) or torch.equal(x, y)
    wrappers = (quality_fused_cuda, vif_tail_cuda, adm_scale_cuda, adm_tail_cuda, vif_scale_cuda)
    assert counts == [k.launches for k in wrappers]


def test_wrappers_refuse_non_cuda_devices():
    # Neither on the CPU nor on a card: the kernel route, which checks the
    # device and raises instead of falling back.
    y = torch.empty((1, 16, 16), dtype=torch.uint8, device="meta")
    c = torch.empty((1, 8, 8), dtype=torch.uint8, device="meta")
    f = torch.empty((1, 16, 16), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        quality_fused_cuda(y, c, c, y, c, c, f[0])
    with pytest.raises(ValueError, match="CUDA"):
        vif_tail_cuda(f, f)
    with pytest.raises(ValueError, match="CUDA"):
        adm_scale_cuda(y, y)
    with pytest.raises(ValueError, match="CUDA"):
        adm_tail_cuda(f, f)
    with pytest.raises(ValueError, match="CUDA"):
        vif_scale_cuda(y, y, 0)


def test_kernel_sources_are_built():
    names = {p.name for p in _build._sources()}
    assert {"quality.cu", "vif.cu", "adm.cu"} <= names
    assert "common.cuh" in {p.name for p in _build._headers()}
