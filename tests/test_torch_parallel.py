"""The port's multi-device paths (``rtvqa_tpu_torch/parallel/``,
``pipeline/quality_sharded.py``, ``pipeline/batch_analyzer.py``,
``pipeline/sweep.py::run_sweep_sharded``) on gloo across spawned CPU
processes, against the JAX package's sharded and single-device functions on
the conftest's 8-device CPU mesh and against the port's own single-device
bodies.

The ``_w_*`` functions run in the spawned ranks (``parallel/launch.py::
spawn``) and import nothing of jax; this module imports jax and the JAX
package only inside the tests, which run in the test process. Each world is
spawned once per module (fixtures) and joined with a timeout, so a hang
fails its tests instead of the run. Inputs are the JAX tests' own, made
with numpy from their seeds.

Tolerances: the JAX tests' own. The complexity suite against JAX's sharded
and single-device suites rel = abs = 2e-4 (``tests/test_sharding.py``);
the quality chunk step bit-equal to the port's ``chunk_plain`` on the same
padded chunk except vif_scale3/adm2 (rtol 2e-4, atol 1e-6), as
``test_sharded_quality.py`` holds JAX's step against its single-device
body, and rtol = atol = 2e-4 against JAX's sharded step; the sharded engine
against the streaming engine: PSNR abs 1e-4, SSIM abs 1e-6, motion2 rtol
1e-4 / atol 1e-5, VIF/ADM rtol 2e-4 / atol 1e-5; batched complexity against
per-clip analysis rel 1e-6 (the same ops on the same frames); sweep rows
against ``run_sweep``'s rtol 2e-3 / atol 1e-5 (``test_sweep_sharded.py``).
"""

import dataclasses
import json
import os
from fractions import Fraction

import numpy as np
import pytest
import torch

from rtvqa_tpu_torch.parallel import launch

torch.set_num_threads(1)

SPAWN_TIMEOUT = 150.0
QUALITY_SHAPES = dict(n=13, h=34, w=52, chunk=8)   # tests/test_sharded_quality.py awkward case
STEP_RANKS = 4


# --- inputs (the JAX tests' recipes) ------------------------------------------


def make_inputs(c=2, n=16, h=32, w=48, seed=0):
    """tests/test_sharding.py::make_inputs."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, (c, n, h, w), np.uint8)
    u = rng.integers(0, 256, (c, n, h // 2, w // 2), np.uint8)
    v = rng.integers(0, 256, (c, n, h // 2, w // 2), np.uint8)
    ts = (np.arange(n, dtype=np.float32) * 100.0)[None, :].repeat(c, 0)
    n_valid = np.array([n, n - 3], np.int32)
    return y, u, v, ts, n_valid


def quality_inputs(n, h, w, chroma_dis=True):
    """The planes of tests/test_sharded_quality.py's step tests, from their
    ``rng`` fixture (seed 1234) in their draw order."""
    rng = np.random.default_rng(1234)
    hc, wc = h // 2, w // 2
    ry = rng.integers(0, 256, (n, h, w), np.uint8)
    ru = rng.integers(0, 256, (n, hc, wc), np.uint8)
    rv = rng.integers(0, 256, (n, hc, wc), np.uint8)
    dy = np.clip(ry.astype(np.int16) + rng.integers(-9, 10, ry.shape), 0, 255).astype(np.uint8)
    if not chroma_dis:
        return ry, ru, rv, dy, ru, rv
    du = np.clip(ru.astype(np.int16) + rng.integers(-9, 10, ru.shape), 0, 255).astype(np.uint8)
    return ry, ru, rv, dy, du, rv.copy()


def padded_chunks(planes, chunk):
    """The awkward case's chunks, repeat-padded as the streaming loop pads."""
    n = planes[0].shape[0]
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        yield tuple(np.concatenate([a[lo:hi], np.repeat(a[hi - 1:hi], chunk - (hi - lo), 0)])
                    for a in planes)


def _local(a, c_idx, f_idx, shape, c_axis=True):
    """Rank (c_idx, f_idx)'s block of a (C, N, ...) array over a ``shape`` mesh
    (``c_axis`` False: a (N, ...) array sharded over frames only)."""
    if not c_axis:
        per = a.shape[0] // shape[1]
        return torch.from_numpy(np.ascontiguousarray(a[f_idx * per:(f_idx + 1) * per]))
    cl, fl = a.shape[0] // shape[0], a.shape[1] // shape[1]
    return torch.from_numpy(np.ascontiguousarray(a[c_idx * cl:(c_idx + 1) * cl, f_idx * fl:(f_idx + 1) * fl]))


# --- workers (run in the spawned ranks) -----------------------------------------


def _w_tensor_paths():
    """World 4: meshes, the complexity suite on 2x2 and 1x4, the quality
    chunk step on the awkward case, the whole-clip step, and a step that
    fails on one rank."""
    import torch.distributed as dist

    from rtvqa_tpu_torch.parallel import sharding
    from rtvqa_tpu_torch.parallel.sharding import (
        make_mesh,
        sharded_complexity_suite,
        sharded_quality_chunk_step,
        sharded_quality_step,
    )

    dev = launch.init_from_env("cpu")
    rank = dist.get_rank()
    out = {"meshes": {}, "complexity": {}}
    for name, (n_clip, n_frame, ranks) in {"2x2": (2, 2, None), "1x4": (1, 4, None),
                                            "bounded 1x2": (1, 2, 2)}.items():
        m = make_mesh(n_clip, n_frame, ranks=ranks, device=dev)
        rec = {"shape": m.shape, "member": m.member}
        if m.member:
            rec["coord"] = (m.rank("clip"), m.rank("frame"))
            rec["frame_group"] = dist.get_process_group_ranks(m.dim_group("frame"))
            rec["mesh_ranks"] = [int(g) for g in launch.all_gather(torch.tensor([rank]), m.group)]
        out["meshes"][name] = rec

    y, u, v, ts, n_valid = make_inputs()
    for shape in ((2, 2), (1, 4)):
        m = make_mesh(*shape, device=dev)
        c, f = m.rank("clip"), m.rank("frame")
        fn = sharded_complexity_suite(m, resize_h=24, resize_w=24, block=8, radius=4)
        args = [_local(a, c, f, shape) for a in (y, u, v, ts)]
        nv = torch.from_numpy(n_valid[c * (2 // shape[0]):(c + 1) * (2 // shape[0])])
        res = [fn(*args, nv) for _ in range(2)]
        out["complexity"][shape] = [{k: t.numpy() for k, t in r.items()} for r in res]

    m = make_mesh(1, STEP_RANKS, device=dev)
    f = m.rank("frame")
    q = QUALITY_SHAPES
    planes = quality_inputs(q["n"], q["h"], q["w"])
    step = sharded_quality_chunk_step(m)
    carry, chunks = torch.zeros(q["h"], q["w"]), []
    for ci, args in enumerate(padded_chunks(planes, q["chunk"])):
        local = [_local(a, 0, f, (1, STEP_RANKS), c_axis=False) for a in args]
        packed, carry = step(*local, carry, ci > 0)
        chunks.append((packed.numpy(), carry.numpy()))
    out["chunks"] = chunks
    whole = quality_inputs(16, 32, 48, chroma_dis=False)
    out["whole"] = sharded_quality_step(m)(
        *(_local(a, 0, f, (1, STEP_RANKS), c_axis=False) for a in whole)).numpy()

    # A body that fails on rank 1 only: every rank raises, and the group
    # still works afterwards (no rank was left inside a collective).
    real = sharding.chunk_plain
    if rank == 1:
        def boom(*a, **k):
            raise RuntimeError("boom on rank 1")

        sharding.chunk_plain = boom
    try:
        local = [_local(a, 0, f, (1, STEP_RANKS), c_axis=False) for a in next(padded_chunks(planes, 8))]
        step(*local, torch.zeros(q["h"], q["w"]), False)
        out["failure"] = None
    except launch.ShardFailure as e:
        out["failure"] = str(e)
    finally:
        sharding.chunk_plain = real
    out["after_failure"] = [int(g) for g in launch.all_gather(torch.tensor([rank]), dist.group.WORLD)]
    return out


def _w_raise(rank_that_fails):
    import torch.distributed as dist

    if dist.get_rank() == rank_that_fails:
        raise ValueError(f"worker failure on rank {rank_that_fails}")
    return dist.get_rank()


def _w_full_reference(ref, dis, chunk, n_devices):
    from rtvqa_tpu_torch.pipeline.quality_sharded import analyze_full_reference_sharded

    return analyze_full_reference_sharded(ref, dis, chunk=chunk, n_devices=n_devices, device="cpu")


def _w_clips(corpus, odd):
    from rtvqa_tpu_torch.pipeline.batch_analyzer import analyze_clips_sharded

    res = analyze_clips_sharded(corpus, resize_width=32, resize_height=32, frame_interval=2, device="cpu")
    try:
        analyze_clips_sharded(corpus + [odd], 32, 32, 2, device="cpu")
        mixed = None
    except Exception as e:
        mixed = (type(e).__name__, str(e))
    return [dataclasses.asdict(r) for r in res], mixed


def _w_sweeps(clips, d):
    """World 2: every sharded sweep the sweep tests read, in one world."""
    from rtvqa_tpu_torch.config import Config
    from rtvqa_tpu_torch.parallel import sharding
    from rtvqa_tpu_torch.pipeline.sweep import run_sweep_sharded

    def cfg(name, **kw):
        return Config.from_dict({**SWEEP_CONFIG, "csv_file": os.path.join(d, f"{name}.csv"), **kw})

    def run(name, videos, ladder, config=None, manifest=None):
        return run_sweep_sharded(videos, config or cfg(name), crf_ladder=ladder,
                                 manifest_path=os.path.join(d, f"{manifest or name}.jsonl"), device="cpu")

    out = {"rows": run("sharded", clips, [30, 40])}
    out["resume"] = [run("resume", clips[:1], [35]), run("resume", clips[:1], [35]),
                     run("resume", [clips[1], os.path.join(d, "nope.mp4")], [35])]
    corrupt = os.path.join(d, "corrupt.mp4")
    out["corrupt"] = run("corrupt", [corrupt, clips[0]], [35])
    sizes, real = [], sharding.make_mesh

    def spy(*a, **k):
        m = real(*a, **k)
        sizes.append((m.shape, m.member))
        return m

    sharding.make_mesh = spy
    try:
        out["bounded"] = run("dpd", clips[:1], [35], cfg("dpd", data_parallel_devices=1))
    finally:
        sharding.make_mesh = real
    out["sizes"] = sizes
    out["fallback"] = [run("fallback", clips[:1], [35]),
                       run("fallback2", clips[:1], [35], cfg("fallback2", allow_builtin_vmaf=True))]
    return out


# --- the process-group rules (in the test process) --------------------------


def test_world_of_one_and_no_fallback(monkeypatch):
    """Outside torchrun a world of one on the CPU (gloo), destroyed on exit;
    NCCL on the CPU and a card that is missing raise (no fallback)."""
    import torch.distributed as dist

    with launch.world("cpu") as dev:
        assert dev == torch.device("cpu")
        assert dist.get_world_size() == 1 and dist.get_rank() == 0
        assert dist.get_backend() == "gloo"
        assert launch.broadcast_object({"a": 1}) == {"a": 1}
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="NCCL needs CUDA"):
        launch.init_from_env("cpu", backend="nccl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        launch.init_from_env(None)
    assert not dist.is_initialized()


def test_spawn_raises_a_rank_failure():
    """A child that raises fails ``spawn`` with its error; no result is made up."""
    with pytest.raises(Exception, match="worker failure on rank 1"):
        launch.spawn(_w_raise, 2, "gloo", "cpu", 1, timeout=SPAWN_TIMEOUT)


# --- meshes, the complexity suite and the quality step (world 4) ---------------


@pytest.fixture(scope="module")
def world4():
    return launch.spawn(_w_tensor_paths, 4, "gloo", "cpu", timeout=SPAWN_TIMEOUT)


@pytest.mark.parametrize("name", ["2x2", "1x4", "bounded 1x2"])
def test_make_mesh(world4, name):
    """Full meshes cover every rank in row-major order; a mesh bounded to
    the first 2 ranks leaves ranks 2 and 3 outside (``member`` False)."""
    recs = [r["meshes"][name] for r in world4]
    shape = {"2x2": (2, 2), "1x4": (1, 4), "bounded 1x2": (1, 2)}[name]
    n_frame = shape[1]
    for rank, rec in enumerate(recs):
        assert rec["shape"] == shape
        assert rec["member"] == (rank < shape[0] * n_frame)
        if rec["member"]:
            assert rec["coord"] == divmod(rank, n_frame)
            row = rank // n_frame
            assert rec["frame_group"] == list(range(row * n_frame, (row + 1) * n_frame))
            assert rec["mesh_ranks"] == list(range(shape[0] * n_frame))


@pytest.fixture(scope="module")
def suite_refs():
    """Per clip of ``make_inputs``: JAX's single-device suite, JAX's sharded
    suite on a 2x4 mesh, and the port's single-device suite."""
    from rtvqa_tpu.metrics.complexity import complexity_suite as jax_suite
    from rtvqa_tpu.parallel.sharding import make_mesh as jax_mesh
    from rtvqa_tpu.parallel.sharding import sharded_complexity_suite as jax_sharded
    from rtvqa_tpu_torch.metrics.complexity import complexity_suite

    y, u, v, ts, n_valid = make_inputs()
    jsh = jax_sharded(jax_mesh(n_clip=2, n_frame=4), resize_h=24, resize_w=24, block=8, radius=4)
    jsh = {k: np.asarray(val) for k, val in jsh(y, u, v, ts, n_valid).items()}
    refs = []
    for clip in range(2):
        jref = jax_suite(y[clip], u[clip], v[clip], ts[clip], n_valid[clip],
                         resize_h=24, resize_w=24, block=8, radius=4)
        tref = complexity_suite(*(torch.from_numpy(a[clip]) for a in (y, u, v, ts)),
                                int(n_valid[clip]), resize_h=24, resize_w=24, block=8, radius=4)
        refs.append({k: (float(np.asarray(jref[k])), float(jsh[k][clip]), float(tref[k])) for k in tref})
    return refs


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_sharded_complexity_matches_jax(world4, suite_refs, shape):
    """The port's suite on a 2x2 and a 1x4 mesh against JAX's sharded suite
    (2x4 mesh) and single-device suite, and the port's own single-device
    suite; every rank holds every clip's result."""
    got = world4[0]["complexity"][shape][0]
    for r in world4[1:]:
        assert all(np.array_equal(r["complexity"][shape][0][k], got[k]) for k in got)
    for clip, refs in enumerate(suite_refs):
        for key, val in got.items():
            g = float(val[clip])
            jax_single, jax_sharded, port_single = refs[key]
            assert g == pytest.approx(jax_single, rel=2e-4, abs=2e-4), (key, clip)
            assert g == pytest.approx(jax_sharded, rel=2e-4, abs=2e-4), (key, clip)
            assert g == pytest.approx(port_single, rel=1e-6), (key, clip)


def test_sharded_complexity_deterministic(world4):
    """The same shard twice gives the same bytes on every rank."""
    for r in world4:
        for runs in r["complexity"].values():
            a, b = runs
            assert all(a[k].tobytes() == b[k].tobytes() for k in a)


def test_quality_chunk_step_bit_equal_to_chunk_plain(world4):
    """13 frames over 4 ranks in chunks of 8 at 34x52 (the ragged second
    chunk repeat-padded; odd VIF/ADM decimation chains), has_prev False
    then True with the carry: bit-equal to ``chunk_plain`` on each whole
    chunk, except vif_scale3 and adm2 within the JAX test's rtol 2e-4 /
    atol 1e-6; the carry bit-equal on every rank."""
    from rtvqa_tpu_torch.metrics.full_reference import CHUNK_KEYS, chunk_plain

    q = QUALITY_SHAPES
    carry = torch.zeros(q["h"], q["w"])
    for ci, args in enumerate(padded_chunks(quality_inputs(q["n"], q["h"], q["w"]), q["chunk"])):
        exp, carry = chunk_plain(*(torch.from_numpy(a) for a in args), carry, ci > 0)
        for r in world4:
            got, got_carry = r["chunks"][ci]
            for row, key in enumerate(CHUNK_KEYS):
                if key in ("vif_scale3", "adm2"):
                    np.testing.assert_allclose(got[row], exp[row].numpy(), rtol=2e-4, atol=1e-6,
                                               err_msg=f"chunk {ci}: {key}")
                else:
                    np.testing.assert_array_equal(got[row], exp[row].numpy(), err_msg=f"chunk {ci}: {key}")
            np.testing.assert_array_equal(got_carry, carry.numpy())


def test_quality_steps_match_jax(world4):
    """The chunk step against JAX's sharded chunk step (impl "xla", 8
    shards) on the awkward case, rtol = atol = 2e-4. The whole-clip step
    (16 x 32x48, zero carry, slot-0 SAD raw) against the port's
    ``chunk_plain`` on the whole clip (bit-equal but vif_scale3 and adm2, as
    above) and against JAX's whole-clip step and its single-device programs
    A and B, rtol = atol = 2e-4 except vif_scale3 at rtol 1e-3: there the
    port's single-device body itself differs from JAX's by 4.5e-4 on these
    i.i.d. noise frames (scale 3 of a 32x48 frame is 4x6, whose sums cancel
    FMA ULPs up; tests/test_torch_quality.py)."""
    from rtvqa_tpu.metrics.full_reference import _program_a, _program_b
    from rtvqa_tpu.parallel.sharding import make_mesh as jax_mesh
    from rtvqa_tpu.parallel.sharding import sharded_quality_chunk_step as jax_chunk_step
    from rtvqa_tpu.parallel.sharding import sharded_quality_step as jax_step
    from rtvqa_tpu_torch.metrics.full_reference import CHUNK_KEYS, chunk_plain

    q = QUALITY_SHAPES
    mesh = jax_mesh(n_clip=1, n_frame=8)
    step = jax_chunk_step(mesh, impl="xla")
    blur = np.zeros((q["h"], q["w"]), np.float32)
    for ci, args in enumerate(padded_chunks(quality_inputs(q["n"], q["h"], q["w"]), q["chunk"])):
        exp, lasts = step(*args, blur, np.bool_(ci > 0))
        blur = np.asarray(lasts)[-1]
        np.testing.assert_allclose(world4[0]["chunks"][ci][0], np.asarray(exp), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(world4[0]["chunks"][ci][1], blur, rtol=2e-4, atol=2e-4)
    whole = quality_inputs(16, 32, 48, chroma_dis=False)
    ry, ru, rv, dy, du, dv = whole
    pa, _ = _program_a(ry, ru, rv, dy, du, dv, np.zeros((32, 48), np.float32), True)
    jax_single = np.concatenate([np.asarray(pa), np.asarray(_program_b(ry, dy))])
    jax_sharded = np.asarray(jax_step(mesh)(*whole))
    port, _ = chunk_plain(*(torch.from_numpy(a) for a in whole), torch.zeros(32, 48), True)
    for r in world4:
        for row, key in enumerate(CHUNK_KEYS):
            got = r["whole"][row]
            if key in ("vif_scale3", "adm2"):
                np.testing.assert_allclose(got, port[row].numpy(), rtol=2e-4, atol=1e-6, err_msg=key)
            else:
                np.testing.assert_array_equal(got, port[row].numpy(), err_msg=key)
            rtol = 1e-3 if key == "vif_scale3" else 2e-4
            for want in (jax_single[row], jax_sharded[row]):
                np.testing.assert_allclose(got, want, rtol=rtol, atol=2e-4, err_msg=key)


def test_step_failure_on_one_rank_raises_on_every_rank(world4):
    """A chunk body that raises on rank 1 only ends the step with
    ``ShardFailure`` on all four ranks (rank 1's chained to its error), and
    the group's next collective still runs on all of them."""
    assert "boom on rank 1" in world4[1]["failure"]
    for r in world4:
        assert r["failure"] is not None
        assert r["after_failure"] == [0, 1, 2, 3]


# --- the sharded engine over an encoded clip pair (worlds 2 and 3) ------------


def make_clip_pair(d, n=21, h=48, w=64, seed=31):
    """tests/test_sharded_quality.py::_make_clip_pair, with the port's encoder."""
    from rtvqa_tpu_torch.io import video as vio

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for i in range(n):
        base = np.clip(
            100 + 50 * np.sin(2 * np.pi * (xx + 3 * i) / 29.0)
            + 30 * np.cos(2 * np.pi * (yy + i) / 13.0)
            + rng.normal(0, 5, (h, w)),
            0, 255,
        ).astype(np.uint8)
        frames.append(np.stack([base, base, base], -1))
    ref, dis = os.path.join(d, "ref.mp4"), os.path.join(d, "dis.mp4")
    vio.encode_raw_rgb(ref, np.stack(frames), fps=Fraction(30, 1), crf=14)
    vio.transcode(ref, dis, crf=34, preset="veryfast")
    return ref, dis


@pytest.fixture(scope="module")
def clip_pair(tmp_path_factory):
    """The pair, the port's streaming engine on it (chunk 4) and JAX's
    sharded engine (8 shards, chunk 8)."""
    from rtvqa_tpu.pipeline.quality_sharded import analyze_full_reference_sharded as jax_sharded
    from rtvqa_tpu_torch.metrics.full_reference import analyze_full_reference

    ref, dis = make_clip_pair(str(tmp_path_factory.mktemp("sharded_pair")))
    return ref, dis, [analyze_full_reference(ref, dis, chunk=4, device="cpu"),
                      jax_sharded(ref, dis, chunk=8)]


def _assert_engines_close(got, want):
    assert got["n_frames"] == want["n_frames"] == 21
    assert got["psnr"] == pytest.approx(want["psnr"], abs=1e-4)
    assert got["ssim"] == pytest.approx(want["ssim"], abs=1e-6)
    np.testing.assert_allclose(got["per_frame"]["motion2"], want["per_frame"]["motion2"],
                               rtol=1e-4, atol=1e-5)
    for k in ("vif_scale0", "vif_scale3", "adm2"):
        np.testing.assert_allclose(got["per_frame"][k], want["per_frame"][k], rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("world_size,chunk,n_devices", [(2, 8, None), (3, 8, None), (4, 6, 3)])
def test_analyze_full_reference_sharded(clip_pair, world_size, chunk, n_devices):
    """21 frames in chunks of 8 over 2 ranks, of 9 (8 rounded up) over 3,
    and of 6 over a mesh bounded to 3 of 4 ranks (rank 3 outside it): three
    or four chunks, a ragged tail, the carry crossing chunk and shard
    boundaries. Every rank gets the same dict, which matches the port's
    streaming engine (chunk 4) and JAX's sharded engine (8 shards, chunk 8)."""
    ref, dis, wants = clip_pair
    res = launch.spawn(_w_full_reference, world_size, "gloo", "cpu", ref, dis, chunk, n_devices,
                       timeout=SPAWN_TIMEOUT)
    for r in res[1:]:
        assert r["psnr"] == res[0]["psnr"] and r["vmaf"] == res[0]["vmaf"]
        assert all(np.array_equal(r["per_frame"][k], res[0]["per_frame"][k]) for k in r["per_frame"])
    for want in wants:
        _assert_engines_close(res[0], want)


# --- the batched corpus analyzer (world 4) ------------------------------------


def write_clip(path, n, seed, h=48, w=64):
    """tests/test_batch_analyzer.py::write_clip, with the port's encoder."""
    from rtvqa_tpu_torch.io import video as vio

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = np.stack([
        np.clip(((xx * 2 + yy + 4 * i) % 256) + rng.integers(0, 10, (h, w)), 0, 255).astype(np.uint8)
        for i in range(n)
    ])
    vio.encode_raw_rgb(path, np.stack([frames, 255 - frames, frames // 2], -1), fps=Fraction(24, 1), crf=18)


@pytest.fixture(scope="module")
def corpus_run(tmp_path_factory):
    from rtvqa_tpu_torch.io import video as vio

    d = tmp_path_factory.mktemp("corpus")
    paths = []
    for i, n in enumerate([20, 14, 26]):
        paths.append(str(d / f"clip{i}.mp4"))
        write_clip(paths[-1], n, seed=i)
    odd = str(d / "odd.mp4")
    vio.encode_raw_rgb(odd, np.random.default_rng(9).integers(0, 256, (6, 32, 32, 3), dtype=np.uint8),
                       fps=Fraction(24, 1))
    return paths, launch.spawn(_w_clips, 4, "gloo", "cpu", paths, odd, timeout=SPAWN_TIMEOUT)


def test_analyze_clips_sharded_matches_per_clip(corpus_run):
    """Three clips of 20, 14 and 26 sampled-at-2 frames on the default 2x2
    mesh (a padded fourth clip, frames padded to 16): every rank holds the
    per-clip results of ``calculate_average_scene_complexity``."""
    from rtvqa_tpu_torch.io import video as vio
    from rtvqa_tpu_torch.metrics.complexity import calculate_average_scene_complexity

    paths, res = corpus_run
    batch = res[0][0]
    assert len(batch) == 3 and all(r[0] == batch for r in res)
    for path, got in zip(paths, batch):
        solo = calculate_average_scene_complexity(vio.decode_sampled(path, 2), 32, 32, device="cpu")
        for key, val in dataclasses.asdict(solo).items():
            assert got[key] == pytest.approx(val, rel=1e-6, abs=1e-9), (path, key)


def test_analyze_clips_sharded_rejects_mixed_resolutions(corpus_run):
    _, res = corpus_run
    assert res[0][1][0] == "ValueError" and "one resolution" in res[0][1][1]
    for r in res[1:]:
        assert r[1][0] == "ShardFailure" and "one resolution" in r[1][1]


# --- the sharded sweep (world 2) ----------------------------------------------

SWEEP_CONFIG = {"crf": 28, "resize_width": 64, "resize_height": 64, "frame_interval": 3}


def make_sweep_clip(path, n=24, h=64, w=64, seed=5):
    """tests/test_sweep_sharded.py::make_clip, with the port's encoder."""
    from rtvqa_tpu_torch.io import video as vio

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for i in range(n):
        base = ((xx * 3 + yy * 2 + i * 7) % 256).astype(np.uint8)
        f = np.stack([base, np.roll(base, i % 5, 1), 255 - base], -1)
        frames.append(np.clip(f.astype(np.int16) + rng.integers(0, 10, f.shape), 0, 255).astype(np.uint8))
    vio.encode_raw_rgb(path, np.stack(frames), fps=Fraction(30, 1), crf=20)


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    d = tmp_path_factory.mktemp("sweep_sharded")
    clips = [str(d / f"clip{i}.mp4") for i in range(2)]
    for i, p in enumerate(clips):
        make_sweep_clip(p, seed=5 + i)
    with open(d / "corrupt.mp4", "wb") as f:
        f.write(np.random.default_rng(0).integers(0, 256, 4096, dtype=np.uint8).tobytes())
    res = launch.spawn(_w_sweeps, 2, "gloo", "cpu", clips, str(d), timeout=SPAWN_TIMEOUT)
    return {"dir": d, "clips": clips, "ranks": res}


def _manifest(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_sharded_sweep_matches_sequential(sweeps):
    """Two clips x CRFs 30, 40 at world size 2: the counts, the rows and the
    manifest of the port's ``run_sweep`` (in the test process)."""
    from rtvqa_tpu_torch.pipeline.csv_sink import CSV_COLUMNS, read_rows
    from rtvqa_tpu_torch.config import Config
    from rtvqa_tpu_torch.pipeline.sweep import run_sweep

    d = sweeps["dir"]
    cfg = Config.from_dict({**SWEEP_CONFIG, "csv_file": str(d / "seq.csv")})
    stats = run_sweep(sweeps["clips"], cfg, crf_ladder=[30, 40], manifest_path=str(d / "seq.jsonl"),
                      device="cpu")
    assert stats == {"done": 4, "failed": 0, "skipped": 0}
    assert [r["rows"] for r in sweeps["ranks"]] == [stats, stats]
    assert _manifest(str(d / "sharded.jsonl")) == _manifest(str(d / "seq.jsonl"))
    rows_seq, rows_sh = read_rows(cfg.csv_file), read_rows(str(d / "sharded.csv"))
    assert len(rows_seq) == len(rows_sh) == 4
    for rs, rh in zip(rows_seq, rows_sh):
        for col in CSV_COLUMNS:
            a, b = rs[col], rh[col]
            if col in ("Resolution (px)", "CRF") or a == "" or b == "":
                assert a == b, col
            else:
                np.testing.assert_allclose(float(a), float(b), rtol=2e-3, atol=1e-5, err_msg=col)


def test_sharded_sweep_resume_and_isolation(sweeps):
    """A rerun skips the done item and leaves the CSV as it was; a missing
    clip fails alone and the good one still lands."""
    from rtvqa_tpu_torch.pipeline.csv_sink import read_rows

    first, again, mixed = sweeps["ranks"][0]["resume"]
    assert first == {"done": 1, "failed": 0, "skipped": 0}
    assert again == {"done": 0, "failed": 0, "skipped": 1}
    assert mixed == {"done": 1, "failed": 1, "skipped": 0}
    assert sweeps["ranks"][1]["resume"] == [first, again, mixed]
    assert len(read_rows(str(sweeps["dir"] / "resume.csv"))) == 2


def test_sharded_sweep_corrupt_input_fails_alone(sweeps):
    """A file that is no video ends as a ``failed`` manifest line on world 2
    (no hang); the clip beside it is done."""
    d = sweeps["dir"]
    assert [r["corrupt"] for r in sweeps["ranks"]] == [{"done": 1, "failed": 1, "skipped": 0}] * 2
    lines = _manifest(str(d / "corrupt.jsonl"))
    bad = [rec for rec in lines if rec["video"].endswith("corrupt.mp4")]
    assert len(bad) == 1 and bad[0]["status"] == "failed" and bad[0]["error"]
    assert [rec["status"] for rec in lines if rec["video"] == sweeps["clips"][0]] == ["done"]


def test_data_parallel_devices_bounds_mesh(sweeps):
    """``data_parallel_devices: 1`` makes both meshes 1x1 on world 2: rank 0
    is in them, rank 1 outside, and the item is done."""
    r0, r1 = sweeps["ranks"]
    assert r0["bounded"] == r1["bounded"] == {"done": 1, "failed": 0, "skipped": 0}
    assert r0["sizes"] == [((1, 1), True)] * 2 and r1["sizes"] == [((1, 1), False)] * 2


def test_builtin_vmaf_fallback_not_in_csv_by_default(sweeps):
    """No model file: the VMAF cell stays empty unless allow_builtin_vmaf."""
    from rtvqa_tpu_torch.pipeline.csv_sink import read_rows

    d = sweeps["dir"]
    row = read_rows(str(d / "fallback.csv"))[0]
    assert row["VMAF"] == "" and row["PSNR"] != ""
    row2 = read_rows(str(d / "fallback2.csv"))[0]
    assert 0.0 <= float(row2["VMAF"]) <= 100.0


# --- the CLI under torchrun's environment, and the corpus example -------------


def test_cli_sweep_under_torchrun_env(sweeps, tmp_path):
    """Two CLI processes with torchrun's variables (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) and no ``--sharded``:
    the sweep shards over both (gloo, ``--device cpu``), rank 0 writes the
    one row and prints the stats, and the row equals the world-2 sweep's."""
    import socket
    import subprocess
    import sys

    from rtvqa_tpu_torch.pipeline.csv_sink import read_rows

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    csv = str(tmp_path / "cli.csv")
    with open(tmp_path / "cli.json", "w") as f:
        json.dump({**SWEEP_CONFIG, "csv_file": csv}, f)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for rank in range(2):
        env = {**os.environ, "PYTHONPATH": repo, "RANK": str(rank), "LOCAL_RANK": str(rank),
               "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "rtvqa_tpu_torch.cli", str(tmp_path / "cli.json"), sweeps["clips"][0],
             "--sweep", "35", "--device", "cpu", "--json"],
            cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=SPAWN_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:] for o in outs]
    assert json.loads(outs[0][0].strip().splitlines()[-1])["metrics"] == {"done": 1, "failed": 0, "skipped": 0}
    assert outs[1][0].strip() == ""
    (row,) = read_rows(csv)
    (want,) = read_rows(str(sweeps["dir"] / "dpd.csv"))   # the same clip at CRF 35 on world 2
    assert row == want


def test_corpus_example_runs(tmp_path, capsys, monkeypatch):
    """``python -m rtvqa_tpu_torch.examples.analyze_corpus DIR --device cpu``
    at a small size (quality chunks of 8 frames, not 128 mostly padded
    ones): the sweep's counts, one JSON line per clip, and a rerun that
    skips every item."""
    from rtvqa_tpu_torch.examples.analyze_corpus import main
    from rtvqa_tpu_torch.pipeline import quality_sharded

    monkeypatch.setattr(quality_sharded, "auto_chunk", lambda w, h: 8)

    argv = [str(tmp_path), "--device", "cpu", "--clips", "2", "--frames", "8"]
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "sweep: {'done': 4, 'failed': 0, 'skipped': 0}" in out
    clips = [json.loads(line) for line in out.splitlines() if line.startswith('{"clip"')]
    assert len(clips) == 2 and all(np.isfinite(c["dct"]) for c in clips)
    assert main(argv) == 0
    assert "sweep: {'done': 0, 'failed': 0, 'skipped': 4}" in capsys.readouterr().out
