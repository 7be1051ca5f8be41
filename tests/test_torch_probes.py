"""The measurement path's kernels (6a, 8, 9) on the CPU against the JAX
package and the probe scripts, and the probe entry points at small shapes.

* 6a: ``adm_input_plain`` and ``adm_input_cuda`` (its plain version on CPU
  tensors) equal ``adm_scale_pallas(..., 0, stages=0)`` in interpret mode
  exactly: the checksum sums u8 values (or eighth-integer f32 values), so
  every order gives the same bits.
* 8: ``strip_sum_plain`` against ``scripts/probe_int8_dma.py``'s own
  reference, ``jnp.sum(x.astype(f32), axis=(1, 2))``, at rel 1e-6 (the
  script's threshold); the script itself runs in interpret mode at a small
  shape and passes its check.
* 9: ``strip_floor_plain`` against the NumPy statement of
  ``scripts/probe_dma_floor.py:112,131`` (the sum over frames and windows
  of ``x[i, 48 s, 0]``), exactly.
"""

import contextlib
import importlib.util
import io
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvqa_tpu.kernels.adm_pallas import adm_scale_pallas
from rtvqa_tpu_torch.kernels.adm import adm_input_cuda, adm_input_plain
from rtvqa_tpu_torch.kernels.probes import (
    strip_floor_cuda,
    strip_floor_plain,
    strip_sum_cuda,
    strip_sum_plain,
)

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _pair(shape, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "u8":
        return rng.integers(0, 256, shape, np.uint8), rng.integers(0, 256, shape, np.uint8)
    return tuple((rng.integers(0, 2040, shape) / 8).astype(np.float32) for _ in range(2))


@pytest.mark.parametrize("shape,kind", [((2, 72, 160), "u8"), ((1, 100, 130), "u8"),
                                        ((2, 64, 200), "f32")])
@pytest.mark.parametrize("fn", [adm_input_plain, adm_input_cuda])
def test_adm_input_matches_jax_stage0(shape, kind, fn):
    """(1, 100, 130): odd width, and H is edge-padded to the TPU's 8-row
    multiple, which the strip plan's row cap follows."""
    ref, dis = _pair(shape, kind, 1)
    want = adm_scale_pallas(jnp.asarray(ref), jnp.asarray(dis), 0, stages=0, interpret=True)
    got = fn(torch.from_numpy(ref), torch.from_numpy(dis))
    assert float(got[0].sum()) > 0
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("shape", [(2, 72, 256), (3, 104, 130), (1, 48, 7)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_strip_sum_plain_matches_script_reference(shape, dtype):
    x = np.random.default_rng(2).integers(0, 256, shape).astype(dtype)
    want = np.asarray(jnp.sum(jnp.asarray(x).astype(jnp.float32), axis=(1, 2)))
    for fn in (strip_sum_plain, strip_sum_cuda):
        got = fn(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("h", [40, 101])
def test_strip_sum_rejects_rows_its_windows_miss(h):
    """Below 48 rows no window fits; at H = 101 the last window ends at row
    96, so the script's kernel would drop rows 96-100."""
    for fn in (strip_sum_plain, strip_sum_cuda):
        with pytest.raises(ValueError, match="window"):
            fn(torch.zeros((1, h, 64), dtype=torch.uint8))


def _load_script(name):
    spec = importlib.util.spec_from_file_location(f"rtvqa_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_int8_dma_script_passes_in_interpret_mode(monkeypatch):
    """The JAX kernel of probe 8 gives the value ``strip_sum_plain`` is held
    to: the script's own check passes at (1, 72, 256) (N > 1 revisits its
    output block out of order, which the interpreter refuses)."""
    from jax.experimental.pallas import tpu as pltpu

    import rtvqa_tpu.obs.jaxcache as jaxcache

    monkeypatch.setattr(jaxcache, "enable_persistent_cache", lambda *a, **k: None)
    script = _load_script("probe_int8_dma")
    monkeypatch.setattr(script, "N", 1)
    monkeypatch.setattr(script, "H", 72)
    monkeypatch.setattr(script, "W", 256)
    out = io.StringIO()
    with pltpu.force_tpu_interpret_mode(), contextlib.redirect_stdout(out):
        script.main()
    assert "max_rel_err=0 PASS" in out.getvalue(), out.getvalue()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8])
def test_strip_floor_plain_matches_script_statement(dtype):
    x = (torch.from_numpy(np.random.default_rng(3).random((2, 104, 256), np.float32)) * 255).to(dtype)
    xn = x.float().numpy()
    n_s = xn.shape[1] // 48
    # probe_dma_floor.py:112 keeps row 0 of each window (first 128 lanes),
    # :131 takes lane 0 and sums over frames and windows.
    per_window = np.stack([xn[:, 48 * s, :128] for s in range(n_s)], axis=1)
    want = np.float32(per_window[:, :, 0].astype(np.float64).sum())
    for fn in (strip_floor_plain, strip_floor_cuda):
        got = fn(x)
        assert got.shape == () and got.dtype == torch.float32
        assert float(got) == float(want)


def test_strip_floor_raises_where_the_last_window_passes_h():
    x = torch.zeros((2, 96, 256), dtype=torch.float32)
    for fn in (strip_floor_plain, strip_floor_cuda):
        with pytest.raises(ValueError, match="window"):
            fn(x)


@pytest.mark.parametrize("name,expect", [("adm_stages", "equal to the plain version: True"),
                                         ("int8_dma", "max_rel_err=0 PASS"),
                                         ("dma_floor", "equal to plain: True")])
def test_probe_entry_point_runs_on_cpu(name, expect):
    proc = subprocess.run(
        [sys.executable, "-m", f"rtvqa_tpu_torch.probes.{name}", "--device", "cpu", "--n", "2",
         "--height", "104", "--width", "256", "--reps", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert expect in proc.stdout
    assert "cpu, host clock" in proc.stdout


def test_gray_shapes_probe_runs_on_cpu():
    """Kernel 1's probe at small shapes, one per path of the kernel: the
    wrapper on CPU tensors is its plain version, so every shape is equal."""
    proc = subprocess.run(
        [sys.executable, "-m", "rtvqa_tpu_torch.probes.gray_shapes", "--device", "cpu",
         "--shapes", "2x33x64", "2x35x854", "--reps", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("equal to plain: True") == 2, proc.stdout
    assert "on 2x33x64: y.to(torch.float32)" in proc.stdout and "f32 fill_" in proc.stdout
    assert "cpu, host clock" in proc.stdout
