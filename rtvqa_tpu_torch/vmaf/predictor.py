"""VMAF end to end over decoded clips: VIF + ADM + motion features and the
model's per-frame prediction (counterpart of ``rtvqa_tpu/vmaf/predictor.py``).

The clip score is the mean of the per-frame scores, libvmaf's
``pooled_metrics.vmaf.mean``. Features are extracted ``chunk`` frames at a
time; motion carries the blurred last reference frame from chunk to chunk
(``vmaf/motion.py``), so no value depends on the chunk size.

Two routes compute the spatial features of a chunk (``impl``):

* "plain": ``vif_features`` + ``adm_features`` on plain PyTorch ops, as the
  JAX package computes them;
* "kernel": the kernels that compute them at any width from the u8 luma:
  VIF as four chained ``vif_scale_cuda`` calls (scales 0-3, kernel 4, the
  counterpart of the JAX package's ``vif_scale_pallas``; this API is the
  port's route to it) and ADM as ``adm_scale_cuda`` (scale 0) then
  ``adm_tail_cuda`` (scales 1-3).

``None`` takes "kernel" on the card and "plain" on the CPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from rtvqa_tpu_torch.device import get_device
from rtvqa_tpu_torch.kernels.vif import vif_features_cuda
from rtvqa_tpu_torch.metrics.full_reference import adm2_kernels
from rtvqa_tpu_torch.obs.logging import get_logger
from rtvqa_tpu_torch.vmaf.adm import adm_features
from rtvqa_tpu_torch.vmaf.model import builtin_model, load_model
from rtvqa_tpu_torch.vmaf.motion import motion_from_sads, motion_sads
from rtvqa_tpu_torch.vmaf.vif import vif_features

logger = get_logger("rtvqa_tpu_torch.vmaf")

FRAME_KEYS = ("vif_scale0", "vif_scale1", "vif_scale2", "vif_scale3", "adm2")
IMPLS = ("kernel", "plain")
# Peak device memory per luma pixel of a chunk, by route, rounded up: how
# far torch.cuda.max_memory_allocated rose above a chunk's u8 inputs, over
# its frames and pixels. chip_smoke.py (phase api) measured 24.1-24.2 B
# (kernel) and 63.2-63.4 B (plain) at 2 and 8 1080p frames on an H100.
PEAK_BYTES_PER_PIXEL = {"kernel": 25, "plain": 64}
# Share of the device's memory a chunk may take; on the CPU, a fixed budget.
MEMORY_SHARE = 4
CPU_BUDGET_BYTES = 4 << 30
MAX_CHUNK = 128


def _resolve_impl(impl: Optional[str], dev: torch.device) -> str:
    if impl is None:
        return "kernel" if dev.type == "cuda" else "plain"
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "kernel" and dev.type != "cuda":
        raise ValueError("impl='kernel' needs a CUDA device; use 'plain' on the CPU")
    return impl


def default_chunk(height: int, width: int, dev: torch.device, impl: str) -> int:
    """Frames per chunk: as many as keep the route's measured peak within a
    quarter of the card's memory (a fixed budget on the CPU), at most
    ``MAX_CHUNK``."""
    if dev.type == "cuda":
        budget = torch.cuda.get_device_properties(dev).total_memory // MEMORY_SHARE
    else:
        budget = CPU_BUDGET_BYTES
    per_frame = PEAK_BYTES_PER_PIXEL[impl] * max(height * width, 1)
    return max(1, min(MAX_CHUNK, budget // per_frame))


def _frame_features(ref_y: torch.Tensor, dis_y: torch.Tensor, impl: Optional[str] = None) -> dict:
    """Spatial per-frame features of a (B, H, W) luma pair: ``vif_scale0``
    .. ``vif_scale3`` and ``adm2``, each (B,)."""
    impl = _resolve_impl(impl, ref_y.device)
    if impl == "kernel":
        out = vif_features_cuda(ref_y, dis_y)
        out["adm2"] = adm2_kernels(ref_y, dis_y)
        return out
    ref, dis = ref_y.float(), dis_y.float()
    out = vif_features(ref, dis)
    out.update(adm_features(ref, dis))
    return out


def extract_features(
    ref_clip,
    dis_clip,
    chunk: Optional[int] = None,
    impl: Optional[str] = None,
    device: str | torch.device | None = None,
) -> dict[str, np.ndarray]:
    """Per-frame VMAF features of two decoded clips' luma: ``FRAME_KEYS``
    plus ``motion`` and ``motion2``, each (N,) f32 on the host. ``chunk``
    defaults to :func:`default_chunk`; ``device`` to the card."""
    dev = get_device(device)
    impl = _resolve_impl(impl, dev)
    n = min(ref_clip.y.shape[0], dis_clip.y.shape[0])
    if chunk is None:
        chunk = default_chunk(*ref_clip.y.shape[1:], dev, impl)
    if chunk < 1:
        raise ValueError(f"chunk must be at least 1, got {chunk}")
    feats: dict[str, list[np.ndarray]] = {k: [] for k in FRAME_KEYS}
    sads, carry = [], None
    for start in range(0, n, chunk):
        sl = slice(start, min(start + chunk, n))
        ry, dy = (torch.from_numpy(np.ascontiguousarray(c.y[sl])).to(dev) for c in (ref_clip, dis_clip))
        out = _frame_features(ry, dy, impl)
        for k in FRAME_KEYS:
            feats[k].append(out[k].float().cpu().numpy())
        sad, carry = motion_sads(ry, carry)
        sads.append(sad.cpu())
    result = {k: np.concatenate(v) if v else np.zeros(0, np.float32) for k, v in feats.items()}
    if n:
        result.update({k: v.numpy() for k, v in motion_from_sads(torch.cat(sads)).items()})
    else:
        result.update(motion=np.zeros(0, np.float32), motion2=np.zeros(0, np.float32))
    return result


def compute_vmaf(
    ref_clip,
    dis_clip,
    model_path: Optional[str] = None,
    return_details: bool = False,
    device: str | torch.device | None = None,
):
    """Clip-level VMAF (mean of the per-frame model predictions) on
    ``device`` (the card by default). Without ``model_path`` the builtin
    linear model scores (not libvmaf parity). The model's feature options
    (NEG gain limits) are not passed to the extractors, as in the JAX
    package's ``compute_vmaf``."""
    if model_path:
        model = load_model(model_path)
    else:
        model = builtin_model()
        logger.warning(
            "No VMAF model file given; using %s — scores are qualitative, "
            "not libvmaf-parity. Provide vmaf_v0.6.1.json via vmaf_model_path.",
            model.name,
        )
    feats = extract_features(ref_clip, dis_clip, device=device)
    per_frame = model.predict(feats).numpy()
    score = float(per_frame.mean()) if per_frame.size else 0.0
    if return_details:
        return score, {"per_frame": per_frame, "features": feats, "model": model.name}
    return score
