"""Streaming full-reference engine: PSNR + SSIM + VMAF features in one pass
(counterpart of ``rtvqa_tpu/metrics/full_reference.py``).

Both videos stream through the native decoder in lockstep chunks of
``auto_chunk`` frames (a background thread decodes and uploads the next
chunk while the device computes). Per chunk one body computes every
per-frame series of ``CHUNK_KEYS``:

* ``chunk_plain`` — plain PyTorch ops: ``program_a`` (PSNR/SSIM with
  ``metrics.quality``, the FILTER_5 motion SADs) and ``program_b`` (VIF
  scales 0-3 and ADM with ``vmaf``); the counterpart of the JAX package's
  ``_program_a`` + ``_program_b``;
* ``chunk_kernels`` — the CUDA kernels; the counterpart of
  ``_chunk_fused_tpu``: the fused quality kernel, the VIF tail and ADM
  (``kernels.quality``, ``kernels.vif``, ``kernels.adm``), their plain
  versions on CPU tensors. The kernels tile the frame, so one body serves
  every width, DCI 4K's 4096 included.

A ragged last chunk is padded by repeating its last frame, on the device
(the prefetch threads stage it so, ``io/stream.py::stage_to_device``); the
blurred last ref frame carries across chunks, and frame 0's SAD is masked.
Per-frame series return to the host; pooling (mean MSE -> PSNR, mean SSIM,
the motion2 min rule, per-frame SVR -> mean VMAF) happens at the end.

``analyze_combined`` (the default config's route) runs the same loop and
taps every ``frame_interval``-th decoded frame of one stream into a
``complexity_streaming.ComplexityAccumulator``: quality and complexity from
one decode pass per stream. At ``frame_interval`` 1 on the card it runs the
merged step instead (``chunk_combined``, the counterpart of
``_program_chunk_combined``): the complexity values of every frame come
from the planes the quality chunk already staged, the tail frames stay on
the device, and one packed fetch per chunk feeds the accumulator.

Spans and counters (``obs/profiler.py``): ``clip`` around a clip's loop,
``quality`` around each chunk's launches, ``complexity`` around the merged
step's values, ``tap`` around the tap, ``padded_frames`` for the padding
rows every chunk computes, ``pad`` where the loop itself pads on the device
(the longer stream's last batch cut to the shorter's), ``fetch`` where the
host waits for a chunk's series, and ``pool``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from rtvqa_tpu_torch.device import get_device
from rtvqa_tpu_torch.io.stream import (  # noqa: F401 (upload: callers wrap it under this name)
    VideoStream,
    prefetch,
    repeat_last,
    stage_to_device,
    upload,
)
from rtvqa_tpu_torch.kernels.adm import adm_scale_cuda, adm_tail_cuda
from rtvqa_tpu_torch.kernels.quality import quality_fused_cuda
from rtvqa_tpu_torch.kernels.vif import vif_tail_cuda
from rtvqa_tpu_torch.metrics.complexity_streaming import ComplexityAccumulator, _chunk_values_body
from rtvqa_tpu_torch.metrics.quality import (
    pooled_psnr,
    psnr_frames,
    psnr_from_sse,
    ssim_all,
    ssim_frames,
)
from rtvqa_tpu_torch.obs.logging import get_logger
from rtvqa_tpu_torch.obs.profiler import clip, count, span
from rtvqa_tpu_torch.vmaf.adm import adm_features, adm_finalize
from rtvqa_tpu_torch.vmaf.model import builtin_model, load_model
from rtvqa_tpu_torch.vmaf.motion import motion_sads
from rtvqa_tpu_torch.vmaf.vif import vif_features

logger = get_logger("rtvqa_tpu_torch.full_reference")

A_KEYS = (
    "mse_y", "mse_u", "mse_v", "mse_avg", "psnr_y", "psnr_avg",
    "ssim_y", "ssim_u", "ssim_v", "ssim_all", "motion_sad",
)
B_KEYS = ("vif_scale0", "vif_scale1", "vif_scale2", "vif_scale3", "adm2")
CHUNK_KEYS = A_KEYS + B_KEYS
# Widest frame the JAX package's fused TPU kernel takes (its
# full_reference.py:165-174, a VMEM limit). The port has no width gate; the
# DCI-4K cell's test uses it to show that the cell lies past that gate.
FUSED_MAX_WIDTH = 3840


def resolve_precision(quality_precision: Optional[str]) -> None:
    """Check the config's ``quality_precision``: "auto" (or None) and
    "exact" run exact f32; "fast" (the JAX package's reduced-precision
    filter mode) is not ported."""
    if quality_precision in (None, "auto", "exact"):
        return None
    if quality_precision == "fast":
        raise NotImplementedError(
            "quality_precision 'fast' is not ported to rtvqa_tpu_torch: its "
            "reduced-precision filters were a TPU workaround (ROADMAP.md, 'Not ported (deliberate)')"
        )
    raise ValueError(
        f"quality_precision must be 'auto', 'exact' or 'fast', got {quality_precision!r}"
    )


def _mask_first(sad: torch.Tensor, has_prev: bool) -> torch.Tensor:
    if not has_prev:
        sad = sad.clone()
        sad[0] = 0.0
    return sad


def program_a(ry, ru, rv, dy, du, dv, prev_blur, has_prev: bool):
    """PSNR, SSIM and motion SADs of one chunk on plain ops (counterpart of
    ``_program_a``). Returns (packed (len(A_KEYS), N) f32, blur carry (H, W))."""
    out = {}
    out.update(psnr_frames(ry, ru, rv, dy, du, dv))
    out.update(ssim_frames(ry, ru, rv, dy, du, dv))
    sad, blur_last = motion_sads(ry, prev_blur)
    out["motion_sad"] = _mask_first(sad, has_prev)
    return torch.stack([out[k].float() for k in A_KEYS]), blur_last


def program_b(ry, dy, vif_egl=None, adm_egl=None):
    """VIF scales 0-3 and ADM2 of one chunk on plain ops (the CPU branch of
    ``_program_b``): packed (len(B_KEYS), N) f32."""
    ryf, dyf = ry.float(), dy.float()
    out = vif_features(ryf, dyf, enhn_gain_limit=vif_egl)
    out.update(adm_features(ryf, dyf, enhn_gain_limit=adm_egl))
    return torch.stack([out[k].float() for k in B_KEYS])


def chunk_plain(ry, ru, rv, dy, du, dv, prev_blur, has_prev: bool, vif_egl=None, adm_egl=None):
    """One lockstep chunk on plain ops. Returns (packed (len(CHUNK_KEYS), N)
    f32, blur carry (H, W))."""
    pa, blur = program_a(ry, ru, rv, dy, du, dv, prev_blur, has_prev)
    return torch.cat([pa, program_b(ry, dy, vif_egl, adm_egl)]), blur


def adm2_kernels(ry, dy, egl=None):
    """Per-frame adm2 of a (B, H, W) luma pair through kernel 6 (scale 0)
    and kernel 7 (scales 1-3)."""
    num, den, a_ref, a_dis = adm_scale_cuda(ry, dy, 0, egl=egl)
    tail = adm_tail_cuda(a_ref, a_dis, egl=egl)
    return adm_finalize(num + tail["num"], den + tail["den"], ry.shape)


def chunk_kernels(ry, ru, rv, dy, du, dv, prev_blur, has_prev: bool, vif_egl=None, adm_egl=None):
    """One lockstep chunk on the kernels (their plain versions for CPU
    tensors): kernel 3 (PSNR/SSIM sums, motion SAD, VIF scale 0, the
    scale-1 inputs), kernel 5 (VIF scales 1-3) and ADM kernels 6-7.
    Returns (packed (len(CHUNK_KEYS), N) f32, blur carry (H, W))."""
    h, w = ry.shape[-2:]
    fq = quality_fused_cuda(ry, ru, rv, dy, du, dv, prev_blur, egl=vif_egl)
    h2, w2 = ru.shape[-2:]
    n_y, n_c = h * w, h2 * w2
    out = psnr_from_sse(fq["sse_y"], fq["sse_u"], fq["sse_v"], n_y, n_c)
    out["ssim_y"] = fq["ssim_y_sum"] / ((h // 4 - 1) * (w // 4 - 1))
    out["ssim_u"] = fq["ssim_u_sum"] / ((h2 // 4 - 1) * (w2 // 4 - 1))
    out["ssim_v"] = fq["ssim_v_sum"] / ((h2 // 4 - 1) * (w2 // 4 - 1))
    out["ssim_all"] = ssim_all(out["ssim_y"], out["ssim_u"], out["ssim_v"], n_y, n_c)
    out["motion_sad"] = _mask_first(fq["sad_sum"] / n_y, has_prev)
    out["vif_scale0"] = fq["vif_scale0"]
    out.update(vif_tail_cuda(fq["dec_ref"], fq["dec_dis"], egl=vif_egl))
    out["adm2"] = adm2_kernels(ry, dy, adm_egl)
    return torch.stack([out[k].float() for k in CHUNK_KEYS]), fq["blur_carry"]


def chunk_combined(ry, ru, rv, dy, du, dv, prev_blur, has_prev: bool, tail_y, tail_u, tail_v,
                   vif_egl=None, adm_egl=None, *, suite, complexity_on: str = "dis",
                   impl: str = "kernel"):
    """One merged quality+complexity step (counterpart of
    ``_program_chunk_combined``): the quality chunk (``chunk_kernels``, or
    ``chunk_plain`` for ``impl`` "plain"), then the complexity values of
    every frame of the target stream's planes (``complexity_on``: "dis" or
    "ref") with the carried tail frames prepended, through ``suite`` (the
    accumulator's ``ComplexitySuite``). The tails of the first chunk are
    zeros, whose slot-0 values ``ComplexityAccumulator.finalize`` drops.
    Returns (packed (len(CHUNK_KEYS) + 7, N) f32, blur carry, and the
    target's last frame as the next tails), all on the planes' device."""
    body = chunk_kernels if impl == "kernel" else chunk_plain
    with span("quality"):
        packed_q, blur = body(ry, ru, rv, dy, du, dv, prev_blur, has_prev, vif_egl, adm_egl)
    cy, cu, cv = (dy, du, dv) if complexity_on == "dis" else (ry, ru, rv)
    with span("complexity"):
        packed_c = _chunk_values_body(suite, cy, cu, cv, tail_y, tail_u, tail_v)
    # Padded tails repeat the last valid frame, so [-1] is the last valid
    # one; the copies let the chunk's planes go.
    return torch.cat([packed_q, packed_c]), blur, cy[-1].clone(), cu[-1].clone(), cv[-1].clone()


def auto_chunk(width: int, height: int, requested: Optional[int] = None) -> int:
    """Frames per chunk, scaled to resolution: 64 at 1080p, at most 128,
    even, at least 2."""
    budget = max(2, int(64 * (1080 * 1920) / max(width * height, 1)))
    budget = min(budget, 128)
    chunk = min(requested or budget, budget)
    return max(2, (chunk // 2) * 2)


def _device_planes(sb, n: int) -> tuple:
    """The (y, u, v) device planes of one stream's ``StagedFrameBatch``
    whose first ``n`` frames the chunk computes, the rows past them
    repeating frame ``n - 1``. Staged planes pass as they are, unless the
    batch holds more than ``n`` frames (the other stream ended first): then
    they are padded again from row ``n - 1``, in place on the card (a CPU
    plane may share the caller's host array, so it is copied first)."""
    if sb.host.y.shape[0] == n:
        return sb.y, sb.u, sb.v
    with span("pad"):
        return tuple(repeat_last(p if p.is_cuda else p.clone(), n) for p in (sb.y, sb.u, sb.v))


def _quality_chunk_loop(ref_it, dis_it, chunk: int, vif_egl, adm_egl, device, impl: str, tap=None,
                        runner=None, combined=None):
    """Consume lockstep (ref, dis) ``StagedFrameBatch`` iterators; returns
    (per-frame series keyed by ``CHUNK_KEYS``, n_frames). ``impl``:
    "kernel" (``chunk_kernels``) or "plain" (``chunk_plain``); ``runner``,
    if given, runs each chunk in their place with their arguments (the
    sharded loop's scatter and step, ``pipeline/quality_sharded.py``).
    ``tap(ref_host, dis_host, n, offset)``, if given, is called once per
    chunk with the decoded host batches, the chunk's count ``n`` of valid
    frames and the global index of its first frame. ``combined``, if given,
    is ``{"acc": ComplexityAccumulator, "complexity_on": "dis" | "ref"}``:
    every chunk runs the merged step (``chunk_combined``) and its complexity
    rows go to ``acc.add_packed``; it excludes ``tap`` and ``runner``."""
    if combined is not None and (tap is not None or runner is not None):
        raise ValueError("combined excludes tap and runner: the merged step computes the "
                         "complexity values itself, on one device")
    body = runner or (chunk_kernels if impl == "kernel" else chunk_plain)
    series: dict[str, list[np.ndarray]] = {k: [] for k in CHUNK_KEYS}
    carry_blur = None
    first = True
    n_frames = 0
    tails = None  # merged step: the target stream's last frame, on the device
    while True:
        rb = next(ref_it, None)
        db = next(dis_it, None)
        if rb is None or db is None:
            break
        rhost, dhost = rb.host, db.host
        n = min(rhost.y.shape[0], dhost.y.shape[0])
        planes = _device_planes(rb, n) + _device_planes(db, n)
        if n < chunk:
            count("padded_frames", chunk - n)
        if carry_blur is None:
            carry_blur = torch.zeros(rhost.y.shape[1:], dtype=torch.float32, device=device)
        if combined is None:
            with span("quality"):
                packed, carry_blur = body(*planes, carry_blur, not first, vif_egl, adm_egl)
        else:
            on = combined["complexity_on"]
            cplanes, chost = (planes[3:], dhost) if on == "dis" else (planes[:3], rhost)
            if tails is None:
                tails = tuple(torch.zeros_like(p[0]) for p in cplanes)
            suite = combined["acc"].suite(*cplanes[0].shape[1:])
            packed, carry_blur, *tails = chunk_combined(
                *planes, carry_blur, not first, *tails, vif_egl, adm_egl,
                suite=suite, complexity_on=on, impl=impl,
            )
        if tap is not None:
            with span("tap"):
                tap(rhost, dhost, n, n_frames)
        with span("fetch"):
            packed = packed.cpu().numpy()
        if combined is not None:
            combined["acc"].add_packed(packed[len(CHUNK_KEYS):, :n], chost.timestamps_ms[:n])
        for row, k in enumerate(CHUNK_KEYS):
            series[k].append(packed[row, :n])
        n_frames += n
        first = False
        if rhost.y.shape[0] != dhost.y.shape[0]:
            break  # one stream ended mid-batch: stop at the common prefix
    return {k: np.concatenate(v) for k, v in series.items() if v}, n_frames


def resolve_merged(merged: Optional[bool], frame_interval: int, device: str | torch.device | None) -> bool:
    """Whether ``analyze_combined`` runs the merged step. None means on at
    ``frame_interval`` 1 on the card (the JAX package's policy, with the
    card for its accelerator); True needs ``frame_interval`` 1, where every
    frame feeds both metrics. The ``frame_interval`` check comes before
    ``device`` is resolved."""
    if merged and frame_interval != 1:
        raise ValueError(
            "merged=True requires frame_interval=1 (every frame feeds the "
            f"combined chunk program); got frame_interval={frame_interval}"
        )
    if merged is None:
        return frame_interval == 1 and get_device(device).type == "cuda"
    return bool(merged)


def combined_chunk_loop(ref_it, dis_it, chunk: int, acc: ComplexityAccumulator,
                        frame_interval: int, complexity_on: str, vif_egl, adm_egl,
                        device, impl: str, merged: Optional[bool] = False):
    """The combined engine after the streams are open: the quality chunk
    loop over lockstep (ref, dis) ``StagedFrameBatch`` iterators, tapping
    the sampled frames of the complexity target (``complexity_on``: "dis",
    or "ref" for ``analyze_original``) into ``acc``. Sampling is 1-based, as
    ``decode_sampled``'s: global frames k-1, 2k-1, ... for
    ``frame_interval`` k. ``merged`` (``resolve_merged``) runs the merged
    step on every chunk in place of the tap. Returns (series, n_frames,
    ComplexityResult)."""
    def tap(rhost, dhost, n, offset):
        cb = dhost if complexity_on == "dis" else rhost
        keep = (np.arange(offset, offset + n) + 1) % frame_interval == 0
        if keep.any():
            acc.add(cb.y[:n][keep], cb.u[:n][keep], cb.v[:n][keep], cb.timestamps_ms[:n][keep])

    with clip():
        if resolve_merged(merged, frame_interval, device):
            series, n_frames = _quality_chunk_loop(
                ref_it, dis_it, chunk, vif_egl, adm_egl, device, impl,
                combined={"acc": acc, "complexity_on": complexity_on},
            )
        else:
            series, n_frames = _quality_chunk_loop(ref_it, dis_it, chunk, vif_egl, adm_egl, device, impl, tap)
        return series, n_frames, acc.finalize()


def _open_pair(ref_path: str, dis_path: str, chunk: Optional[int], dev: torch.device):
    """(chunk, ref iterator, dis iterator): ``auto_chunk`` for the ref
    stream's size, and both streams decoded in chunks on prefetch threads
    that stage full chunks on ``dev``."""
    with VideoStream(ref_path, 1, 1) as probe:
        chunk = auto_chunk(probe.info.width, probe.info.height, chunk)
    ref_it = prefetch(stage_to_device(VideoStream(ref_path, 1, chunk), chunk, dev), depth=1)
    dis_it = prefetch(stage_to_device(VideoStream(dis_path, 1, chunk), chunk, dev), depth=1)
    return chunk, ref_it, dis_it


def analyze_full_reference(
    ref_path: str,
    dis_path: str,
    chunk: Optional[int] = None,
    vmaf_model_path: Optional[str] = None,
    quality_precision: Optional[str] = None,
    device: str | torch.device | None = None,
) -> dict:
    """Stream both videos once; return pooled PSNR/SSIM/VMAF and the
    per-frame series. ``device`` defaults to the card, where the chunks run
    on the kernels; on the CPU they run on the plain ops."""
    resolve_precision(quality_precision)
    dev = get_device(device)
    impl = "kernel" if dev.type == "cuda" else "plain"
    # NEG models carry extractor options that change the feature programs.
    model = load_model(vmaf_model_path) if vmaf_model_path else None
    vif_egl = model.vif_enhn_gain_limit if model else None
    adm_egl = model.adm_enhn_gain_limit if model else None
    chunk, ref_it, dis_it = _open_pair(ref_path, dis_path, chunk, dev)
    try:
        with clip():
            s, n_frames = _quality_chunk_loop(ref_it, dis_it, chunk, vif_egl, adm_egl, dev, impl)
    finally:
        ref_it.close()
        dis_it.close()
    if n_frames == 0:
        return {"n_frames": 0}
    return pool_full_reference(s, n_frames, vmaf_model_path, model=model)


def analyze_combined(
    ref_path: str,
    dis_path: str,
    *,
    frame_interval: int = 10,
    resize_width: int = 64,
    resize_height: int = 64,
    smoothing_factor: float = 0.8,
    complexity_chunk: int = 32,
    complexity_on: str = "dis",
    chunk: Optional[int] = None,
    vmaf_model_path: Optional[str] = None,
    quality_precision: Optional[str] = None,
    motion_search: str = "pyramid",
    merged: Optional[bool] = None,
    device: str | torch.device | None = None,
):
    """One decode pass per stream: full-reference quality AND the
    eight-metric complexity suite (counterpart of ``analyze_combined``).
    Every ``frame_interval``-th frame of the complexity target stream
    (``complexity_on``: "dis", the encoded clip, or "ref") is tapped out of
    the quality loop into a ``ComplexityAccumulator`` of
    ``complexity_chunk`` frames. Returns ``(quality_dict, ComplexityResult)``.

    ``merged``: True runs the merged step (``chunk_combined``: the
    complexity values of every frame from the planes the quality chunk
    staged, one fetch per chunk) in place of the tap, and needs
    ``frame_interval`` 1; on the CPU it runs on the plain versions. None
    (the default) means on at ``frame_interval`` 1 on the card and the tap
    elsewhere (``resolve_merged``); False always taps."""
    resolve_precision(quality_precision)
    merged = resolve_merged(merged, frame_interval, device)
    dev = get_device(device)
    impl = "kernel" if dev.type == "cuda" else "plain"
    model = load_model(vmaf_model_path) if vmaf_model_path else None
    acc = ComplexityAccumulator(
        resize_width, resize_height, smoothing_factor, complexity_chunk,
        motion_search=motion_search, device=dev,
    )
    chunk, ref_it, dis_it = _open_pair(ref_path, dis_path, chunk, dev)
    try:
        s, n_frames, comp = combined_chunk_loop(
            ref_it, dis_it, chunk, acc, frame_interval, complexity_on,
            model.vif_enhn_gain_limit if model else None,
            model.adm_enhn_gain_limit if model else None, dev, impl, merged,
        )
    finally:
        ref_it.close()
        dis_it.close()
    if n_frames == 0:
        return {"n_frames": 0}, comp
    return pool_full_reference(s, n_frames, vmaf_model_path, model=model), comp


def pool_full_reference(
    s: dict[str, np.ndarray],
    n_frames: int,
    vmaf_model_path: Optional[str] = None,
    model=None,
) -> dict:
    """Pool per-frame series (keys ``CHUNK_KEYS``, each (n_frames,)) into
    the final metrics dict: PSNR of the mean MSE, mean SSIM, motion2 =
    min(sad[t], sad[t+1]) with frame 0 at 0, and the per-frame VMAF mean."""
    with span("pool"):
        psnr = float(pooled_psnr(torch.from_numpy(np.asarray(s["mse_avg"], np.float32))))
        ssim = float(np.mean(s["ssim_all"]))
        sad = s["motion_sad"]
        fwd = np.concatenate([sad[1:], [np.inf]])
        motion2 = np.minimum(sad, fwd)
        motion2[0] = 0.0
        feats = {
            "adm2": s["adm2"],
            "motion2": motion2.astype(np.float32),
            "vif_scale0": s["vif_scale0"],
            "vif_scale1": s["vif_scale1"],
            "vif_scale2": s["vif_scale2"],
            "vif_scale3": s["vif_scale3"],
        }
        vmaf_is_fallback = model is None and not vmaf_model_path
        if model is None and vmaf_model_path:
            model = load_model(vmaf_model_path)
        if model is None:
            model = builtin_model()
            logger.warning(
                "No VMAF model file given; using %s — scores are qualitative, not "
                "libvmaf-parity. Provide vmaf_v0.6.1.json via vmaf_model_path.",
                model.name,
            )
        vmaf_per_frame = model.predict(feats).numpy()
        return {
            "n_frames": n_frames,
            "psnr": psnr,
            "ssim": ssim,
            "vmaf": float(vmaf_per_frame.mean()),
            "per_frame": {"psnr": s["psnr_avg"], "ssim": s["ssim_all"], "vmaf": vmaf_per_frame, **feats},
            "vmaf_model": model.name,
            # True when the score came from the builtin fallback, not a libvmaf
            # model file (the CSV sink leaves the VMAF cell empty by default).
            "vmaf_is_fallback": vmaf_is_fallback,
        }
