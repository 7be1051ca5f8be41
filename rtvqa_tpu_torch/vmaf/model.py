"""VMAF model loading and SVR prediction (counterpart of
``rtvqa_tpu/vmaf/model.py``).

Loads the libvmaf model format: a JSON file whose ``model_dict`` carries the
feature names, the linear-rescale normalization (slopes/intercepts), the
score clip/transform and a libsvm nu-SVR blob (RBF kernel), e.g.
``vmaf_v0.6.1.json``. Per frame:

1. normalize each feature: ``x' = slope[i+1] * x + intercept[i+1]``;
2. RBF nu-SVR: ``y' = sum_j coef_j * exp(-gamma * ||x' - sv_j||^2) - rho``;
3. denormalize ``y = (y' - intercept[0]) / slope[0]``;
4. optional polynomial score transform, then clip to ``score_clip``.

Prediction runs in f32 torch on the host: the distance product is one
``torch.matmul`` outside any kernel. ``builtin_model()`` is the labelled
linear fallback over the same six features (NOT libvmaf score parity).
``model_from_numpy`` builds a model from another implementation's fields,
so one set of weights can drive both.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch

DEFAULT_FEATURES = (
    "VMAF_feature_adm2_score",
    "VMAF_feature_motion2_score",
    "VMAF_feature_vif_scale0_score",
    "VMAF_feature_vif_scale1_score",
    "VMAF_feature_vif_scale2_score",
    "VMAF_feature_vif_scale3_score",
)

FEATURE_KEY_MAP = {
    "adm2": "VMAF_feature_adm2_score",
    "motion2": "VMAF_feature_motion2_score",
    "vif_scale0": "VMAF_feature_vif_scale0_score",
    "vif_scale1": "VMAF_feature_vif_scale1_score",
    "vif_scale2": "VMAF_feature_vif_scale2_score",
    "vif_scale3": "VMAF_feature_vif_scale3_score",
}
_SHORT_KEY = {v: k for k, v in FEATURE_KEY_MAP.items()}


@dataclasses.dataclass(frozen=True)
class VmafModel:
    feature_names: tuple[str, ...]
    slopes: np.ndarray          # (n_feat + 1,) — [0] rescales the score
    intercepts: np.ndarray      # (n_feat + 1,)
    kind: str                   # 'rbf_nusvr' | 'linear'
    gamma: float = 0.0
    rho: float = 0.0
    sv: Optional[np.ndarray] = None       # (n_sv, n_feat)
    sv_coef: Optional[np.ndarray] = None  # (n_sv,)
    weights: Optional[np.ndarray] = None  # (n_feat,)
    bias: float = 0.0
    score_clip: Optional[tuple[float, float]] = (0.0, 100.0)
    score_transform: Optional[tuple[float, ...]] = None  # polynomial (p0, p1, ...)
    name: str = "unnamed"
    # libvmaf ``feature_opts_dicts``, merged: NEG-mode models carry
    # {'vif_enhn_gain_limit': x, 'adm_enhn_gain_limit': y}.
    feature_opts: tuple[tuple[str, float], ...] = ()

    @property
    def vif_enhn_gain_limit(self) -> Optional[float]:
        return dict(self.feature_opts).get("vif_enhn_gain_limit")

    @property
    def adm_enhn_gain_limit(self) -> Optional[float]:
        return dict(self.feature_opts).get("adm_enhn_gain_limit")

    def predict(self, features: dict) -> torch.Tensor:
        """Per-frame scores (N,) f32 from per-frame feature arrays, keyed
        by model feature name or by the extractors' short key."""
        cols = []
        for fname in self.feature_names:
            short = _SHORT_KEY.get(fname, fname)
            if fname in features:
                col = features[fname]
            elif short in features:
                col = features[short]
            else:
                raise KeyError(f"model needs feature {fname!r}; have {sorted(features)}")
            cols.append(torch.as_tensor(np.asarray(col), dtype=torch.float32))
        x = torch.stack(cols, dim=-1)  # (N, n_feat)

        slopes = torch.as_tensor(self.slopes, dtype=torch.float32)
        intercepts = torch.as_tensor(self.intercepts, dtype=torch.float32)
        xn = x * slopes[1:] + intercepts[1:]

        if self.kind == "rbf_nusvr":
            sv = torch.as_tensor(self.sv, dtype=torch.float32)          # (S, F)
            coef = torch.as_tensor(self.sv_coef, dtype=torch.float32)   # (S,)
            # ||x - s||^2 = |x|^2 + |s|^2 - 2 x.s — one matmul.
            x2 = (xn * xn).sum(dim=-1, keepdim=True)                    # (N, 1)
            s2 = (sv * sv).sum(dim=-1)[None, :]                         # (1, S)
            dist_sq = (x2 + s2 - 2.0 * torch.matmul(xn, sv.T)).clamp_min(0.0)
            y = torch.exp(-self.gamma * dist_sq) @ coef - self.rho
        elif self.kind == "linear":
            w = torch.as_tensor(self.weights, dtype=torch.float32)
            y = xn @ w + self.bias
        else:
            raise ValueError(self.kind)

        score = (y - intercepts[0]) / slopes[0]
        if self.score_transform is not None:
            t = torch.zeros_like(score)
            for i, c in enumerate(self.score_transform):
                t = t + c * score**i
            score = t
        if self.score_clip is not None:
            score = score.clamp(self.score_clip[0], self.score_clip[1])
        return score


def model_from_numpy(fields: dict) -> VmafModel:
    """A model from plain fields (the dataclass fields of a VMAF model,
    arrays as numpy): the way one set of weights drives this package and
    another implementation alike."""
    known = {f.name for f in dataclasses.fields(VmafModel)}
    extra = set(fields) - known
    if extra:
        raise ValueError(f"unknown model fields {sorted(extra)}")
    kw = dict(fields)
    for key in ("slopes", "intercepts", "sv", "sv_coef", "weights"):
        if kw.get(key) is not None:
            kw[key] = np.asarray(kw[key], np.float64)
    kw["feature_names"] = tuple(kw["feature_names"])
    for key in ("score_clip", "score_transform", "feature_opts"):
        if kw.get(key) is not None:
            kw[key] = tuple(tuple(x) if isinstance(x, (list, tuple)) else x for x in kw[key])
    return VmafModel(**kw)


def _parse_libsvm_text(text: str) -> dict:
    """Parse a libsvm nu-SVR model dump (the ``model`` blob in vmaf JSON)."""
    header: dict = {}
    sv_lines: list[str] = []
    in_sv = False
    for line in text.strip().splitlines():
        line = line.strip()
        if not line:
            continue
        if in_sv:
            sv_lines.append(line)
            continue
        if line == "SV":
            in_sv = True
            continue
        parts = line.split()
        header[parts[0]] = parts[1:]
    coefs, vecs = [], []
    n_feat = 0
    for line in sv_lines:
        parts = line.split()
        coefs.append(float(parts[0]))
        pairs = [p.split(":") for p in parts[1:]]
        if pairs:
            n_feat = max(n_feat, max(int(i) for i, _ in pairs))
        vecs.append({int(i): float(v) for i, v in pairs})
    sv = np.zeros((len(vecs), n_feat), np.float64)
    for r, d in enumerate(vecs):
        for i, val in d.items():
            sv[r, i - 1] = val
    return {
        "gamma": float(header.get("gamma", ["0"])[0]),
        "rho": float(header.get("rho", ["0"])[0]),
        "sv_coef": np.asarray(coefs, np.float64),
        "sv": sv,
        "kernel": header.get("kernel_type", ["rbf"])[0],
    }


def load_model(path: str) -> VmafModel:
    """Load a libvmaf-format model JSON (v2 ``model_dict`` layout)."""
    with open(path) as f:
        raw = json.load(f)
    md = raw.get("model_dict", raw)
    clip = tuple(md["score_clip"]) if md.get("score_clip") else None
    transform = None
    st = md.get("score_transform")
    if st:
        coeffs = []
        i = 0
        while f"p{i}" in st:
            coeffs.append(float(st[f"p{i}"]))
            i += 1
        transform = tuple(coeffs) if coeffs else None
    opts: dict[str, float] = {}
    for d in md.get("feature_opts_dicts") or []:
        if isinstance(d, dict):
            for k, v in d.items():
                opts[str(k)] = float(v)

    model_blob = md.get("model")
    if isinstance(model_blob, str):
        svm = _parse_libsvm_text(model_blob)
        if svm["kernel"] != "rbf":
            raise ValueError(f"unsupported SVM kernel {svm['kernel']!r}")
        return VmafModel(
            feature_names=tuple(md["feature_names"]),
            slopes=np.asarray(md["slopes"], np.float64),
            intercepts=np.asarray(md["intercepts"], np.float64),
            kind="rbf_nusvr",
            gamma=svm["gamma"],
            rho=svm["rho"],
            sv=svm["sv"],
            sv_coef=svm["sv_coef"],
            score_clip=clip,
            score_transform=transform,
            name=str(raw.get("version", path)),
            feature_opts=tuple(sorted(opts.items())),
        )
    raise ValueError(f"unrecognized model format in {path}")


def builtin_model() -> VmafModel:
    """Transparent linear fallback (NOT libvmaf score parity): features
    normalized to ~[0, 1] (motion2 scaled by 1/20), weights after published
    VMAF sensitivity analyses; perfect features with motion2 = 0 give 100."""
    n = len(DEFAULT_FEATURES)
    slopes = np.ones(n + 1, np.float64)
    intercepts = np.zeros(n + 1, np.float64)
    slopes[0] = 0.01  # score denormalization: y/0.01 -> 0..100
    slopes[2] = 1.0 / 20.0  # motion2 normalization (order: adm2, motion2, vif0..3)
    weights = np.asarray([0.45, -0.02, 0.10, 0.12, 0.15, 0.22], np.float64)
    bias = 1.0 - float(weights[0] + weights[2:].sum())
    return VmafModel(
        feature_names=DEFAULT_FEATURES,
        slopes=slopes,
        intercepts=intercepts,
        kind="linear",
        weights=weights,
        bias=bias,
        score_clip=(0.0, 100.0),
        name="rtvqa-builtin-linear-v1 (NOT libvmaf parity)",
    )
