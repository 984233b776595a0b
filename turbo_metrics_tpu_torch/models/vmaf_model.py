"""VMAF score fusion: libvmaf model files -> nu-SVR prediction on host.

The port's copy of the JAX package's models/vmaf_model.py (numpy only; the
port imports nothing of the JAX package).  Parity role of the reference's
libvmaf bindings (vmaf/src/lib.rs:160-245: ``score``/``score_pooled`` and
``VmafModel::load``): the elementary features (motion, vif_scale0..3, adm)
are computed on the device and the final support-vector regression runs on
host in f64 — the model is ~200 support vectors over 6 features.

Supports the libvmaf JSON model format (the ``.json`` files shipped in
libvmaf's ``model/`` directory, converted from the original pkl models):

  {"model_dict": {
      "model_type": "LIBSVMNUSVR",
      "feature_names": ["VMAF_feature_adm2_score", ...],
      "norm_type": "linear_rescale",
      "slopes": [s0, s1, ...], "intercepts": [i0, i1, ...],
      "score_clip": [0.0, 100.0],
      "score_transform": {"p0": .., "p1": .., "p2": .., "out_lte_in": ".."},
      "model": "svm_type nu_svr\\nkernel_type rbf\\n... SV\\n<coef> 1:<v> ..."
  }}

Prediction pipeline (mirrors libvmaf src/svm.c + src/model.c semantics):
  1. normalise each feature:  x'_i = slopes[i+1] * x_i + intercepts[i+1]
  2. SVR:                     y' = sum_j coef_j * K(x', sv_j) - rho
     with K rbf(u,v) = exp(-gamma*|u-v|^2) (linear kernel also supported)
  3. denormalise the score:   y  = (y' - intercepts[0]) / slopes[0]
  4. optional polynomial score transform with out_lte_in/out_gte_in guards
  5. clip to score_clip.

No model file ships with the repository (the upstream models are not
redistributed here); ``find_default_model`` honours ``TM_VMAF_MODEL``, then
looks at the vendored-model location that the JAX package also reads
(turbo_metrics_tpu/models/data/vmaf_v0.6.1.json, by path: reading a file is
not an import) and the usual install locations.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

# Canonical feature keys produced by the engine.
CANONICAL = (
    "adm2",
    "adm_scale0",
    "adm_scale1",
    "adm_scale2",
    "adm_scale3",
    "motion",
    "motion2",
    "vif_scale0",
    "vif_scale1",
    "vif_scale2",
    "vif_scale3",
    "vif",
)

_NAME_PATTERNS = [
    (re.compile(r"adm_scale0"), "adm_scale0"),
    (re.compile(r"adm_scale1"), "adm_scale1"),
    (re.compile(r"adm_scale2"), "adm_scale2"),
    (re.compile(r"adm_scale3"), "adm_scale3"),
    (re.compile(r"adm2|adm(?!\w)"), "adm2"),
    (re.compile(r"motion2"), "motion2"),
    (re.compile(r"motion(?!2)"), "motion"),
    (re.compile(r"vif_scale0"), "vif_scale0"),
    (re.compile(r"vif_scale1"), "vif_scale1"),
    (re.compile(r"vif_scale2"), "vif_scale2"),
    (re.compile(r"vif_scale3"), "vif_scale3"),
    (re.compile(r"vif(?!_scale)"), "vif"),
]

# Vendored-model drop-in location (first match wins): the JAX package's data
# directory, whose README explains the one-command fetch of the
# BSD-2-Clause-Plus-Patent upstream vmaf_v0.6.1.json; one vendored file then
# serves both packages.
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_DATA_DIR = os.path.join(_REPO, "turbo_metrics_tpu", "models", "data")

DEFAULT_MODEL_PATHS = (
    os.path.join(_DATA_DIR, "vmaf_v0.6.1.json"),
    "/usr/local/share/model/vmaf_v0.6.1.json",
    "/usr/share/model/vmaf_v0.6.1.json",
    "/usr/local/share/vmaf/model/vmaf_v0.6.1.json",
    "/usr/share/vmaf/model/vmaf_v0.6.1.json",
)


def canonical_feature_name(model_name: str) -> str:
    """Map a model-file feature name (e.g. 'VMAF_feature_adm2_score' or
    'integer_motion2') onto the engine's canonical feature key."""
    low = model_name.lower()
    for pat, key in _NAME_PATTERNS:
        if pat.search(low):
            return key
    raise ValueError(f"unsupported VMAF model feature: {model_name!r}")


@dataclass
class SvmModel:
    """A parsed libsvm regression model (text format embedded in the json)."""

    svm_type: str
    kernel: str
    gamma: float
    rho: float
    coef: np.ndarray  # (n_sv,)
    sv: np.ndarray  # (n_sv, n_features) dense

    @classmethod
    def parse(cls, text: str, n_features: int) -> "SvmModel":
        lines = iter(text.strip().splitlines())
        hdr: dict[str, str] = {}
        for line in lines:
            line = line.strip()
            if line == "SV":
                break
            if not line:
                continue
            k, _, v = line.partition(" ")
            hdr[k] = v
        svm_type = hdr.get("svm_type", "nu_svr")
        kernel = hdr.get("kernel_type", "rbf")
        if svm_type not in ("nu_svr", "epsilon_svr"):
            raise ValueError(f"unsupported svm_type {svm_type!r}")
        if kernel not in ("rbf", "linear"):
            raise ValueError(f"unsupported kernel_type {kernel!r}")
        gamma = float(hdr.get("gamma", 0.0))
        rho = float(hdr["rho"])
        coefs: list[float] = []
        rows: list[np.ndarray] = []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            parts = line.split()
            coefs.append(float(parts[0]))
            row = np.zeros(n_features, dtype=np.float64)
            for item in parts[1:]:
                idx, _, val = item.partition(":")
                i = int(idx) - 1  # libsvm indices are 1-based
                if not 0 <= i < n_features:
                    raise ValueError(f"SV index {idx} out of range")
                row[i] = float(val)
            rows.append(row)
        total = hdr.get("total_sv")
        if total is not None and int(total) != len(rows):
            raise ValueError(
                f"model declares total_sv {total} but has {len(rows)} SV lines"
            )
        return cls(
            svm_type=svm_type,
            kernel=kernel,
            gamma=gamma,
            rho=rho,
            coef=np.asarray(coefs, dtype=np.float64),
            sv=np.stack(rows) if rows else np.zeros((0, n_features)),
        )

    def predict(self, x: np.ndarray) -> np.ndarray:
        """x: (..., n_features) -> (...,) raw SVR decision values."""
        x = np.asarray(x, dtype=np.float64)
        if self.kernel == "rbf":
            # (..., 1, d) - (n_sv, d) -> (..., n_sv)
            d2 = ((x[..., None, :] - self.sv) ** 2).sum(axis=-1)
            k = np.exp(-self.gamma * d2)
        else:  # linear
            k = x @ self.sv.T
        return k @ self.coef - self.rho


@dataclass
class ScoreTransform:
    p0: float = 0.0
    p1: float = 1.0
    p2: float = 0.0
    out_lte_in: bool = False
    out_gte_in: bool = False

    def apply(self, y: np.ndarray) -> np.ndarray:
        t = self.p0 + self.p1 * y + self.p2 * y * y
        if self.out_lte_in:
            t = np.minimum(t, y)
        if self.out_gte_in:
            t = np.maximum(t, y)
        return t


@dataclass
class VmafModel:
    """A loaded VMAF fusion model, ready to predict from engine features."""

    name: str
    feature_names: list[str]  # canonical keys, model order
    svm: SvmModel
    norm_type: str = "linear_rescale"
    slopes: Optional[np.ndarray] = None  # (n_features + 1,)
    intercepts: Optional[np.ndarray] = None
    score_clip: Optional[tuple[float, float]] = None
    transform: Optional[ScoreTransform] = None
    raw_feature_names: list[str] = field(default_factory=list)

    # -- loading -------------------------------------------------------------

    @classmethod
    def load(cls, path: str) -> "VmafModel":
        with open(path, "r") as f:
            obj = json.load(f)
        name = os.path.splitext(os.path.basename(path))[0]
        return cls.from_dict(obj, name=name)

    @classmethod
    def from_dict(cls, obj: dict, *, name: str = "vmaf") -> "VmafModel":
        d = obj.get("model_dict", obj)
        model_type = d.get("model_type", "LIBSVMNUSVR")
        if model_type.upper() != "LIBSVMNUSVR":
            raise ValueError(f"unsupported model_type {model_type!r}")
        raw_names = list(d["feature_names"])
        feature_names = [canonical_feature_name(n) for n in raw_names]
        n = len(feature_names)
        svm = SvmModel.parse(d["model"], n)

        norm_type = d.get("norm_type", "none")
        slopes = intercepts = None
        if norm_type == "linear_rescale":
            slopes = np.asarray(d["slopes"], dtype=np.float64)
            intercepts = np.asarray(d["intercepts"], dtype=np.float64)
            if slopes.shape != (n + 1,) or intercepts.shape != (n + 1,):
                raise ValueError(
                    "slopes/intercepts must have n_features+1 entries "
                    f"(got {slopes.shape}, {intercepts.shape} for {n} features)"
                )
        elif norm_type != "none":
            raise ValueError(f"unsupported norm_type {norm_type!r}")

        clip = d.get("score_clip")
        score_clip = (float(clip[0]), float(clip[1])) if clip else None

        tr = d.get("score_transform")
        transform = None
        if tr:
            transform = ScoreTransform(
                p0=float(tr.get("p0", 0.0)),
                p1=float(tr.get("p1", 1.0)),
                p2=float(tr.get("p2", 0.0)),
                out_lte_in=str(tr.get("out_lte_in", "")).lower() == "true",
                out_gte_in=str(tr.get("out_gte_in", "")).lower() == "true",
            )

        return cls(
            name=name,
            feature_names=feature_names,
            svm=svm,
            norm_type=norm_type,
            slopes=slopes,
            intercepts=intercepts,
            score_clip=score_clip,
            transform=transform,
            raw_feature_names=raw_names,
        )

    # -- prediction ----------------------------------------------------------

    def predict(self, features: dict[str, np.ndarray]) -> np.ndarray:
        """features: canonical key -> (n_frames,) array. Returns (n_frames,)
        VMAF scores."""
        cols = []
        for key in self.feature_names:
            if key not in features:
                raise KeyError(
                    f"model {self.name} needs feature {key!r}; "
                    f"have {sorted(features)}"
                )
            cols.append(np.asarray(features[key], dtype=np.float64))
        x = np.stack(cols, axis=-1)  # (n_frames, n_features)
        if self.norm_type == "linear_rescale":
            x = self.slopes[1:] * x + self.intercepts[1:]
        y = self.svm.predict(x)
        if self.norm_type == "linear_rescale":
            y = (y - self.intercepts[0]) / self.slopes[0]
        if self.transform is not None:
            y = self.transform.apply(y)
        if self.score_clip is not None:
            y = np.clip(y, self.score_clip[0], self.score_clip[1])
        return y

    def predict_one(self, features: dict[str, float]) -> float:
        arr = {k: np.asarray([v], dtype=np.float64) for k, v in features.items()}
        return float(self.predict(arr)[0])


def find_default_model() -> Optional[str]:
    """Locate a usable vmaf_v0.6.1.json: $TM_VMAF_MODEL first, then the
    standard libvmaf install locations."""
    env = os.environ.get("TM_VMAF_MODEL")
    if env:
        return env if os.path.exists(env) else None
    for p in DEFAULT_MODEL_PATHS:
        if os.path.exists(p):
            return p
    return None


def motion2(motion: np.ndarray) -> np.ndarray:
    """libvmaf's 'motion2' = min(motion[i], motion[i+1]) with the last frame
    keeping its own motion (no lookahead available)."""
    m = np.asarray(motion, dtype=np.float64)
    if m.size <= 1:
        return m.copy()
    nxt = np.concatenate([m[1:], m[-1:]])
    return np.minimum(m, nxt)
