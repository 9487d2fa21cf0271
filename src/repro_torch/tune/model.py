"""Deterministic fitted cost model over per-solve cost records (the port's
copy of repro/tune/model.py, numpy only: the same fits, the same JSON).

One log-space least-squares fit per ``(engine, nprocs)`` pair:

    log(wall_ms) ~ a0 + a1·log n + a2·log m + a3·log hops
                      + a4·log skew + a5·log batch

fitted with ``numpy.linalg.lstsq`` (minimum-norm, fully deterministic)
on the records of a versioned calibration sweep
(tune/calibrate.py).  The topology features (hops, skew — see
tune/features.py) separate the corpora the engines diverge on: a road
grid's ~200-sweep frontier solve and a random sparse graph's ~10-sweep
one sit at nearly the same (n, m).  At query points where a feature is
unknown (e.g. replaying a cost log that carries only the record fields)
the fit's mean value is imputed, making the prediction a marginal one —
tolerances downstream must absorb that (tune/replay.py's drift gate
does).

Determinism and confidence: the coefficients depend only on the records
(lstsq has no RNG); the ``seed`` drives a small bootstrap resample whose
prediction spread is reported as each fit's ``conf_log`` (one-sigma
log-space half-width).  Fitting twice with the same records and seed
yields byte-identical serialized models — tests/test_tune.py pins this,
and tests/test_torch_tune.py pins this copy's JSON to the JAX package's.

Support and fallback: each fit records the (n, m, batch) ranges it was
trained on; a query point is in a fit's support only within
``SUPPORT_MARGIN``× of those ranges (log-space).  Callers
(tune/select.py) fall back to the hard-coded threshold policy whenever
the point is outside every relevant fit's support — the conservative
contract: the model only ever overrides a default where it has data.

Delta engines are fitted on the per-point MINIMUM over the calibrated Δ
candidates (the cost of the engine *with its best static*), and the
argmin Δ is retained per point so ``best_delta`` can return the
measured-best width for the nearest calibrated point.  ``best_batch``
does the same for the multisource bucket size (per-source cost argmin).
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "MODEL_SCHEMA",
    "SUPPORT_MARGIN",
    "EngineFit",
    "CostModel",
    "fit_model",
    "load_calibration",
    "load_model",
]

MODEL_SCHEMA = 1

# multiplicative log-space slack around each fit's trained ranges:
# a query at n up to 2x outside the calibrated n-range still counts as
# supported; beyond it the selector must fall back to the thresholds.
SUPPORT_MARGIN = 2.0

# design-matrix feature order (after the intercept)
FEATURE_NAMES = ("log_n", "log_m", "log_hops", "log_skew", "log_batch")

# fits with fewer records than this are not trusted (rank-deficient fits
# are fine for lstsq but interpolate nothing)
MIN_RECORDS = 3

# a non-default Δ candidate must beat the auto width by this fraction at
# the nearest calibrated point before best_delta returns it.  Identical
# configs drift 20-35% between runs on shared CPU hosts, so anything
# inside that band is timer noise and must not displace the
# graph-derived auto width.
DELTA_WIN_MARGIN = 0.25


def _safe_log(x: float) -> float:
    return math.log(max(float(x), 1e-9))


def _row_features(rec: Dict[str, Any]) -> Dict[str, float]:
    return {
        "log_n": _safe_log(rec["n"]),
        "log_m": _safe_log(rec.get("m") or 1.0),
        "log_hops": _safe_log(rec.get("hops") or 1.0),
        "log_skew": _safe_log(rec.get("skew") or 1.0),
        "log_batch": _safe_log(rec.get("batch") or 1),
    }


@dataclasses.dataclass
class EngineFit:
    """One (engine, nprocs) log-linear fit plus its provenance."""

    engine: str
    nprocs: int
    coef: Tuple[float, ...]           # intercept + FEATURE_NAMES order
    n_records: int                    # rows the fit was trained on
    rms_log_err: float                # RMS log-residual on training rows
    conf_log: float                   # bootstrap one-sigma log half-width
    feature_means: Dict[str, float]   # mean log feature (imputation)
    support: Dict[str, Tuple[float, float]]   # raw-space (min, max)
    # per calibrated point: the measured-best statics for nearest-point
    # lookup — (n, m, best delta, best batch, best wall_ms)
    points: List[Dict[str, float]]

    def predict_log(self, feats: Dict[str, float]) -> float:
        x = [1.0] + [feats.get(name, self.feature_means[name])
                     if feats.get(name) is not None
                     else self.feature_means[name]
                     for name in FEATURE_NAMES]
        return float(np.dot(self.coef, x))

    def in_support(self, *, n: float, m: Optional[float] = None,
                   batch: Optional[float] = None,
                   margin: float = SUPPORT_MARGIN) -> bool:
        def ok(name, val):
            if val is None or name not in self.support:
                return True
            lo, hi = self.support[name]
            return lo / margin <= float(val) <= hi * margin
        return ok("n", n) and ok("m", m) and ok("batch", batch)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["coef"] = list(self.coef)
        d["support"] = {k: list(v) for k, v in self.support.items()}
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EngineFit":
        return cls(
            engine=d["engine"], nprocs=int(d["nprocs"]),
            coef=tuple(float(c) for c in d["coef"]),
            n_records=int(d["n_records"]),
            rms_log_err=float(d["rms_log_err"]),
            conf_log=float(d["conf_log"]),
            feature_means={k: float(v)
                           for k, v in d["feature_means"].items()},
            support={k: (float(v[0]), float(v[1]))
                     for k, v in d["support"].items()},
            points=[{k: float(v) for k, v in p.items()}
                    for p in d["points"]],
        )


def _point_key(r: Dict[str, Any]) -> tuple:
    return (r.get("corpus") or r.get("graph") or "", int(r["n"]),
            int(r.get("m") or 0), int(r.get("batch") or 1))


def _collapse_statics(records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Per calibrated point (corpus, n, m, batch): keep the min-wall
    record over the swept statics (Δ candidates), remembering the argmin
    — the engine's cost *when tuned*, which is what selection compares."""
    best: Dict[tuple, Dict[str, Any]] = {}
    for r in records:
        key = _point_key(r)
        cur = best.get(key)
        if cur is None or float(r["wall_ms"]) < float(cur["wall_ms"]):
            best[key] = r
    return [best[k] for k in sorted(best)]


def _fit_one(engine: str, nprocs: int, records: List[Dict[str, Any]],
             seed: int) -> EngineFit:
    rows = _collapse_statics(records)
    feats = [_row_features(r) for r in rows]
    X = np.array([[1.0] + [f[name] for name in FEATURE_NAMES]
                  for f in feats], dtype=np.float64)
    y = np.array([_safe_log(r["wall_ms"]) for r in rows], dtype=np.float64)
    coef, *_ = np.linalg.lstsq(X, y, rcond=None)
    resid = X @ coef - y
    rms = float(np.sqrt(np.mean(resid ** 2))) if len(rows) else 0.0
    means = {name: float(np.mean([f[name] for f in feats]))
             for name in FEATURE_NAMES}
    # seeded bootstrap: spread of the mean-point prediction across
    # resampled fits — reported, not used in selection
    conf = 0.0
    if len(rows) >= 4:
        rng = np.random.default_rng(seed)
        x_mean = np.array([1.0] + [means[n_] for n_ in FEATURE_NAMES])
        preds = []
        for _ in range(16):
            idx = rng.integers(0, len(rows), size=len(rows))
            cb, *_ = np.linalg.lstsq(X[idx], y[idx], rcond=None)
            preds.append(float(x_mean @ cb))
        conf = float(np.std(preds))
    support = {
        "n": (min(float(r["n"]) for r in rows),
              max(float(r["n"]) for r in rows)),
        "m": (min(float(r.get("m") or 1) for r in rows),
              max(float(r.get("m") or 1) for r in rows)),
        "batch": (min(float(r.get("batch") or 1) for r in rows),
                  max(float(r.get("batch") or 1) for r in rows)),
    }
    points = [{"n": float(r["n"]), "m": float(r.get("m") or 0),
               "batch": float(r.get("batch") or 1),
               "delta": float(r.get("delta") or 0.0),
               "wall_ms": float(r["wall_ms"])} for r in rows]
    # keep the auto-Δ candidate's own measurement alongside each point's
    # argmin, so best_delta can demand a real margin before overriding
    auto_at: Dict[tuple, Dict[str, Any]] = {}
    for r in records:
        if r.get("delta_kind") == "auto":
            auto_at[_point_key(r)] = r
    for p, r in zip(points, rows):
        a = auto_at.get(_point_key(r))
        if a is not None:
            p["delta_auto"] = float(a.get("delta") or 0.0)
            p["wall_auto"] = float(a["wall_ms"])
    return EngineFit(engine=engine, nprocs=nprocs,
                     coef=tuple(float(c) for c in coef),
                     n_records=len(rows), rms_log_err=rms, conf_log=conf,
                     feature_means=means, support=support, points=points)


class CostModel:
    """Per-(engine, nprocs) fitted cost surfaces + statics lookup."""

    def __init__(self, fits: Dict[Tuple[str, int], EngineFit],
                 meta: Optional[Dict[str, Any]] = None):
        self.fits = fits
        self.meta = dict(meta or {})

    # -- queries ----------------------------------------------------------

    def fit_for(self, engine: str, nprocs: int = 1) -> Optional[EngineFit]:
        return self.fits.get((engine, int(nprocs)))

    def engines(self) -> List[Tuple[str, int]]:
        return sorted(self.fits)

    def predict(self, engine: str, *, n: int, m: Optional[int] = None,
                hops: Optional[float] = None, skew: Optional[float] = None,
                batch: int = 1, nprocs: int = 1) -> Optional[float]:
        """Predicted wall_ms, or None when no fit exists for the pair.
        Missing features are imputed with the fit's training means."""
        fit = self.fit_for(engine, nprocs)
        if fit is None:
            return None
        feats = {
            "log_n": _safe_log(n),
            "log_m": _safe_log(m) if m else None,
            "log_hops": _safe_log(hops) if hops else None,
            "log_skew": _safe_log(skew) if skew else None,
            "log_batch": _safe_log(batch or 1),
        }
        return float(math.exp(fit.predict_log(feats)))

    def in_support(self, engine: str, *, n: int, m: Optional[int] = None,
                   batch: Optional[int] = None, nprocs: int = 1,
                   margin: float = SUPPORT_MARGIN) -> bool:
        fit = self.fit_for(engine, nprocs)
        return (fit is not None
                and fit.n_records >= MIN_RECORDS
                and fit.in_support(n=n, m=m, batch=batch, margin=margin))

    def _nearest_points(self, engine: str, nprocs: int, n: int,
                        m: Optional[int]) -> List[Dict[str, float]]:
        fit = self.fit_for(engine, nprocs)
        if fit is None or not fit.points:
            return []
        ln, lm = _safe_log(n), _safe_log(m or 1)

        def dist(p):
            d = (_safe_log(p["n"]) - ln) ** 2
            if m:
                d += (_safe_log(p["m"]) - lm) ** 2
            return d

        dmin = min(dist(p) for p in fit.points)
        return [p for p in fit.points if dist(p) <= dmin + 1e-12]

    def best_delta(self, engine: str, *, n: int, m: Optional[int] = None,
                   nprocs: int = 1) -> Optional[float]:
        """Measured-best Δ at the nearest calibrated point (None when the
        engine has no fit or the nearest point carried no Δ).  When the
        calibration tagged the auto-Δ candidate, a non-default width is
        returned only if it beat the auto one by ``DELTA_WIN_MARGIN`` —
        a within-noise win keeps the graph-derived default."""
        pts = [p for p in self._nearest_points(engine, nprocs, n, m)
               if p.get("delta")]
        if not pts:
            return None
        best = min(pts, key=lambda p: p["wall_ms"])
        auto_wall = best.get("wall_auto")
        if (auto_wall and best.get("delta_auto")
                and best["delta"] != best["delta_auto"]
                and best["wall_ms"] > (1.0 - DELTA_WIN_MARGIN) * auto_wall):
            return float(best["delta_auto"])
        return float(best["delta"])

    def best_batch(self, *, n: int, m: Optional[int] = None,
                   nprocs: int = 1,
                   engine: str = "multisource_csr") -> Optional[int]:
        """Calibrated bucket size minimizing per-source cost at the
        nearest (n, m) point of the batched engine's fit."""
        fit = self.fit_for(engine, nprocs)
        if fit is None or not fit.points:
            return None
        ln, lm = _safe_log(n), _safe_log(m or 1)
        by_point: Dict[tuple, List[Dict[str, float]]] = {}
        for p in fit.points:
            by_point.setdefault((p["n"], p["m"]), []).append(p)
        key = min(by_point, key=lambda k: (_safe_log(k[0]) - ln) ** 2
                  + ((_safe_log(k[1]) - lm) ** 2 if m else 0.0))
        best = min(by_point[key],
                   key=lambda p: p["wall_ms"] / max(p["batch"], 1.0))
        return int(best["batch"])

    # -- coverage / io ----------------------------------------------------

    def coverage(self) -> Dict[str, Any]:
        return {
            "engines": [f"{e}@P{p}" for e, p in self.engines()],
            "records": sum(f.n_records for f in self.fits.values()),
            "rms_log_err": {f"{e}@P{p}": round(self.fits[(e, p)].rms_log_err, 4)
                            for e, p in self.engines()},
            "conf_log": {f"{e}@P{p}": round(self.fits[(e, p)].conf_log, 4)
                         for e, p in self.engines()},
        }

    def to_json(self) -> str:
        doc = {
            "schema": MODEL_SCHEMA,
            "meta": self.meta,
            "fits": [self.fits[k].to_dict() for k in sorted(self.fits)],
        }
        return json.dumps(doc, indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "CostModel":
        doc = json.loads(text)
        if doc.get("schema") != MODEL_SCHEMA:
            raise ValueError(
                f"cost-model schema {doc.get('schema')!r} != {MODEL_SCHEMA}")
        fits = {}
        for fd in doc["fits"]:
            fit = EngineFit.from_dict(fd)
            fits[(fit.engine, fit.nprocs)] = fit
        return cls(fits, doc.get("meta"))


def fit_model(records: List[Dict[str, Any]], *, seed: int = 0,
              min_records: int = MIN_RECORDS,
              meta: Optional[Dict[str, Any]] = None) -> CostModel:
    """Fit one :class:`CostModel` from calibration (or cost-log) record
    dicts.  Non-converged records are dropped; (engine, nprocs) groups
    with fewer than ``min_records`` distinct points are skipped and
    reported in ``meta["skipped"]``."""
    groups: Dict[Tuple[str, int], List[Dict[str, Any]]] = {}
    dropped = 0
    for r in records:
        if not r.get("converged", True) or float(r.get("wall_ms", 0)) <= 0:
            dropped += 1
            continue
        groups.setdefault((str(r["engine"]), int(r.get("nprocs") or 1)),
                          []).append(r)
    fits: Dict[Tuple[str, int], EngineFit] = {}
    skipped = []
    for key in sorted(groups):
        pts = _collapse_statics(groups[key])
        if len(pts) < min_records:
            skipped.append(f"{key[0]}@P{key[1]}:{len(pts)}")
            continue
        fits[key] = _fit_one(key[0], key[1], groups[key], seed)
    out_meta = dict(meta or {})
    out_meta.setdefault("seed", seed)
    out_meta["dropped_records"] = dropped
    out_meta["skipped_groups"] = skipped
    return CostModel(fits, out_meta)


def load_calibration(path: str) -> Tuple[List[Dict[str, Any]],
                                         Dict[str, Any]]:
    """Read a tune/calibrate.py calibration file; returns
    ``(records, meta)``."""
    with open(path) as f:
        doc = json.load(f)
    if "records" not in doc:
        raise ValueError(f"{path}: not a calibration file (no records)")
    return list(doc["records"]), dict(doc.get("meta") or {})


def load_model(path: str, *, seed: int = 0) -> CostModel:
    """Fit a model straight from a calibration file — the
    one-call path selectors and CLIs use."""
    records, meta = load_calibration(path)
    keep = {k: meta.get(k) for k in ("backend", "device_kind", "schema",
                                     "smoke", "created_unix")
            if k in meta}
    keep["calibration"] = path
    return fit_model(records, seed=seed, meta=keep)
