"""ALT landmark preprocessing — admissible bounds from batched solves (port
of repro/serve/landmarks.py; ``LandmarkSet.D`` is a host numpy array).

"Optimizing Dijkstra for real-world performance" (arXiv:1505.05033) and the
heuristic-search framing of arXiv:2506.19349 both pay a one-time
precomputation to make repeated point-to-point queries cheap.  This module
is the ALT (A*, Landmarks, Triangle inequality) half of that trade: per
registered graph we run ONE batched ``multisource_csr`` solve over K
sampled landmark vertices — the same engine call a scheduler tick makes,
so the precompute is exactly as fast as serving K sources — and keep the
(K, n) distance matrix.

For an undirected graph the triangle inequality gives, for every landmark
L, the admissible lower bound

    d(s, t) >= |d(L, s) - d(L, t)|

(and the upper bound ``d(L, s) + d(L, t)``).  Three uses downstream:

* **exact answers**: a query *sourced* at a landmark (s in ``ids``) reads
  its solved row — bitwise-identical to any engine, it IS an engine row.
  (A query *targeting* a landmark is deliberately not answered from the
  reversed row: undirected symmetry is exact in real arithmetic but f32
  path sums traversed from the other end can differ by an ulp.)
* **exact unreachability**: if some landmark reaches s but not t, the two
  are in different components and ``d(s, t) = inf`` exactly.
* **pruning**: the lower bound feeds the frontier engines' ``target_lb=``
  early exit (core/frontier.py).  Exactness there demands admissibility,
  and the engine distances are f32 path sums whose rounding can nudge
  ``|a - b|`` a few ulps above the true f32 distance — so
  :meth:`LandmarkSet.conservative_lb` shrinks the bound by a relative +
  absolute margin before it is used as a stopping rule.  A shrunken bound
  can only fire later (never wrongly), so serving stays oracle-exact.

Directed graphs would need backward landmark distances for admissibility;
the registry refuses to build landmarks for them rather than serve an
inadmissible bound.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.bellman_csr import csr_operands, sssp_multisource_csr

# conservative_lb margins: engine distances are f32 path sums, so the
# subtraction below can exceed the true f32 distance by O(eps) relative
# rounding; shrink well past one ulp before using the bound as a stop rule.
_REL_MARGIN = 1e-5
_ABS_MARGIN = 1e-4


@dataclasses.dataclass(frozen=True)
class LandmarkSet:
    """K solved landmark rows for one graph.

    ids: (K,) int32 landmark vertex ids.
    D:   (K, n) float32 — row k is the exact SSSP row of ``ids[k]``, the
         output of one batched multisource solve (inf = unreachable).
    """

    ids: np.ndarray
    D: np.ndarray

    @property
    def k(self) -> int:
        return int(self.ids.shape[0])

    @property
    def nbytes(self) -> int:
        return int(self.ids.nbytes + self.D.nbytes)

    def row_of(self, vertex: int):
        """The solved distance row if ``vertex`` is a landmark, else None
        — the 'cache-adjacent' exact answer path."""
        hit = np.nonzero(self.ids == vertex)[0]
        return self.D[int(hit[0])] if hit.size else None

    def lower_bound(self, s: int, t: int) -> float:
        """Admissible (in exact arithmetic) lower bound on d(s, t):
        ``max_L |d(L,s) - d(L,t)|``, computed in float64 over the f32
        rows.  Returns inf when some landmark reaches exactly one of the
        endpoints (a proof of disconnection on an undirected graph), 0.0
        when no landmark gives information."""
        a = self.D[:, s].astype(np.float64)
        b = self.D[:, t].astype(np.float64)
        fa, fb = np.isfinite(a), np.isfinite(b)
        if bool(np.any(fa != fb)):
            return float("inf")
        both = fa & fb
        if not bool(np.any(both)):
            return 0.0
        return float(np.max(np.abs(a[both] - b[both])))

    def upper_bound(self, s: int, t: int) -> float:
        """``min_L d(L,s) + d(L,t)`` — a real path bound through the best
        landmark (inf if no landmark reaches both endpoints)."""
        a = self.D[:, s].astype(np.float64)
        b = self.D[:, t].astype(np.float64)
        both = np.isfinite(a) & np.isfinite(b)
        if not bool(np.any(both)):
            return float("inf")
        return float(np.min(a[both] + b[both]))

    def conservative_lb(self, s: int, t: int) -> float:
        """The lower bound shrunk by the f32-rounding margins — safe to
        pass as ``target_lb=`` (see module docstring).  inf (proven
        disconnection) passes through untouched: it is exact, not a
        rounding-sensitive magnitude."""
        lb = self.lower_bound(s, t)
        if not np.isfinite(lb):
            return lb
        return max(lb * (1.0 - _REL_MARGIN) - _ABS_MARGIN, 0.0)


def sample_landmark_ids(n: int, k: int, *, seed: int = 0) -> np.ndarray:
    """K distinct landmark ids, uniform without replacement.  Uniform
    sampling is the standard ALT baseline (farthest-point selection is a
    quality refinement, not a correctness one — any vertex set yields
    admissible bounds)."""
    if not 0 < k <= n:
        raise ValueError(f"need 0 < k <= n, got k={k}, n={n}")
    rng = np.random.default_rng(seed)
    return rng.choice(n, size=k, replace=False).astype(np.int32)


def build_landmarks(cg, k: int, *, seed: int = 0,
                    csr_ops: dict | None = None,
                    ids: np.ndarray | None = None,
                    sweep_fn=None, device="cuda") -> LandmarkSet:
    """One batched multisource solve over K sampled landmarks.

    ``csr_ops`` lets the registry reuse its staged operands (the solve
    then runs on their device); by default the arrays are staged on
    ``device`` ad hoc.  Directed graphs are refused — see module
    docstring.

    ``ids`` pins the landmark set instead of sampling — the lazy refresh
    after a graph mutation re-solves the SAME landmarks on the new
    version, so bound quality doesn't jitter with churn.  ``sweep_fn``
    threads a custom relax sweep to the engine (the dynamic-overlay sweep
    of dynamic/repair.py, for graphs registered as ``DynamicGraph``).
    """
    if getattr(cg, "directed", False):
        raise ValueError(
            "landmark bounds need symmetric distances; refusing to build "
            "an inadmissible bound for a directed graph")
    if ids is None:
        ids = sample_landmark_ids(cg.n, k, seed=seed)
    ops = csr_ops if csr_ops is not None else csr_operands(cg, device=device)
    ids = np.asarray(ids, np.int32)
    D, _, _ = sssp_multisource_csr(
        ops, torch.tensor(ids, dtype=torch.int64, device=ops["w"].device),
        n=cg.n, sweep_fn=sweep_fn)
    D = D.cpu().numpy()
    D.setflags(write=False)          # served as answers: never written
    return LandmarkSet(ids=ids, D=D)
