"""Measured-model engine selection behind the one dispatch seam (port of
repro/tune/select.py).

``TunedPolicy`` is a drop-in :class:`~repro_torch.serve.dispatch.
DispatchPolicy` whose ``choose()`` consults a fitted
:class:`~repro_torch.tune.model.CostModel` instead of the hard-coded size
thresholds — so both entry points that already route through the seam
(``api.shortest_paths(engine="auto")`` and ``MicroBatchScheduler``) become
self-tuning by swapping the policy, nothing else:

    from repro_torch.tune import TunedPolicy, load_model
    from repro_torch.serve.dispatch import policy_override

    policy = TunedPolicy(load_model("CALIBRATION_torch.json"), nprocs=1)
    with policy_override(policy):
        res = shortest_paths(cg, 0, engine="auto")

Selection compares the model's predicted wall time across the engines
legal for the query kind and returns the argmin *with its statics*: the
measured-best Δ for the Δ-stepping engine and the calibrated bucket
ceiling B for batched solves ride the returned ``EngineChoice``
(``via="model"``).

**The device picks the twin, and the model must come from that device.**
Like its base class, a policy for a CUDA device races the kernel twins
(``frontier_kernel``, ``bellman_csr_kernel``, ``delta_stepping_kernel``)
and a CPU policy JAX's plain engines; the calibration of that backend
fitted exactly those names (tune/calibrate.py).  A model whose
``meta["backend"]`` is not the policy device's backend (``"gpu"`` for
CUDA, ``"cpu"``) is refused with ``ValueError``: fed a CPU calibration, a
CUDA policy would find no fitted candidate and route every query by the
thresholds, a fallback that hides itself.

Conservative fallback (the contract the tests pin): the hard-coded
threshold rules decide whenever

- the graph is dynamic (overlays never shard and repair off-seam),
- the graph is not CSR-backed (no cheap features),
- the query point is outside the calibrated support of the incumbent
  (the engine the threshold policy would pick) or the incumbent pair
  has no fit at this shard arity — the model only overrides defaults
  where it has measured both the default and an alternative.

Every candidate engine is exact (bitwise-equal-to-serial is an engine
family invariant), so selection can never change answers — only wall
time.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.api import DELTA_ENGINES
from repro_torch.serve.dispatch import (DispatchPolicy, EngineChoice,
                                        engine_for)
from repro_torch.tune.model import CostModel

__all__ = ["TunedPolicy"]

# engines the model may race per query kind, single-device family (JAX's
# names; a CUDA policy races their kernel twins, serve.dispatch.engine_for)
_SINGLE_CANDIDATES = {
    "single": ("frontier", "bellman_csr", "delta_stepping"),
    # the batched engine is the only one with the shared-gather source
    # axis; p2p stays on frontier for the target= early exit
    "batch": ("multisource_csr",),
    "p2p": ("frontier",),
}
_SHARDED_CANDIDATES = {
    "single": ("frontier_sharded", "bellman_csr_sharded"),
    "batch": ("multisource_csr_sharded",),
    "p2p": ("frontier_sharded",),
}


class TunedPolicy(DispatchPolicy):
    """Threshold policy + fitted cost model; see module docstring.

    ``model``: a fitted :class:`CostModel` (``tune.load_model(path)``),
    measured on the backend of ``device``.  The threshold knobs
    (``shard_threshold`` etc.) keep their defaults and govern the
    fallback arm.  ``model_routed`` / ``fallback_routed`` count which arm
    decided each ``choose()`` call.
    """

    def __init__(self, model: CostModel, **kwargs):
        super().__init__(**kwargs)
        from repro_torch.obs.profile import backend_name

        want = backend_name(self.device)
        got = model.meta.get("backend")
        if got != want:
            raise ValueError(
                f"cost model measured on backend {got!r}, policy device "
                f"{self.device} is backend {want!r}: calibrate on this "
                f"device (python -m repro_torch.tune.calibrate --device "
                f"{self.device.type})")
        self.model = model
        self.model_routed = 0
        self.fallback_routed = 0

    # -- feature extraction ------------------------------------------------

    @staticmethod
    def _csr_of(g):
        """The underlying static CsrGraph of ``g`` (a CsrGraph itself, a
        registry GraphHandle, or None for dense/dynamic inputs)."""
        from repro_torch.core.csr import CsrGraph

        if isinstance(g, CsrGraph):
            return g
        cg = getattr(g, "cg", None)
        return cg if isinstance(cg, CsrGraph) else None

    # -- batched admission ceiling ----------------------------------------

    def batch_cap(self, g) -> Optional[int]:
        cg = self._csr_of(g)
        if cg is None or getattr(g, "dyn", None) is not None:
            return None
        engine = ("multisource_csr_sharded"
                  if self.would_shard(cg.n) else "multisource_csr")
        nprocs = self.nprocs if engine.endswith("_sharded") else 1
        if not self.model.in_support(engine, n=cg.n, m=cg.nnz,
                                     nprocs=nprocs):
            return None
        return self.model.best_batch(n=cg.n, m=cg.nnz, engine=engine,
                                     nprocs=nprocs)

    # -- selection ---------------------------------------------------------

    def _candidates(self, cg, kind: str) -> List[Tuple[str, int]]:
        """(engine, nprocs) pairs legal for this kind on this graph, named
        as this policy's device runs them."""
        out = [(engine_for(e, self.device), 1)
               for e in _SINGLE_CANDIDATES[kind]]
        if any(e in DELTA_ENGINES for e, _ in out):
            from repro_torch.core.delta_stepping import delta_profile

            if not delta_profile(cg)["routable"]:
                out = [(e, p) for e, p in out if e not in DELTA_ENGINES]
        if self.nprocs > 1 and self.shard_threshold is not None:
            out += [(e, self.nprocs) for e in _SHARDED_CANDIDATES[kind]]
        return out

    def choose(self, g, *, kind: str = "single") -> EngineChoice:
        base = super().choose(g, kind=kind)
        from repro_torch.dynamic.overlay import DynamicGraph

        dynamic = (isinstance(g, DynamicGraph)
                   or getattr(g, "dyn", None) is not None)
        cg = self._csr_of(g)
        if dynamic or cg is None:
            self.fallback_routed += 1
            return base
        from repro_torch.tune.features import graph_features

        feats = graph_features(cg)
        n, m = feats["n"], feats["m"]
        # conservative gate: the incumbent (threshold choice) must itself
        # be fitted and in calibrated support, else fall back outright.
        if not self.model.in_support(base.engine, n=n, m=m,
                                     nprocs=base.nprocs):
            self.fallback_routed += 1
            return base
        scored = []
        for engine, nprocs in self._candidates(cg, kind):
            if not self.model.in_support(engine, n=n, m=m, nprocs=nprocs):
                continue
            pred = self.model.predict(engine, n=n, m=m,
                                      hops=feats["hops"],
                                      skew=feats["skew"], nprocs=nprocs)
            if pred is not None and np.isfinite(pred):
                scored.append((float(pred), engine, nprocs))
        if not scored:
            self.fallback_routed += 1
            return base
        scored.sort()
        _, engine, nprocs = scored[0]
        self.model_routed += 1
        # the measured-best Δ rides along for either Δ engine, the plain
        # one and its kernel twin
        delta = (self.model.best_delta(engine, n=n, m=m, nprocs=nprocs)
                 if engine in DELTA_ENGINES else None)
        cap = (self.batch_cap(g) if kind == "batch" else None)
        return EngineChoice(engine, self.group if nprocs > 1 else None,
                            self.axis, nprocs, delta=delta, batch_cap=cap,
                            via="model")
