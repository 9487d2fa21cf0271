"""Seeded fault injection for the serving stack — the chaos harness (port
of repro/serve/faults.py: the same plan draws the same schedule).

A :class:`FaultPlan` is a deterministic schedule of failures injected at
the serving seams that already exist (nothing is monkeypatched; the
scheduler probes the plan at each seam), so a chaos replay is exactly
reproducible from ``(workload seed, fault seed, rates)`` and the
driver's verifier can cross-check every injected fault against the typed
``Answer.status`` (or retry counter) that surfaced it.

Sites — each maps to one seam in serve/scheduler.py / serve/registry.py:

``solve``
    The engine call of a batch/p2p solve raises :class:`InjectedFault`
    *before* the solve runs — the transient-failure path.  The scheduler
    catches it, requeues the tick's queries with capped exponential
    backoff, and answers ``solve_failed`` only once the per-query retry
    budget is spent.
``stage``
    Operand staging (``handle.csr_ops()`` / ``frontier_ops()`` /
    ``partition_ops()``) raises before the engine sees the operands —
    same surfaced behavior as ``solve``, different seam.
``evict``
    The query's graph is force-evicted from the registry *mid-tick*,
    after admission but before its solve — the evicted-graph race: the
    scheduler must answer that graph's drained queries ``graph_gone``
    (and purge its cache rows via the evict hook) while the same tick's
    other graphs still serve.
``mutate``
    A poisoned edit is appended to a drained mutation batch, forcing the
    registry's atomic-rollback seam: the whole batch must roll back
    (``DynamicGraph.rollback``) and every mutation in it is acked
    ``rejected`` — no half-applied version may ever be published.
``clip``
    The solve runs with ``max_sweeps=1``: the engine returns
    ``converged=False`` and the scheduler must answer ``not_converged``
    instead of serving the capped labels — the solver-guardrail path.

Probes draw from independent per-site generators seeded ``(seed,
site)``, so adding probes at one site never shifts another site's
schedule.  Every fired fault is logged as a :class:`FaultRecord`;
``counts()`` is what a chaos replay reconciles against its answers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

SITES = ("solve", "stage", "evict", "mutate", "clip")


class InjectedFault(RuntimeError):
    """The synthetic transient failure a FaultPlan raises at the solve /
    stage seams.  Deliberately NOT a ServeError: the scheduler's retry
    path must treat it exactly like any unexpected engine exception."""


@dataclasses.dataclass(frozen=True)
class FaultRecord:
    """One fired fault: where, the per-site firing index, and the graph
    being served when it fired (None where no graph is in scope)."""

    site: str
    seq: int
    graph: Optional[str] = None
    detail: str = ""


class FaultPlan:
    """Deterministic seeded fault schedule over the sites above.

    ``rates`` maps site -> firing probability per probe (unlisted sites
    never fire); ``max_per_site`` caps how often each site fires so a
    high rate cannot starve a replay of successful answers entirely.
    ``clip_sweeps`` is the ``max_sweeps`` value the ``clip`` site forces
    on a solve (1 = maximally capped).
    """

    def __init__(self, *, seed: int = 0, rates: Optional[dict] = None,
                 max_per_site: Optional[int] = None, clip_sweeps: int = 1):
        rates = dict(rates or {})
        unknown = set(rates) - set(SITES)
        if unknown:
            raise ValueError(f"unknown fault sites {sorted(unknown)}; "
                             f"choose from {SITES}")
        self.seed = seed
        self.rates = {s: float(rates.get(s, 0.0)) for s in SITES}
        self.max_per_site = max_per_site
        self.clip_sweeps = int(clip_sweeps)
        self._rngs = {s: np.random.default_rng((seed, i))
                      for i, s in enumerate(SITES)}
        self.injected: list[FaultRecord] = []
        self._fired = {s: 0 for s in SITES}
        self.probes = {s: 0 for s in SITES}

    def roll(self, site: str, *, graph: Optional[str] = None,
             detail: str = "") -> bool:
        """One probe at ``site``: True iff the fault fires (and is then
        logged).  Each probe consumes one draw from the site's own
        stream even when capped, so the schedule is a pure function of
        the probe sequence."""
        if site not in self._rngs:
            raise ValueError(f"unknown fault site {site!r}")
        self.probes[site] += 1
        fired = bool(self._rngs[site].random() < self.rates[site])
        if fired and (self.max_per_site is not None
                      and self._fired[site] >= self.max_per_site):
            fired = False
        if fired:
            self.injected.append(FaultRecord(
                site=site, seq=self._fired[site], graph=graph,
                detail=detail))
            self._fired[site] += 1
        return fired

    def maybe_raise(self, site: str, *, graph: Optional[str] = None,
                    detail: str = "") -> None:
        """Probe and raise :class:`InjectedFault` when the fault fires
        (the solve / stage seams)."""
        if self.roll(site, graph=graph, detail=detail):
            raise InjectedFault(
                f"injected {site} fault"
                + (f" on graph {graph!r}" if graph else ""))

    def counts(self) -> dict:
        """Fired-fault count per site (zeros included)."""
        return dict(self._fired)

    def summary(self) -> dict:
        return {
            "seed": self.seed,
            "rates": {s: r for s, r in self.rates.items() if r},
            "probes": dict(self.probes),
            "fired": self.counts(),
            "total_fired": len(self.injected),
        }
