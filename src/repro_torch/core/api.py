"""Public facade of the port — the engines of ``repro.core.api`` behind one
call, on PyTorch.

    from repro_torch.core.api import shortest_paths
    res = shortest_paths(graph, source=0, engine="frontier_kernel")

Ported engines (single device):
    serial                Alg. 1, O(n²) textbook loop               (paper)
    bellman               Alg. 3/4 relax-to-fixpoint, dense min-plus matvec
                          sweep                                     (paper)
    bellman_kernel        same, CUDA min-plus kernel (kernels/sssp_relax)
    multisource           batched (S, n) dense fixpoint, plain sweep
    bellman_csr           fixpoint, O(m) scatter-min sweep on CSR
    bellman_csr_kernel    same, incoming-CSR CUDA kernel (kernels/csr_relax)
    frontier              frontier-compacted sweeps, O(active out-degree)
    frontier_kernel       same, fused CUDA push kernel (kernels/frontier_relax)
    delta_stepping        light/heavy split, per-bucket light pull fixpoint
                          plus one heavy push per bucket
    delta_stepping_kernel same, fused CUDA pull kernel (kernels/bucket_relax)
    multisource_csr       batched (S, n) fixpoint on CSR edges

Each engine gives the JAX engine's answers bit for bit: the same ``dist``,
the same ``pred`` (lowest-u tie-break), the same ``sweeps``,
``edges_relaxed`` and ``converged`` (None for the dense engines, as in
JAX).  The dense engines densify a ``CsrGraph`` input (O(n²)).  The sharded
engines belong to a later slice of the port and raise
``NotImplementedError``.

``engine="auto"`` asks the serving layer's dispatch policy
(serve/dispatch.py) for the engine: on the CPU it routes as the JAX
package's default policy does (``frontier``, ``multisource_csr``, or
``delta_stepping`` for large graphs whose weight profile allows it); on a
CUDA device it names the kernel twin (``frontier_kernel``,
``delta_stepping_kernel``), whose answers and counters are the same.

With a tracer or a cost log installed (repro_torch/obs), every solve runs
inside a ``solve`` span and emits one cost record stamped with its device.

``device`` defaults to ``"cuda"``, which needs a GPU; ``device="cpu"`` runs
every engine with the kernels' plain PyTorch versions.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core import csr as csr_mod
from repro_torch.core import graph as graph_mod
from repro_torch.core.bellman import predecessors_from_dist, sssp_bellman
from repro_torch.core.bellman_csr import (csr_operands,
                                          predecessors_from_dist_csr,
                                          sssp_bellman_csr,
                                          sssp_multisource_csr)
from repro_torch.core.delta_stepping import (auto_delta, delta_operands,
                                             sssp_delta_stepping)
from repro_torch.core.frontier import frontier_operands, sssp_frontier
from repro_torch.core.multisource import sssp_multisource
from repro_torch.core.serial import dijkstra_serial

ENGINES = (
    "serial",
    "dijkstra_sharded",
    "bellman",
    "bellman_kernel",
    "bellman_sharded",
    "multisource",
    "bellman_csr",
    "bellman_csr_kernel",
    "frontier",
    "frontier_kernel",
    "delta_stepping",
    "delta_stepping_kernel",
    "multisource_csr",
    "bellman_csr_sharded",
    "frontier_sharded",
    "multisource_csr_sharded",
)

CSR_ENGINES = ("bellman_csr", "bellman_csr_kernel",
               "frontier", "frontier_kernel")
FRONTIER_ENGINES = ("frontier", "frontier_kernel")
DELTA_ENGINES = ("delta_stepping", "delta_stepping_kernel")
# every engine that consumes (rather than ignores) the delta= argument
_DELTA_CONSUMERS = FRONTIER_ENGINES + DELTA_ENGINES
SHARDED_CSR_ENGINES = ("bellman_csr_sharded", "frontier_sharded",
                       "multisource_csr_sharded")
DENSE_ENGINES = ("bellman", "bellman_kernel", "multisource")
PORTED_ENGINES = (("serial",) + DENSE_ENGINES + CSR_ENGINES + DELTA_ENGINES
                  + ("multisource_csr",))
# the slice of the port each remaining engine waits for
_LATER_SLICE = {
    "dijkstra_sharded": "sharded", "bellman_sharded": "sharded",
    **{e: "sharded" for e in SHARDED_CSR_ENGINES},
}


@dataclasses.dataclass
class SsspResult:
    dist: np.ndarray            # (n,) or (S, n)
    pred: Optional[np.ndarray]  # (n,) int32, or None (recover_pred rebuilds it)
    sweeps: Optional[int]       # fixpoint engines only
    engine: str
    # measured relaxation work, CSR-family engines only: the frontier
    # engines count frontier out-degrees; bellman_csr* relax all nnz arcs
    # every sweep.
    edges_relaxed: Optional[int] = None
    # sources as submitted (multisource engines), for recover_pred.
    sources: Optional[np.ndarray] = None
    # False means a max_sweeps= cap stopped the loop before the fixpoint,
    # so dist may sit above the true distances.  None for serial.
    converged: Optional[bool] = None


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing CUDA when no GPU is present (no
    quiet move to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' needs a CUDA GPU and none is available; pass "
            "device='cpu' to run the plain PyTorch path")
    return dev


def refuse_sharded(devices: int, what: str) -> None:
    """Raise ``NotImplementedError`` when ``what`` asks for ``devices`` > 1:
    the sharded engines are not ported yet (ROADMAP A.11), and nothing
    quietly runs at one device instead."""
    if int(devices) > 1:
        raise NotImplementedError(
            f"{what} with {devices} devices needs the sharded engines, "
            f"which are not ported yet (ROADMAP A.11); run it on one device")


def _validate(engine, delta, target):
    """Eager checks, before any staging: unknown or unported engines, a bad
    Δ, and arguments an engine would silently ignore."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; choose from {ENGINES}")
    if delta is not None:
        if engine not in _DELTA_CONSUMERS:
            raise ValueError(
                f"delta= is consumed only by {_DELTA_CONSUMERS}; engine "
                f"{engine!r} would silently ignore it")
        if delta != "auto":
            try:
                delta = float(delta)
            except (TypeError, ValueError):
                raise ValueError(
                    f"delta must be a positive finite number or 'auto', "
                    f"got {delta!r}") from None
            if not (math.isfinite(delta) and delta > 0):
                raise ValueError(
                    f"delta must be positive and finite, got {delta!r}")
    if target is not None and engine not in FRONTIER_ENGINES + (
            "frontier_sharded",):
        raise ValueError(
            f"target= early exit needs a frontier engine "
            f"{FRONTIER_ENGINES}; got {engine!r}")
    if engine in _LATER_SLICE:
        raise NotImplementedError(
            f"engine {engine!r} is not ported yet: it comes with the "
            f"{_LATER_SLICE[engine]} slice of the port")
    return delta


def _edge_count(g) -> int:
    """Cheap arc count for the cost record: exact for CSR and dynamic
    inputs, 0 for dense ones (counting finite entries would cost O(n²))."""
    from repro_torch.dynamic.overlay import DynamicGraph

    if isinstance(g, DynamicGraph):
        return int(g.nnz_live)
    if isinstance(g, csr_mod.CsrGraph):
        return int(g.nnz)
    return 0


def _resolve_auto(g, source, *, engine, delta, target, device):
    """Resolve ``engine="auto"`` through the serving layer's dispatch seam
    (serve/dispatch.py): the default policy for ``device`` picks the engine
    and may give a Δ, which binds only when the caller passed none.
    Returns the concrete ``(engine, delta)``; other engines pass through."""
    if engine != "auto":
        return engine, delta
    from repro_torch.serve.dispatch import default_policy

    multi = np.ndim(source) > 0
    choice = default_policy(device).choose(
        g, kind="batch" if multi else ("p2p" if target is not None
                                       else "single"))
    engine = choice.engine
    if (delta is None and choice.delta is not None
            and engine in _DELTA_CONSUMERS):
        delta = float(choice.delta)
    return engine, delta


def shortest_paths(
    g: "graph_mod.Graph | csr_mod.CsrGraph | DynamicGraph | np.ndarray",
    source,
    *,
    engine: str = "serial",
    device="cuda",
    max_sweeps: int | None = None,
    delta: Union[float, str, None] = None,
    target: int | None = None,
    target_lb: float | None = None,
) -> SsspResult:
    """Observability shim over :func:`_shortest_paths` (the facade, same
    arguments and docs).  With a tracer or cost log installed
    (repro_torch/obs) the solve runs inside a ``solve`` span and emits one
    cost record (engine, n, m, sweeps, edges_relaxed, wall_ms, and the
    solve's device); with both disabled this adds two attribute reads and
    one branch."""
    from repro_torch.obs.profile import get_cost_log
    from repro_torch.obs.trace import get_tracer

    tr = get_tracer()
    cl = get_cost_log()
    if not (tr.enabled or cl.enabled):
        return _shortest_paths(g, source, engine=engine, device=device,
                               max_sweeps=max_sweeps, delta=delta,
                               target=target, target_lb=target_lb)

    import time as _time

    from repro_torch.obs.profile import backend_info

    # resolve "auto" here so the record carries the routed engine's Δ; the
    # facade passes the concrete engine straight through.
    engine, delta = _resolve_auto(g, source, engine=engine, delta=delta,
                                  target=target, device=device)
    m = _edge_count(g)
    t0 = _time.perf_counter()
    with tr.span("solve", engine=engine) as sp:
        res = _shortest_paths(g, source, engine=engine, device=device,
                              max_sweeps=max_sweeps, delta=delta,
                              target=target, target_lb=target_lb)
        wall_ms = (_time.perf_counter() - t0) * 1e3
        n = int(np.shape(res.dist)[-1])
        batch = int(np.shape(res.dist)[0]) if np.ndim(res.dist) == 2 else 1
        sweeps = 0 if res.sweeps is None else int(res.sweeps)
        edges = 0 if res.edges_relaxed is None else int(res.edges_relaxed)
        conv = True if res.converged is None else bool(res.converged)
        sp.set(engine=res.engine, n=n, m=m, batch=batch, sweeps=sweeps,
               edges_relaxed=edges, converged=conv)
    # the Δ the solve used: an explicit width verbatim; the delta engines'
    # None / "auto" resolve per graph through the memoized auto_delta.
    if isinstance(delta, (int, float)) and not isinstance(delta, bool):
        dval = float(delta)
    elif (res.engine in DELTA_ENGINES
          and isinstance(g, csr_mod.CsrGraph)):
        dval = float(auto_delta(g))
    else:
        dval = 0.0
    backend, kind = backend_info(device)
    cl.emit(engine=res.engine, n=n, m=m, batch=batch, nprocs=1, delta=dval,
            sweeps=sweeps, edges_relaxed=edges, wall_ms=wall_ms,
            converged=conv, backend=backend, device_kind=kind)
    return res


def _shortest_paths(
    g: "graph_mod.Graph | csr_mod.CsrGraph | DynamicGraph | np.ndarray",
    source,
    *,
    engine: str = "serial",
    device="cuda",
    max_sweeps: int | None = None,
    delta: Union[float, str, None] = None,
    target: int | None = None,
    target_lb: float | None = None,
) -> SsspResult:
    """Run one SSSP engine on ``device``.  ``source`` is an int (or an int
    array for ``multisource`` and ``multisource_csr``).  ``g`` is a
    ``CsrGraph``, a dense ``Graph`` or an (n, n) adjacency array; the CSR
    engines convert dense input, ``serial`` and the dense engines densify
    CSR input (O(n²)).  A ``DynamicGraph`` is solved as its current
    ``snapshot()``.

    ``delta`` sets the Δ-bucket width of the frontier and ``delta_stepping``
    engines: a positive finite number or ``"auto"`` (per graph, from
    core/delta_stepping.auto_delta; the delta engines also take ``None`` as
    auto).  Bad values raise ``ValueError`` before any work, as does
    ``delta=`` for an engine that would ignore it.

    ``target=`` (frontier engines) stops as soon as ``dist[target]`` is
    final; the row is partial (entries above ``dist[target]`` may sit above
    their fixpoint), so ``pred`` is None.  ``target_lb=`` adds an admissible
    lower bound on the distance as a second stopping rule.

    ``engine="auto"`` takes the engine (and, when ``delta`` is None, a Δ)
    from ``serve.dispatch.default_policy(device)``.
    """
    engine, delta = _resolve_auto(g, source, engine=engine, delta=delta,
                                  target=target, device=device)
    delta = _validate(engine, delta, target)
    dev = resolve_device(device)

    from repro_torch.dynamic.overlay import DynamicGraph  # dynamic uses api

    if isinstance(g, DynamicGraph):
        # the current version through its snapshot CSR (exact by
        # construction); the overlay engines that skip the snapshot are
        # dynamic/repair.py's solve_dynamic and repair_sssp
        g = g.snapshot()

    if isinstance(g, csr_mod.CsrGraph):
        cg = g
    else:
        if not isinstance(g, graph_mod.Graph):
            adj = np.asarray(g, np.float32)
            g = graph_mod.Graph(adj=adj, n=adj.shape[0])
        cg = None

    if engine == "serial" or engine in DENSE_ENGINES:
        adj = torch.tensor((cg.to_dense() if cg is not None else g).adj,
                           device=dev)
        if engine == "serial":
            d, p = dijkstra_serial(adj, int(source))
            return SsspResult(d.cpu().numpy(), p.cpu().numpy(), None, engine)
        if engine == "multisource":
            # the plain batched sweep, as JAX's facade passes no sweep_fn
            srcs = np.atleast_1d(np.asarray(source, np.int64))
            D, s = sssp_multisource(adj, torch.tensor(srcs, device=dev),
                                    max_sweeps=max_sweeps)
            return SsspResult(D.cpu().numpy(), None, s, engine,
                              sources=srcs.astype(np.int32))
        sweep_fn = None
        if engine == "bellman_kernel":
            from repro_torch.kernels.sssp_relax.ops import make_sweep_fn

            sweep_fn = make_sweep_fn()
        d, p, s = sssp_bellman(adj, int(source), sweep_fn=sweep_fn,
                               max_sweeps=max_sweeps)
        return SsspResult(d.cpu().numpy(), p.cpu().numpy(), s, engine)

    if cg is None:
        cg = g.to_csr()

    if engine in DELTA_ENGINES:
        # None and "auto" both resolve per graph: the engine needs a width.
        dval = auto_delta(cg) if delta in (None, "auto") else delta
        ops = delta_operands(cg, dval, device=dev)
        pull_fn = None
        if engine == "delta_stepping_kernel":
            from repro_torch.kernels.bucket_relax.ops import make_bucket_pull_fn

            pull_fn = make_bucket_pull_fn()
        d, p, s, e, c = sssp_delta_stepping(
            ops, int(source), dval, n=cg.n, pull_fn=pull_fn,
            max_sweeps=max_sweeps)
        return SsspResult(d.cpu().numpy(), p.cpu().numpy(), s, engine,
                          edges_relaxed=e, converged=c)

    if engine in FRONTIER_ENGINES:
        if delta == "auto":
            delta = auto_delta(cg)
        ops = frontier_operands(cg, device=dev)
        sweep_fn = None
        if engine == "frontier_kernel":
            from repro_torch.kernels.frontier_relax.ops import \
                make_frontier_sweep_fn

            sweep_fn = make_frontier_sweep_fn()
        d, p, s, e, c = sssp_frontier(
            ops, int(source), n=cg.n, sweep_fn=sweep_fn,
            max_sweeps=max_sweeps, delta=delta,
            target=None if target is None else int(target),
            target_lb=None if target_lb is None else float(target_lb))
        return SsspResult(d.cpu().numpy(),
                          None if p is None else p.cpu().numpy(), s, engine,
                          edges_relaxed=e, converged=c)

    if engine == "multisource_csr":
        srcs = np.atleast_1d(np.asarray(source, np.int64))
        D, s, c = sssp_multisource_csr(
            csr_operands(cg, device=dev), torch.tensor(srcs, device=dev),
            n=cg.n, max_sweeps=max_sweeps)
        return SsspResult(D.cpu().numpy(), None, s, engine,
                          edges_relaxed=s * cg.nnz * len(srcs),
                          sources=srcs.astype(np.int32), converged=c)

    use_kernel = engine == "bellman_csr_kernel"
    ops = csr_operands(cg, device=dev, with_in_csr=use_kernel)
    sweep_fn = None
    if use_kernel:
        from repro_torch.kernels.csr_relax.ops import make_csr_sweep_fn

        sweep_fn = make_csr_sweep_fn()
    d, p, s, c = sssp_bellman_csr(ops, int(source), n=cg.n,
                                  sweep_fn=sweep_fn, max_sweeps=max_sweeps)
    return SsspResult(d.cpu().numpy(), p.cpu().numpy(), s, engine,
                      edges_relaxed=s * cg.nnz, converged=c)


def recover_pred(result: SsspResult,
                 g: "graph_mod.Graph | csr_mod.CsrGraph | np.ndarray", *,
                 device="cuda") -> np.ndarray:
    """Rebuild predecessor rows for a result that skipped them (the
    multisource engines), with the recovery and tie-breaks of the
    single-source engines: the O(m) one over CSR arcs for a ``CsrGraph``,
    the blocked O(n²) masked argmin for a dense ``Graph`` or (n, n) array.
    Results that carry a pred are returned as-is.  Output matches
    ``result.dist``'s shape."""
    if result.pred is not None:
        return result.pred
    dev = resolve_device(device)
    D = torch.tensor(np.atleast_2d(result.dist).astype(np.float32),
                     device=dev)
    if result.sources is not None:
        srcs = np.atleast_1d(result.sources).tolist()
    else:
        # dist[source] == 0 is each row's minimum under nonnegative weights
        srcs = torch.argmin(D, dim=1).tolist()
    if isinstance(g, csr_mod.CsrGraph):
        ops = csr_operands(g, device=dev)
        rows = [predecessors_from_dist_csr(D[i], ops, int(s))
                for i, s in enumerate(srcs)]
    else:
        adj = torch.tensor(g.adj if isinstance(g, graph_mod.Graph)
                           else np.asarray(g, np.float32), device=dev)
        rows = [predecessors_from_dist(D[i], adj, int(s))
                for i, s in enumerate(srcs)]
    P = torch.stack(rows).cpu().numpy()
    return P if np.ndim(result.dist) == 2 else P[0]
