"""True Δ-stepping SSSP over a light/heavy edge split (port of
repro/core/delta_stepping.py; Meyer & Sanders, in the GPU formulation of
Kranjčević et al., arXiv:1604.02113).

* **Light arcs** (weight <= Δ) are iterated to a per-bucket fixpoint by a
  **pull**: one pass computes every vertex's best incoming light candidate
  from the light incoming CSR (``CsrGraph.light_in_csr``) — a gather and a
  segment-min, no compaction.  (The JAX engine pulls over the
  padded light in-ELL, the TPU kernel's layout; the candidates are the
  same.)
* **Heavy arcs** (weight > Δ) cannot land inside the bucket they leave, so
  each settled bucket's heavy out-windows are pushed once, through the
  frontier engine's compaction (:func:`repro_torch.core.frontier.relax_active`).

The state is ``(dist, hpend)``: ``hpend`` marks finite vertices whose heavy
out-arcs have not been relaxed at their current label.  Each outer phase
windows the bucket ``[lo, hi)`` around the minimum pending label, pulls to a
fixpoint (stopping when no improvement lands below ``hi``), then pushes the
settled bucket's heavy arcs.  ``Δ``, ``lo`` and ``hi`` are float32 tensors
on the device, computed as the JAX engine computes them, so the phase
schedule — not only the distances — matches it; ``hi`` is forced strictly
above the minimum pending label (``nextafter``) so every phase progresses.

Distances are bitwise equal to every other engine for any positive Δ.
``sweeps`` counts outer phases; ``edges_relaxed`` charges every light pass
at the full light arc count plus the compacted heavy out-degree per phase,
in int64.  Each pull pass reads one flag back to the host.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.bellman_csr import (_start, csr_operands,
                                          predecessors_from_dist_csr)
from repro_torch.core.csr import _masked_row_counts
from repro_torch.core.frontier import (make_flat_sweep_fn, relax_active,
                                       sweep_cap)
from repro_torch.kernels.csr_relax.ref import row_ids, segment_relax_ref

#: candidate quantiles of the weight distribution tried by auto_delta,
#: below the w_max and all-light rungs.
AUTO_DELTA_QUANTILES = (0.5, 0.75, 0.9)


def delta_profile(cg) -> dict:
    """Deterministic Δ selection profile for a CsrGraph, memoized on it.

    Returns ``{"delta", "light_max_deg", "k_cap", "routable"}``: the chosen
    Δ — the largest rung of (weight quantiles p50/p75/p90, w_max, an
    all-light sentinel) whose max light in-degree stays within
    ``k_cap = max(8, 4 · mean degree)`` — the light ELL width it induces,
    the cap, and whether any rung met the cap.
    """
    def build():
        n, w = cg.n, np.asarray(cg.weights)
        if cg.nnz == 0:
            return {"delta": 1.0, "light_max_deg": 0, "k_cap": 8.0,
                    "routable": True}
        mean_deg = cg.nnz / max(n, 1)
        k_cap = max(8.0, 4.0 * mean_deg)
        wmax = float(w.max())
        # all-light sentinel: >= any finite distance, so every arc is light
        all_light = float(np.float32(max(n, 2)) * np.float32(max(wmax, 1.0)))
        cands = [float(np.quantile(w, q)) for q in AUTO_DELTA_QUANTILES]
        cands += [wmax, all_light]
        best, best_ldeg, ok = cands[0], None, False
        for c in cands:
            mask = w <= np.float32(c)
            ldeg = int(_masked_row_counts(mask, cg.indptr, n).max())
            if best_ldeg is None:
                best_ldeg = ldeg               # narrowest rung = fallback
            if ldeg <= k_cap and c >= best:
                best, best_ldeg, ok = c, ldeg, True
        return {"delta": float(best), "light_max_deg": int(best_ldeg),
                "k_cap": float(k_cap), "routable": bool(ok)}
    return cg._memo("_delta_profile", build)


def auto_delta(cg) -> float:
    """The Δ that ``delta="auto"`` resolves to for this graph."""
    return delta_profile(cg)["delta"]


def delta_operands(cg, delta: float, *, device) -> dict:
    """Stage a CsrGraph for the Δ-stepping engines: the incoming arrays of
    :func:`csr_operands` plus

    * ``light_indptr`` (n+1,) / ``light_src`` (m_light,) int32 and
      ``light_w`` (m_light,) float32: the light incoming CSR (the kernel
      pull's operand);
    * ``light_dst`` (m_light,) int64: each light arc's row, expanded from
      ``light_indptr`` on the device once (the plain pull's scatter index);
    * ``out_indptr`` / ``out_dst`` / ``out_w``: the heavy outgoing CSR, under
      the frontier engine's keys (indptr with the trailing sentinel entry)
      so ``relax_active`` consumes it unchanged;
    * ``m_light``: the light arc count (the edge charge of a pull pass).
    """
    ops = csr_operands(cg, device=device)
    lip, l_src, l_w = cg.light_in_csr(delta)
    ops["light_indptr"] = torch.tensor(lip, device=device).int()
    ops["light_src"] = torch.tensor(l_src, device=device)
    ops["light_w"] = torch.tensor(l_w, device=device)
    ops["light_dst"] = row_ids(ops["light_indptr"], int(l_src.shape[0]))
    hip, h_dst, h_w = cg.heavy_out_csr(delta)
    hip_s = np.concatenate([hip, hip[-1:]]).astype(np.int32)
    ops["out_indptr"] = torch.tensor(hip_s, device=device)
    ops["out_dst"] = torch.tensor(h_dst, device=device)
    ops["out_w"] = torch.tensor(h_w, device=device)
    ops["m_light"] = cg.nnz - int(h_dst.shape[0])
    return ops


def make_light_pull_fn() -> Callable:
    """The default light-phase pull: a scatter-min over the light arcs
    (the plain version of the ``bucket_relax`` kernel).

    The pull contract (shared with kernels/bucket_relax/ops.py):
    ``pull(dist, ops, hi) -> (new, go)`` with ``new[v] = min(dist[v],
    min_e dist[light_src[e]] + light_w[e])`` over v's light in-arcs e and
    ``go = any((new < dist) & (new < hi))`` as a 0-dim bool tensor.
    """
    def pull(dist, ops, hi):
        new = segment_relax_ref(dist, ops["light_src"], ops["light_dst"],
                                ops["light_w"])
        return new, ((new < dist) & (new < hi)).any()
    return pull


def delta_fixpoint(ops: dict, dist0, hpend0, delta, *, n: int,
                   pull: Callable, sweep: Callable, cap_outer: int):
    """The Δ-stepping phase loop on an arbitrary initial state (``delta`` a
    float32 0-dim tensor on the device).  Returns ``(dist, phases,
    edges_relaxed, converged)``."""
    m_light = ops["m_light"]
    inf = torch.tensor(torch.inf, dtype=torch.float32, device=dist0.device)
    dist, hpend = dist0, hpend0
    phases = 0
    edges = torch.zeros((), dtype=torch.int64, device=dist0.device)
    while phases < cap_outer and bool(hpend.any()):
        dmin = torch.where(hpend, dist, inf).amin()
        # fp-robust bucket window: lo never above dmin, hi strictly above
        # it, so the phase settles at least the minimum pending vertex.
        lo = torch.minimum(torch.floor(dmin / delta) * delta, dmin)
        hi = torch.maximum(lo + delta, torch.nextafter(dmin, inf))
        # each improving pass lowers a label along a shortest path (<= n-1
        # hops), plus one closing pass that improves nothing below hi.
        go, j = True, 0
        while go and j <= n:
            new, go_t = pull(dist, ops, hi)
            hpend = hpend | (new < dist)     # improved labels owe a push
            dist, j = new, j + 1
            go = bool(go_t)
        # the bucket below hi is settled: push its heavy out-arcs once.
        settled = hpend & (dist < hi)
        # in place on dist and hpend, which the pull loop above made anew
        E = relax_active(ops, dist, settled, hpend, sweep=sweep)
        edges = edges + E + j * m_light
        phases += 1
    return dist, phases, int(edges), not bool(hpend.any())


def sssp_delta_stepping(
    ops: dict,
    source: int,
    delta: float,
    *,
    n: int,
    pull_fn: Optional[Callable] = None,
    max_sweeps: int | None = None,
):
    """Δ-stepping fixpoint SSSP on :func:`delta_operands` (built with the
    same Δ).  Returns ``(dist, pred, phases, edges_relaxed, converged)``.

    The phase cap is :func:`repro_torch.core.frontier.sweep_cap` fed with
    the distance bound (n-1)·w_max, in float32 as the JAX engine takes it.
    """
    pull = pull_fn or make_light_pull_fn()
    dev = ops["w"].device
    f32 = torch.float32
    delta = torch.tensor(delta, dtype=f32, device=dev)
    w = ops["w"]
    wmax = (w.amax().clamp_min(0.0) if w.numel()
            else torch.zeros((), dtype=f32, device=dev))
    max_dist_ub = torch.tensor(float(max(n - 1, 1)), dtype=f32,
                               device=dev) * wmax
    cap = sweep_cap(n, delta, max_sweeps, max_dist=max_dist_ub)
    dist0 = _start(n, source, dev)
    dist, phases, edges, converged = delta_fixpoint(
        ops, dist0, dist0 < torch.inf, delta, n=n, pull=pull,
        sweep=make_flat_sweep_fn(), cap_outer=cap,
    )
    pred = predecessors_from_dist_csr(dist, ops, source)
    return dist, pred, phases, edges, converged
