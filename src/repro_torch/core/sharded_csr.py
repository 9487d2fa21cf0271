"""Vertex-partitioned sparse SSSP over per-owner CSR blocks (port of
repro/core/sharded_csr.py) on ``torch.distributed``: the paper's Algorithm 2
partitioning, re-based from dense O(n²/P) column slabs onto O(m/P) CSR row
blocks.

Each rank of a :class:`~repro_torch.core._dist.ShardGroup` owns ``loc_n =
n_pad / P`` vertices and stages only the arcs *targeting* its block
(``CsrGraph.partitioned``, :func:`partition_operands`), so a rank's graph
memory is about m/P.  Every engine runs on every rank with the same
arguments and returns the same replicated ``dist`` (and ``pred``, counters)
on each.

* :func:`sssp_bellman_csr_sharded` — each sweep every owner pulls its block
  over its incoming arcs and ONE tiled all-gather reassembles the distance
  vector; the stop test is computed alike on every rank from the gathered
  vector.  On CUDA tensors the pull is the ``ell_relax`` kernel with a row
  base (the block's rows read the gathered labels).
* :func:`sssp_frontier_sharded` — each sweep every owner ships its improved
  owned vertices as ``(global id, label)`` pairs: one all-reduce MAX of the
  frontier sizes, then one all-gather of the pairs padded to the largest
  frontier with the sentinel id ``n_pad``, which the empty trailing row of
  the owner's out-CSR absorbs.  The payload is O(max_p |frontier_p|), not
  O(n).  Each owner pushes the received frontier into its block through its
  out-CSR; on CUDA tensors the push is the ``frontier_relax`` kernel with
  explicit labels.  ``edges_relaxed`` is the SUM over owners of the windowed
  arcs, equal to the single-device ``frontier`` counter (each arc has one
  owner).
* :func:`sssp_multisource_csr_sharded` — the batched form of the frontier
  engine: the union frontier over S sources, each pair carrying its S
  labels, pushed once for all sources (core/frontier.relax_edge_slots_multi,
  plain torch ops as JAX's).  ``edges_relaxed`` counts each windowed arc
  once a sweep however many sources share it.

Distances are bitwise equal to every other engine's: the fixpoint is a min
over the same f32 path sums, in any order.  ``pred`` is recovered at the
fixpoint by each owner from its own incoming arcs (the lowest attaining u,
as ``predecessors_from_dist_csr``) and gathered.  Counters are Python ints.
"""
from __future__ import annotations

import torch

from repro_torch.core.frontier import relax_edge_slots_multi
from repro_torch.kernels.csr_relax.kernel import ell_relax
from repro_torch.kernels.frontier_relax.kernel import frontier_relax


def partition_operands(parts, rank: int, *, device) -> dict:
    """Stage owner ``rank``'s block of a ``CsrPartition`` on ``device`` (that
    block only): the incoming arcs ``in_src`` / ``in_dst`` (int32, local
    rows) / ``in_w``, the int32 local incoming CSR offsets ``in_indptr``
    (loc_n + 1,) the pull kernel reads, and the out-CSR ``out_indptr``
    (n_pad + 2,) / ``out_dst`` / ``out_w``.  ``in_indptr`` is counted on
    the device from the ascending segment ids (the padding arcs fall in
    the last row), not kept on the partition, so its ``nbytes`` stays
    JAX's."""
    def put(a):
        return torch.tensor(a, device=device)

    in_dst = put(parts.in_dst_loc[rank])
    rows = torch.bincount(in_dst, minlength=parts.loc_n)
    in_indptr = torch.cat([rows.new_zeros(1), torch.cumsum(rows, 0)])
    return {
        "in_src": put(parts.in_src[rank]),
        "in_dst": in_dst,
        "in_w": put(parts.in_w[rank]),
        "in_indptr": in_indptr.to(torch.int32),
        "out_indptr": put(parts.out_indptr[rank]),
        "out_dst": put(parts.out_dst_loc[rank]),
        "out_w": put(parts.out_w[rank]),
    }


def _setup(parts, group, ops):
    if parts.nprocs != group.size:
        raise ValueError(f"a partition for {parts.nprocs} owners on a group "
                         f"of {group.size}")
    if ops is None:
        ops = partition_operands(parts, group.rank, device=group.device)
    return ops, group.rank * parts.loc_n


def _cap(parts, max_sweeps):
    return parts.n_pad if max_sweeps is None else max_sweeps


def _local_pred(dist, ops, v_base: int, loc_n: int, n_pad: int,
                source: int) -> torch.Tensor:
    """The owner's block of pred[] at the fixpoint from its incoming arcs:
    the lowest u whose arc attains the row's best candidate, -1 for
    unreached rows and the source (``predecessors_from_dist_csr``'s rule;
    a padding arc is INF and attains only rows whose best is INF, which
    are unreached)."""
    dev = dist.device
    src, dst = ops["in_src"].long(), ops["in_dst"].long()
    via = dist[src] + ops["in_w"]
    best = torch.full((loc_n,), torch.inf, device=dev).scatter_reduce(
        0, dst, via, "amin")
    u_cand = torch.where(via <= best[dst], src, n_pad)
    u_best = torch.full((loc_n,), n_pad, dtype=torch.int64,
                        device=dev).scatter_reduce(0, dst, u_cand, "amin")
    owned = v_base + torch.arange(loc_n, device=dev)
    reached = torch.isfinite(dist[v_base:v_base + loc_n]) & (u_best < n_pad)
    return torch.where(reached & (owned != source), u_best,
                       -1).to(torch.int32)


def sssp_bellman_csr_sharded(parts, source: int, group, *,
                             max_sweeps: int | None = None,
                             ops: dict | None = None):
    """Sharded fixpoint SSSP on a ``CsrPartition`` over ``group``.  Returns
    ``(dist (n_pad,), pred (n_pad,), sweeps, edges_relaxed, converged)``,
    replicated; valid entries ``[:n]``.  ``edges_relaxed`` is the padded
    blocks' arcs every sweep (``sweeps * P * nnz_max``), as JAX's facade
    counts it; ``converged`` is False iff ``max_sweeps`` stopped the loop
    while the gathered vector still changed.  ``ops=`` takes an already
    staged :func:`partition_operands` block."""
    ops, v_base = _setup(parts, group, ops)
    cap = _cap(parts, max_sweeps)
    dist = torch.full((parts.n_pad,), torch.inf, device=group.device)
    dist[source] = 0.0
    changed, sweeps = True, 0         # the start differs from "no previous"
    while sweeps < cap and changed:
        loc_new = ell_relax(dist, ops["in_indptr"], ops["in_src"],
                            ops["in_w"], row_base=v_base)      # O(m/P)
        new = group.all_gather(loc_new)
        changed = bool((new != dist).any())
        dist, sweeps = new, sweeps + 1
    pred = _local_pred(dist, ops, v_base, parts.loc_n, parts.n_pad, source)
    return (dist, group.all_gather(pred), sweeps,
            sweeps * parts.nprocs * parts.nnz_max, not changed)


def _exchange(group, ids, labels, width: int, n_pad: int):
    """All-gather every owner's frontier pairs: ``ids`` (k,) global ids and
    ``labels`` (S, k) f32, padded to ``width`` with the sentinel id
    ``n_pad`` and INF, travel as one int32 payload (labels as bit
    patterns).  Returns the (P * width,) int64 ids and (S, P * width)
    labels."""
    S, k = labels.shape
    payload = torch.empty((1 + S, width), dtype=torch.int32,
                          device=ids.device)
    payload[0] = n_pad
    payload[0, :k] = ids
    lab = payload[1:].view(torch.float32)
    lab.fill_(torch.inf)
    lab[:, :k] = labels
    allp = group.all_gather(payload.flatten()).view(group.size, 1 + S, width)
    all_ids = allp[:, 0].reshape(-1).long()
    all_lab = allp[:, 1:].transpose(0, 1).contiguous().view(
        torch.float32).reshape(S, -1)
    return all_ids, all_lab


def sssp_frontier_sharded(parts, source: int, group, *,
                          max_sweeps: int | None = None,
                          ops: dict | None = None):
    """Sharded frontier-compacted SSSP on a ``CsrPartition`` over
    ``group``.  Returns ``(dist (n_pad,), pred (n_pad,), sweeps,
    edges_relaxed, converged)``, replicated; valid entries ``[:n]``.
    ``converged`` is False iff ``max_sweeps`` stopped the loop while some
    owner still had an improving frontier.  The loop runs to the fixpoint
    (a ``target=`` query through the facade gets the full row, as JAX's).
    Each sweep costs two collectives: the all-reduce MAX of the frontier
    sizes and the all-gather of the pairs."""
    ops, v_base = _setup(parts, group, ops)
    cap = _cap(parts, max_sweeps)
    loc_n, n_pad, dev = parts.loc_n, parts.n_pad, group.device
    owned = v_base + torch.arange(loc_n, device=dev)
    dist = torch.where(owned == source, 0.0, torch.inf)
    fmask = owned == source
    width = 1                         # the largest frontier: the source
    ip = ops["out_indptr"]
    edges = torch.zeros((), dtype=torch.int64, device=dev)
    sweeps = 0
    while sweeps < cap and width > 0:
        fidx = torch.nonzero(fmask).flatten()
        all_ids, all_lab = _exchange(group, fidx + v_base,
                                     dist[fidx][None], width, n_pad)
        edges += (ip[all_ids + 1] - ip[all_ids]).sum()
        fell = torch.zeros(loc_n, dtype=torch.bool, device=dev)
        frontier_relax(dist, all_ids, ip, ops["out_dst"], ops["out_w"], fell,
                       flabels=all_lab[0])
        width = int(group.all_reduce(fell.sum().view(1), "max"))
        fmask, sweeps = fell, sweeps + 1
    edges = int(group.all_reduce(edges.view(1), "sum"))
    dist = group.all_gather(dist)
    pred = _local_pred(dist, ops, v_base, loc_n, n_pad, source)
    return dist, group.all_gather(pred), sweeps, edges, width == 0


def sssp_multisource_csr_sharded(parts, sources, group, *,
                                 max_sweeps: int | None = None,
                                 ops: dict | None = None):
    """Batched vertex-partitioned SSSP from S sources on a
    ``CsrPartition`` over ``group``.  Returns ``(D (S, n_pad), sweeps,
    edges_relaxed, converged)``, replicated; valid columns ``[:n]``.  Each
    sweep exchanges the union frontier's ids with all S labels and pushes
    every received window once for all sources; a vertex improved for one
    source re-pushes its other labels too, inert under min.  Rows are
    bitwise equal to S independent solves; ``converged`` is the joint flag.
    pred is not recovered (``api.recover_pred`` rebuilds rows)."""
    ops, v_base = _setup(parts, group, ops)
    cap = _cap(parts, max_sweeps)
    loc_n, n_pad, dev = parts.loc_n, parts.n_pad, group.device
    srcs = torch.as_tensor(sources, dtype=torch.int64, device=dev).view(-1)
    S = srcs.shape[0]
    owned = v_base + torch.arange(loc_n, device=dev)
    is_src = owned[None, :] == srcs[:, None]
    D = torch.where(is_src, 0.0, torch.inf)
    fmask = is_src.any(dim=0)
    width = int(group.all_reduce(fmask.sum().view(1), "max"))
    ip = ops["out_indptr"]
    edges, sweeps = 0, 0
    while sweeps < cap and width > 0:
        fidx = torch.nonzero(fmask).flatten()
        all_ids, all_D = _exchange(group, fidx + v_base, D[:, fidx], width,
                                   n_pad)
        starts = ip[all_ids].long()
        degs = ip[all_ids + 1].long() - starts
        csum = torch.cumsum(degs, 0)
        E = int(csum[-1])
        ND = relax_edge_slots_multi(D, all_D, starts, csum - degs, E,
                                    ops["out_dst"], ops["out_w"])
        improved = (ND < D).any(dim=0)
        D, fmask, edges = ND, improved, edges + E
        width = int(group.all_reduce(improved.sum().view(1), "max"))
        sweeps += 1
    edges = int(group.all_reduce(torch.tensor([edges], device=dev), "sum"))
    return group.all_gather(D, dim=1), sweeps, edges, width == 0
