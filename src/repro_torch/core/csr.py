"""Sparse CSR graph container (numpy only).

A copy of the parts of ``repro/core/csr.py`` this package needs, kept
byte-for-byte equivalent so the same seed gives the same arrays in both
packages:

* **CSR over incoming edges** (CSR of the adjacency transpose): row v holds
  v's incoming arcs, the pull formulation every whole-graph sweep wants.
  Undirected graphs store both orientations.
* **Padded ELL** views (``ell``, ``out_ell``, ``light_in_ell``): rows padded
  to a common width K (a multiple of 8) with (index 0, weight INF) slots that
  can never win a min — the fixed-width rows the JAX package's TPU kernels
  consume.  The CUDA kernels of this package read the CSR forms instead
  (the incoming CSR itself, ``light_in_csr``, ``out_csr``).

Device staging lives in the engine modules (core/bellman_csr.py and
friends); staging copies (``torch.tensor`` / ``.to``), never aliases: every
array here is read-only, and so is every memoized view.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import (INF, Graph, random_edge_list,
                                    road_like_edge_list, skewed_hub_edge_list)


def _freeze(*arrays: np.ndarray):
    """Mark arrays read-only: memoized views are shared across callers."""
    for a in arrays:
        a.flags.writeable = False
    return arrays if len(arrays) > 1 else arrays[0]


def _build_ell(
    indptr: np.ndarray, ids: np.ndarray, weights: np.ndarray,
    n: int, width_multiple: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Pack one CSR orientation into padded ELL: (n, K) int32 ids and
    (n, K) float32 weights, K = max row degree rounded up to
    ``width_multiple`` (one lane group even for edgeless graphs).  Padding
    slots are (0, INF): an INF candidate can never win a min."""
    deg = np.diff(indptr)
    max_deg = int(deg.max()) if deg.size else 0
    K = -(-max(max_deg, 1) // width_multiple) * width_multiple
    idx = np.zeros((n, K), np.int32)
    w = np.full((n, K), INF, np.float32)
    rows = np.repeat(np.arange(n), deg)
    pos = np.arange(int(indptr[-1])) - np.repeat(indptr[:-1], deg)
    idx[rows, pos] = ids
    w[rows, pos] = weights
    return _freeze(idx, w)


def _masked_row_counts(mask: np.ndarray, indptr: np.ndarray,
                       n: int) -> np.ndarray:
    """Per-row count of True arcs under a per-arc ``mask``, for rows
    delimited by ``indptr``.  ``np.add.reduceat`` mishandles empty rows, so
    they are clipped and zeroed explicitly."""
    deg = np.diff(indptr)
    if mask.size == 0:
        return np.zeros(n, np.int64)
    starts = np.minimum(np.asarray(indptr[:-1], np.int64), mask.size - 1)
    return np.where(deg > 0, np.add.reduceat(mask, starts), 0).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class CsrGraph:
    """Incoming-edge CSR graph.

    indptr:  (n+1,) int64 — row v's incoming arcs live in
             ``[indptr[v], indptr[v+1])``; rows sorted by (dst, src).
    indices: (nnz,) int32 — source vertex u of each stored arc.
    weights: (nnz,) float32.
    n:        vertex count.
    directed: undirected graphs store both orientations, so
              ``num_edges == nnz // 2`` there.
    """

    indptr: np.ndarray
    indices: np.ndarray
    weights: np.ndarray
    n: int
    directed: bool = False

    def __post_init__(self):
        # Immutability contract: every derived view is memoized per instance
        # and shared by every later caller, so an in-place write would
        # corrupt views already built from it.  numpy raises on any write.
        for arr in (self.indptr, self.indices, self.weights):
            arr.flags.writeable = False

    @property
    def nnz(self) -> int:
        """Stored arcs (both orientations for undirected graphs)."""
        return int(self.indices.shape[0])

    @property
    def num_edges(self) -> int:
        cnt = int((np.isfinite(self.weights) & (self.weights > 0)).sum())
        return cnt if self.directed else cnt // 2

    @property
    def nbytes(self) -> int:
        return self.indptr.nbytes + self.indices.nbytes + self.weights.nbytes

    def _memo(self, key, build):
        # writing through __dict__ sidesteps the frozen-dataclass __setattr__
        if key not in self.__dict__:
            self.__dict__[key] = build()
        return self.__dict__[key]

    def dst_ids(self) -> np.ndarray:
        """(nnz,) int32 destination id of each stored arc, ascending."""
        def build():
            deg = np.diff(self.indptr)
            return _freeze(np.repeat(np.arange(self.n, dtype=np.int32), deg))
        return self._memo("_dst_ids", build)

    def ell(self, width_multiple: int = 8) -> tuple[np.ndarray, np.ndarray]:
        """Padded incoming ELL: (n, K) int32 sources, (n, K) float32 weights,
        K = max in-degree rounded up to ``width_multiple``.  O(n · K): on a
        hub-in-degree-skewed graph it re-approaches the dense matrix.  No
        kernel path of this package reads it (the relax kernels take the
        incoming CSR itself); it is kept for parity with the JAX package."""
        def build():
            return _build_ell(self.indptr, self.indices, self.weights,
                              self.n, width_multiple)
        return self._memo(("_ell", width_multiple), build)

    def out_csr(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Outgoing-edge CSR ``(out_indptr, out_dst, out_w)``, rows sorted by
        (src, dst): the transpose the frontier push needs."""
        def build():
            src = np.asarray(self.indices, np.int64)
            dst = self.dst_ids().astype(np.int64)
            order = np.lexsort((dst, src))              # by src, then dst
            out_dst = dst[order].astype(np.int32)
            out_w = np.asarray(self.weights)[order]
            counts = np.bincount(src, minlength=self.n)
            indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
            return _freeze(indptr, out_dst, out_w)
        return self._memo("_out_csr", build)

    def out_ell(self, width_multiple: int = 8) -> tuple[np.ndarray, np.ndarray]:
        """Padded ELL of :meth:`out_csr` (K = max out-degree rounded up)."""
        def build():
            indptr, out_dst, out_w = self.out_csr()
            return _build_ell(indptr, out_dst, out_w, self.n, width_multiple)
        return self._memo(("_out_ell", width_multiple), build)

    def light_in_csr(
        self, delta: float
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Incoming CSR of the *light* arcs (weight <= Δ):
        ``(indptr, indices, weights)`` in the row order and within-row order
        of the full incoming CSR — the Δ-stepping light phase's pull
        operand.  Memoized per Δ."""
        def build():
            mask = np.asarray(self.weights) <= np.float32(delta)
            ldeg = _masked_row_counts(mask, self.indptr, self.n)
            lip = np.concatenate([[0], np.cumsum(ldeg)]).astype(np.int64)
            return _freeze(lip, self.indices[mask], self.weights[mask])
        return self._memo(("_light_in_csr", float(delta)), build)

    def light_in_ell(
        self, delta: float, width_multiple: int = 8
    ) -> tuple[np.ndarray, np.ndarray]:
        """Padded ELL of :meth:`light_in_csr`.  Memoized per (Δ, width)."""
        def build():
            return _build_ell(*self.light_in_csr(delta), self.n,
                              width_multiple)
        return self._memo(("_light_in_ell", float(delta), width_multiple),
                          build)

    def heavy_out_csr(
        self, delta: float
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Outgoing CSR of the *heavy* arcs (weight > Δ), same ordering as
        ``out_csr``: the complement of ``light_in_ell``.  Memoized per Δ."""
        def build():
            indptr, out_dst, out_w = self.out_csr()
            mask = out_w > np.float32(delta)
            hdeg = _masked_row_counts(mask, indptr, self.n)
            hip = np.concatenate([[0], np.cumsum(hdeg)]).astype(np.int64)
            return _freeze(hip, out_dst[mask], out_w[mask])
        return self._memo(("_heavy_out_csr", float(delta)), build)

    @classmethod
    def from_dense(cls, g: Graph) -> "CsrGraph":
        """Every finite off-diagonal entry of ``g.adj`` as an arc."""
        adj = np.asarray(g.adj, np.float32)
        n = adj.shape[0]
        mask = np.isfinite(adj)
        np.fill_diagonal(mask, False)
        u, v = np.nonzero(mask)
        order = np.lexsort((u, v))                       # by dst, then src
        src = u[order].astype(np.int32)
        dst = v[order]
        w = adj[u, v][order].astype(np.float32)
        counts = np.bincount(dst, minlength=n)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return cls(indptr=indptr, indices=src, weights=w, n=n,
                   directed=g.directed)

    def to_dense(self) -> Graph:
        """The O(n²) matrix (INF off-edges, 0 diagonal), memoized."""
        def build():
            adj = np.full((self.n, self.n), INF, dtype=np.float32)
            np.fill_diagonal(adj, 0.0)
            adj[self.indices, self.dst_ids()] = self.weights
            return Graph(adj=_freeze(adj), n=self.n, directed=self.directed)
        return self._memo("_dense", build)


def from_arrays(indptr, indices, weights, n: int,
                directed: bool = False) -> CsrGraph:
    """A :class:`CsrGraph` from existing incoming-CSR arrays (for example a
    graph built by another package).  The arrays are copied, never aliased,
    and checked for shape and range."""
    indptr = np.array(indptr, np.int64)
    indices = np.array(indices, np.int32)
    weights = np.array(weights, np.float32)
    nnz = indices.shape[0]
    if indptr.shape != (n + 1,) or weights.shape != (nnz,):
        raise ValueError(
            f"expected indptr ({n + 1},) and weights ({nnz},); got "
            f"{indptr.shape} and {weights.shape}")
    if indptr[0] != 0 or indptr[-1] != nnz or np.any(np.diff(indptr) < 0):
        raise ValueError("indptr must rise from 0 to nnz")
    if nnz and (indices.min() < 0 or indices.max() >= n):
        raise IndexError(f"source ids must be in [0, {n})")
    return CsrGraph(indptr=indptr, indices=indices, weights=weights, n=n,
                    directed=directed)


def csr_from_edge_list(
    n: int,
    edges: np.ndarray,
    weights: np.ndarray,
    directed: bool = False,
) -> CsrGraph:
    """Incoming-edge CSR from an edge list in O(m log m): undirected edges
    are mirrored, self-loops dropped, duplicate arcs keep the minimum."""
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    w = np.asarray(weights, np.float32).reshape(-1)
    if edges.size and (edges.min() < 0 or edges.max() >= n):
        raise IndexError(
            f"edge endpoints must be in [0, {n}); got "
            f"[{edges.min()}, {edges.max()}]"
        )
    u, v = edges[:, 0], edges[:, 1]
    if not directed:
        u, v = np.concatenate([u, v]), np.concatenate([v, u])
        w = np.concatenate([w, w])
    keep = u != v
    u, v, w = u[keep], v[keep], w[keep]
    key = v * np.int64(n) + u
    uniq, inv = np.unique(key, return_inverse=True)
    wmin = np.full(uniq.shape[0], INF, np.float32)
    np.minimum.at(wmin, inv, w)
    dst = (uniq // n).astype(np.int64)
    src = (uniq % n).astype(np.int32)
    counts = np.bincount(dst, minlength=n)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return CsrGraph(indptr=indptr, indices=src, weights=wmin, n=n,
                    directed=directed)


def random_csr_graph(
    n: int,
    m: int,
    *,
    seed: int = 0,
    directed: bool = False,
    max_weight: float = 100.0,
    connected: bool = True,
) -> CsrGraph:
    """CSR-native random graph, same RNG stream as graph.random_graph."""
    e, w = random_edge_list(
        n, m, seed=seed, max_weight=max_weight, connected=connected
    )
    return csr_from_edge_list(n, e, w, directed=directed)


def sparse_csr_graph(n: int, *, seed: int = 0) -> CsrGraph:
    """The paper's Table II corpus shape (m = 3n) in O(n) memory."""
    return random_csr_graph(n, 3 * n, seed=seed)


def road_like_csr_graph(n: int, *, seed: int = 0) -> CsrGraph:
    """Long-diameter grid corpus as a CSR; ``n`` rounds down to a perfect
    square, so read the actual count back from ``.n``."""
    nn, e, w = road_like_edge_list(n, seed=seed)
    return csr_from_edge_list(nn, e, w)


def skewed_hub_csr_graph(n: int, *, seed: int = 0) -> CsrGraph:
    """Heavy-tailed hub corpus as a CSR."""
    e, w = skewed_hub_edge_list(n, seed=seed)
    return csr_from_edge_list(n, e, w)
