"""Dense graph container, the paper's padding and the corpus generators
(numpy only).

A copy of the parts of ``repro/core/graph.py`` this package needs: the same
numpy RNG calls in the same order, so one seed gives byte-identical edge
lists, adjacency matrices and CSR arrays in both packages.

Unreachable entries are ``INF``; the diagonal is 0.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

INF = np.float32(np.inf)


@dataclasses.dataclass(frozen=True)
class Graph:
    """Adjacency-matrix graph, the paper's data structure of record.

    adj:      (n, n) float32, INF where no edge, 0 diagonal.
    n:        vertex count.
    directed: the paper's ``-w`` flag.

    Treat instances as immutable: ``to_csr()`` is memoized per instance.
    """

    adj: np.ndarray
    n: int
    directed: bool = False

    @property
    def num_edges(self) -> int:
        finite = np.isfinite(self.adj) & (self.adj > 0)
        cnt = int(finite.sum())
        return cnt if self.directed else cnt // 2

    def to_csr(self):
        """The sparse container (core/csr.py), memoized per instance."""
        if "_csr" not in self.__dict__:
            from repro_torch.core import csr as _csr

            self.__dict__["_csr"] = _csr.CsrGraph.from_dense(self)
        return self.__dict__["_csr"]

    def padded(self, multiple: int) -> "Graph":
        """Pad to ``padded_size(n, multiple)`` with INF rows and columns and
        a 0 diagonal (the paper's padding, §III-B.2): padding vertices are
        unreachable and never relax anything."""
        pn = padded_size(self.n, multiple)
        if pn == self.n:
            return self
        out = np.full((pn, pn), INF, dtype=np.float32)
        out[: self.n, : self.n] = self.adj
        for i in range(self.n, pn):
            out[i, i] = 0.0
        return Graph(adj=out, n=self.n, directed=self.directed)


def padded_size(n: int, multiple: int) -> int:
    """The paper's "Calculate Padded Vertices Number" (verbatim logic)."""
    if multiple > n:
        return multiple
    rem = n % multiple
    return n if rem == 0 else n + (multiple - rem)


def from_adjacency(adj, directed: bool = False) -> Graph:
    """A :class:`Graph` from an existing (n, n) adjacency matrix (for
    example one built by another package): INF where no edge, 0 diagonal.
    The matrix is copied as float32, never aliased, and frozen."""
    adj = np.array(adj, np.float32)
    if adj.ndim != 2 or adj.shape[0] != adj.shape[1]:
        raise ValueError(f"adjacency must be square (n, n), got {adj.shape}")
    adj.setflags(write=False)
    return Graph(adj=adj, n=adj.shape[0], directed=directed)


def from_edge_list(
    n: int,
    edges: np.ndarray,
    weights: np.ndarray,
    directed: bool = False,
) -> Graph:
    """Adjacency matrix from an edge list; duplicate edges keep the minimum
    weight, out-of-range ids raise."""
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    if edges.size and (edges.min() < 0 or edges.max() >= n):
        raise IndexError(
            f"edge endpoints must be in [0, {n}); got "
            f"[{edges.min()}, {edges.max()}]"
        )
    adj = np.full((n, n), INF, dtype=np.float32)
    np.fill_diagonal(adj, 0.0)
    u, v = edges[:, 0], edges[:, 1]
    w = weights.astype(np.float32)
    np.minimum.at(adj, (u, v), w)
    if not directed:
        np.minimum.at(adj, (v, u), w)
    return Graph(adj=adj, n=n, directed=directed)


def random_edge_list(
    n: int,
    m: int,
    *,
    seed: int = 0,
    max_weight: float = 100.0,
    connected: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Random edge list with ~m edges (the paper's test corpus shape);
    ``connected=True`` first threads a random spanning path."""
    rng = np.random.default_rng(seed)
    edges = []
    if connected and n > 1:
        perm = rng.permutation(n)
        path = np.stack([perm[:-1], perm[1:]], axis=1)
        edges.append(path)
        m = max(m - (n - 1), 0)
    if m > 0:
        u = rng.integers(0, n, size=2 * m + 16)
        v = rng.integers(0, n, size=2 * m + 16)
        keep = u != v
        extra = np.stack([u[keep], v[keep]], axis=1)[:m]
        edges.append(extra)
    e = np.concatenate(edges, axis=0) if edges else np.zeros((0, 2), np.int64)
    w = rng.uniform(1.0, max_weight, size=len(e))
    return e, w


def road_like_edge_list(
    n: int,
    *,
    seed: int = 0,
    max_weight: float = 100.0,
) -> tuple[int, np.ndarray, np.ndarray]:
    """A ``side × side`` 4-neighbour grid (side = isqrt(n)) with
    uniform(1, max_weight) weights: the long-diameter road-network
    stand-in.  Returns ``(n_actual, edges, weights)`` with n rounded down
    to side²."""
    side = math.isqrt(n)
    rng = np.random.default_rng(seed)
    idx = np.arange(side * side).reshape(side, side)
    u = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    v = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    e = np.stack([u, v], axis=1)
    w = rng.uniform(1.0, max_weight, size=len(e))
    return side * side, e, w


def skewed_hub_edge_list(
    n: int,
    *,
    seed: int = 0,
    hubs: int = 16,
    spokes: int = 512,
    max_weight: float = 100.0,
    heavy_lo: float = 150.0,
    heavy_hi: float = 1500.0,
) -> tuple[np.ndarray, np.ndarray]:
    """A connected light base (spanning path + 2n random edges, weights
    uniform(1, max_weight)) plus ``hubs`` vertices that each fan out
    ``spokes`` heavy edges (weights uniform(heavy_lo, heavy_hi)): the
    heavy-tailed Δ-stepping corpus."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    pe = np.stack([perm[:-1], perm[1:]], axis=1)
    m_base = 2 * n
    bu = rng.integers(0, n, size=m_base + 32)
    bv = rng.integers(0, n, size=m_base + 32)
    keep = bu != bv
    be = np.stack([bu[keep], bv[keep]], axis=1)[:m_base]
    e = np.concatenate([pe, be])
    w = rng.uniform(1.0, max_weight, size=len(e))
    hub_ids = rng.choice(n, size=min(hubs, n), replace=False)
    hu = np.repeat(hub_ids, spokes)
    hv = rng.integers(0, n, size=len(hub_ids) * spokes)
    keep = hu != hv
    he = np.stack([hu[keep], hv[keep]], axis=1)
    hw = rng.uniform(heavy_lo, heavy_hi, size=len(he))
    return np.concatenate([e, he]), np.concatenate([w, hw])


def random_graph(
    n: int,
    m: int,
    *,
    seed: int = 0,
    directed: bool = False,
    max_weight: float = 100.0,
    connected: bool = True,
) -> Graph:
    """Random weighted dense-adjacency graph with ~m edges."""
    e, w = random_edge_list(
        n, m, seed=seed, max_weight=max_weight, connected=connected
    )
    return from_edge_list(n, e, w, directed=directed)


def dense_graph(n: int, *, seed: int = 0) -> Graph:
    """Paper Table I: complete-ish graph, m = n(n-1)/2."""
    return random_graph(n, n * (n - 1) // 2, seed=seed)


def sparse_graph(n: int, *, seed: int = 0) -> Graph:
    """Paper Table II: m = 3n (the paper's 1:3 node:edge ratio)."""
    return random_graph(n, 3 * n, seed=seed)


# The paper's evaluation corpus (Tables I and II) as (n, m).
PAPER_DENSE = [(10, 45), (100, 4950), (1000, 499500), (2000, 1899500)]
PAPER_SPARSE = [
    (10, 30), (100, 300), (1000, 3000), (2000, 6000),
    (10000, 30000), (20000, 60000), (40000, 120000),
]


def paper_graph(n: int, m: int, *, seed: int = 0) -> Graph:
    return random_graph(n, m, seed=seed)
