"""Synthetic serving workloads: open-loop arrival traces + latency metrics
(port of repro/serve/workload.py: the same seed draws the same trace, event
for event).

Three scenarios, matching the workload taxonomy of arXiv:1505.05033 (real
query streams are repeat-heavy) scaled down to a reproducible generator:

* ``uniform`` — full ``sssp(s)`` queries, sources uniform over the graph:
  the cache-hostile baseline where batching + dedup must carry throughput.
* ``zipf`` — ``sssp(s)`` queries with Zipf-skewed sources (rank
  probability 1/rank^a over a seeded permutation): a few hub sources
  dominate, so the distance cache and dedup absorb most of the load.
* ``p2p`` — point-to-point heavy: mostly ``dist(s, t)`` queries with
  Zipf-skewed endpoints, a sprinkle of full-row queries; exercises the
  landmark answers and the ``target=`` early-exit path.

Arrivals are **open loop**: exponential inter-arrival times at ``rate``
queries/s, independent of service progress — the server falls behind when
a tick is slower than the arrivals it spans, and latency includes that
queueing delay.  Multi-graph traces interleave queries across graphs
uniformly.

``LatencyRecorder`` folds per-answer latencies into p50/p99 and queries/s
(chip_smoke.py's serve lines print it).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

SCENARIOS = ("uniform", "zipf", "p2p")


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    arrival: float              # seconds since trace start
    graph: str
    source: int
    target: Optional[int]       # None => full sssp row
    deadline: Optional[float] = None    # absolute (trace clock); None =
                                        # the query never expires


@dataclasses.dataclass(frozen=True)
class MutationEvent:
    """One edge edit in a churn trace (see :func:`make_churn_trace`).
    ``op`` is the registry wire verb; ``w`` is None for deletes."""

    arrival: float
    graph: str
    op: str                     # "add" | "update" | "delete"
    u: int
    v: int
    w: Optional[float]


def zipf_vertices(rng: np.random.Generator, n: int, size: int,
                  a: float = 1.1,
                  perm: Optional[np.ndarray] = None) -> np.ndarray:
    """Zipf-skewed vertex ids: probability 1/rank^a over a permutation of
    [0, n), so the hot set is scattered over the id space (not just the
    low ids).  Pass ``perm`` to pin the rank->vertex assignment — two
    traces sharing a perm share their hot vertices, which is what makes a
    steady-state cache measurement meaningful."""
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** -a
    p /= p.sum()
    if perm is None:
        perm = rng.permutation(n)
    return perm[rng.choice(n, size=size, p=p)].astype(np.int64)


def make_trace(
    scenario: str,
    graphs: Sequence[tuple],        # (name, n) pairs
    *,
    num_queries: int,
    rate: float,
    seed: int = 0,
    zipf_a: float = 1.1,
    p2p_frac: float = 0.85,
    hot_seed: Optional[int] = None,
    deadline: Optional[float] = None,
) -> list:
    """Generate one open-loop trace (see module docstring).  ``rate`` is
    the mean arrival rate in queries/s; ``p2p_frac`` only applies to the
    p2p scenario (the rest of its queries are full rows).  ``hot_seed``
    pins the Zipf rank->vertex permutation independently of ``seed``, so
    differently-seeded traces target the same hot set (a steady-state
    serving shape).  ``deadline`` stamps every event with ``arrival +
    deadline`` seconds (a per-query latency SLO for
    ``submit(deadline=...)``); None leaves queries unexpirable."""
    if scenario not in SCENARIOS:
        raise ValueError(f"unknown scenario {scenario!r}; "
                         f"choose from {SCENARIOS}")
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=num_queries))
    which = rng.integers(0, len(graphs), size=num_queries)
    # two skewed draws per event covers every scenario's worst case; the
    # per-graph pools are drawn up front so the Zipf setup (perm + rank
    # probabilities, O(n)) runs once per graph, not per event.
    pools = {}
    for gi, (name, n) in enumerate(graphs):
        if scenario == "uniform":
            pools[gi] = rng.integers(0, n, size=2 * num_queries)
        else:
            perm = None
            if hot_seed is not None:
                perm = np.random.default_rng(
                    (hot_seed, gi)).permutation(n)
            pools[gi] = zipf_vertices(rng, n, 2 * num_queries, zipf_a,
                                      perm=perm)
    p2p_draw = rng.random(num_queries)
    events = []
    for i in range(num_queries):
        gi = int(which[i])
        name, n = graphs[gi]
        src = int(pools[gi][2 * i])
        tgt = None
        if scenario == "p2p" and p2p_draw[i] < p2p_frac:
            tgt = int(pools[gi][2 * i + 1])
        t = float(arrivals[i])
        events.append(TraceEvent(
            t, name, src, tgt,
            deadline=None if deadline is None else t + deadline))
    return events


class EdgeChurn:
    """Seeded edge-mutation sampler over an evolving undirected edge set —
    the single source of churn sampling, shared by :func:`make_churn_trace`
    and the dynamic bench.

    Deletes and updates pick a uniformly random live edge (a swap-pop
    list); adds rejection-sample an absent pair; the op is uniform over
    add / update / delete.  The mirror evolves with every sample, so a
    sampled sequence is valid when applied in order.

    The same seed draws the same edits as the JAX package's sampler: the
    draws come in the same order, and the live list starts in the same
    order (the incoming CSR's u < v arcs) and changes the same way.  The
    list is held as int64 keys ``u * n + v`` in a numpy array, and
    membership as the sorted base keys plus the sets of edges added and
    deleted since, so a graph of tens of millions of edges costs a few
    bytes an edge rather than a Python tuple each.
    """

    def __init__(self, cg, rng: np.random.Generator, *,
                 max_weight: float = 100.0):
        if getattr(cg, "directed", False):
            raise ValueError("churn traces assume undirected graphs "
                             "(the serve landmark path's contract)")
        self.n = int(cg.n)
        self.rng = rng
        self.max_weight = max_weight
        u = np.asarray(cg.indices, np.int64)
        v = cg.dst_ids().astype(np.int64)
        keep = u < v
        self._live = u[keep] * self.n + v[keep]
        self._count = int(self._live.shape[0])
        self._base = np.sort(self._live)
        self._added: set = set()
        self._deleted: set = set()

    def __len__(self) -> int:
        """Live edges."""
        return self._count

    def _has(self, key: int) -> bool:
        if key in self._added:
            return True
        if key in self._deleted:
            return False
        i = int(np.searchsorted(self._base, key))
        return i < self._base.shape[0] and int(self._base[i]) == key

    def _weight(self) -> float:
        return float(np.float32(self.rng.uniform(0.5, self.max_weight)))

    def sample(self) -> tuple:
        """One ``(op, u, v, w)`` edit (w is None for deletes)."""
        n = self.n
        op = ("add", "update", "delete")[int(self.rng.integers(3))]
        if op == "add" or not self._count:
            while True:
                a = int(self.rng.integers(n))
                b = int(self.rng.integers(n))
                key = min(a, b) * n + max(a, b)
                if a != b and not self._has(key):
                    break
            if key in self._deleted:
                self._deleted.discard(key)
            else:
                self._added.add(key)
            if self._count == self._live.shape[0]:
                self._live = np.concatenate(
                    [self._live, np.empty(max(self._count, 16), np.int64)])
            self._live[self._count] = key
            self._count += 1
            return ("add", key // n, key % n, self._weight())
        j = int(self.rng.integers(self._count))
        key = int(self._live[j])
        if op == "delete":
            self._count -= 1
            self._live[j] = self._live[self._count]
            if key in self._added:
                self._added.discard(key)
            else:
                self._deleted.add(key)
            return ("delete", key // n, key % n, None)
        return ("update", key // n, key % n, self._weight())


def make_churn_trace(
    graphs: Sequence[tuple],        # (name, CsrGraph-like) pairs
    *,
    num_events: int,
    rate: float,
    mutate_frac: float = 0.15,
    p2p_frac: float = 0.3,
    seed: int = 0,
    zipf_a: float = 1.1,
    hot_seed: Optional[int] = None,
    max_weight: float = 100.0,
) -> list:
    """Open-loop **churn** trace: a mixed stream of mutations and queries
    over slowly-changing graphs — the dynamic-serving shape of
    arXiv:1505.05033's repeat-heavy workloads.

    Each event is a mutation with probability ``mutate_frac``, sampled by
    a per-graph :class:`EdgeChurn` (deletes/updates pick a live edge,
    adds an absent pair — updates may raise or lower the weight, so both
    repair directions occur), else a Zipf-sourced query (a point-to-point
    pair with probability ``p2p_frac``).  The sampler's evolving edge-set
    mirror keeps the trace self-consistent: replayed in arrival order
    against a :class:`~repro_torch.dynamic.DynamicGraph` every edit is valid by
    construction.  ``graphs`` carries the actual containers (unlike
    :func:`make_trace`'s (name, n) pairs) because the generator must see
    the edge sets.  ``hot_seed`` pins the query hot set as in
    ``make_trace``.
    """
    if not 0 <= mutate_frac <= 1:
        raise ValueError(f"mutate_frac must be in [0, 1], got {mutate_frac}")
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=num_events))
    which = rng.integers(0, len(graphs), size=num_events)
    churn, pools = {}, {}
    for gi, (name, cg) in enumerate(graphs):
        churn[gi] = EdgeChurn(cg, rng, max_weight=max_weight)
        perm = None
        if hot_seed is not None:
            perm = np.random.default_rng((hot_seed, gi)).permutation(cg.n)
        pools[gi] = zipf_vertices(rng, cg.n, 2 * num_events, zipf_a,
                                  perm=perm)
    events = []
    for i in range(num_events):
        gi = int(which[i])
        name = graphs[gi][0]
        t = float(arrivals[i])
        if rng.random() < mutate_frac:
            op, u, v, w = churn[gi].sample()
            events.append(MutationEvent(t, name, op, u, v, w))
        else:
            src = int(pools[gi][2 * i])
            tgt = None
            if rng.random() < p2p_frac:
                tgt = int(pools[gi][2 * i + 1])
            events.append(TraceEvent(t, name, src, tgt))
    return events


class LatencyRecorder:
    """Accumulates per-answer latencies and renders the serving summary.

    End-to-end latency (completion - arrival) is split into its two
    components when the scheduler stamps ``Answer.service_start`` (the
    tick clock at which the answering tick began):

    * **queue wait** = service_start - arrival — time spent waiting for
      a tick to pick the query up (batching + backlog delay), and
    * **service time** = completion - service_start — time inside the
      answering tick (staging + solve + cache work).

    The split is the attribution the paper's "synchronization overhead"
    claim needs: a fat queue_p99 with thin service_p99 is a scheduling/
    arrival-rate problem, the reverse is an engine problem.  Answers
    without a stamp (service_start None) count only toward end-to-end.
    """

    def __init__(self):
        self.latencies: list[float] = []
        self.queue_waits: list[float] = []
        self.service_times: list[float] = []
        self.first_arrival: Optional[float] = None
        self.last_done: float = 0.0

    def observe(self, answer, now: float) -> None:
        """Record one Answer completed at wall-clock offset ``now``
        (latency = completion - arrival, i.e. queueing + service)."""
        self.latencies.append(now - answer.query.arrival)
        start = getattr(answer, "service_start", None)
        if start is not None:
            self.queue_waits.append(max(0.0, start - answer.query.arrival))
            self.service_times.append(max(0.0, now - start))
        a = answer.query.arrival
        if self.first_arrival is None or a < self.first_arrival:
            self.first_arrival = a
        self.last_done = max(self.last_done, now)

    @staticmethod
    def _pcts(values: list, prefix: str) -> dict:
        xs = np.asarray(values, np.float64)
        if xs.size == 0:
            return {}
        return {
            f"{prefix}_p50_ms": round(float(np.percentile(xs, 50)) * 1e3, 3),
            f"{prefix}_p99_ms": round(float(np.percentile(xs, 99)) * 1e3, 3),
        }

    def summary(self) -> dict:
        lat = np.asarray(self.latencies, np.float64)
        if lat.size == 0:
            return {"queries": 0}
        span = max(self.last_done - (self.first_arrival or 0.0), 1e-9)
        out = {
            "queries": int(lat.size),
            "p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 3),
            "p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 3),
            "max_ms": round(float(lat.max()) * 1e3, 3),
            "qps": round(lat.size / span, 2),
        }
        out.update(self._pcts(self.queue_waits, "queue"))
        out.update(self._pcts(self.service_times, "service"))
        return out
