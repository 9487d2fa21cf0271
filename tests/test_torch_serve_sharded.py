"""The serving seams of the sharded engines (A.11b) in the port, on gloo
ranks on the CPU: a serving group (core/_dist.open_serving_group) whose
leader is this test process and whose followers are spawned ranks, at
P in {2, 4}.

Each case mirrors the JAX test of the same shape in
tests/test_serve_sharded.py.  JAX's own sharded serving cannot be the
reference (its sharded CSR engines fail on this tree, ROADMAP queue C), so
the port's sharded answers are held bitwise against JAX's ``serial`` and
JAX's single-device ``MicroBatchScheduler`` on the same graphs and seeded
traces:

- partition staging: memoized per arity, restaged on a new one, accounted
  in ``bytes_in_use`` (host view + every rank's block, the followers'
  through ``STATS``), refused for a dynamic graph; owner-shard row keys;
- the scheduler's sharded batch and p2p branches (their spans and cost
  records too), the eviction race (the
  followers drop the evicted blocks), occupancy and bucket padding, a
  capped solve (``NotConverged``, nothing cached), and a zipf and a p2p
  trace answered as JAX's single-device scheduler answers them;
- ``engine="auto"`` with ``group=`` on 4 SPMD ranks;
- a leader-side refusal sends no command; a killed follower gives
  ``GroupBroken`` naming its rank within the group's short timeout, while
  a single-device graph goes on serving.

One serving group a P (a module-scoped fixture), closed at the end of its
cases; the killed-follower case runs last on it.
"""
import functools
import time

import numpy as np
import pytest
import torch

from repro.core import csr as JC
from repro.core.api import shortest_paths as j_sp
from repro.serve import DistanceCache as JCache
from repro.serve import GraphRegistry as JRegistry
from repro.serve import MicroBatchScheduler as JScheduler
from repro.serve import make_trace as j_make_trace
from repro_torch.core import csr as TC
from repro_torch.core._dist import open_serving_group, spawn
from repro_torch.core.api import shortest_paths
from repro_torch.dynamic import DynamicGraph
from repro_torch.serve import (DispatchPolicy, DistanceCache, GraphRegistry,
                               GroupBroken, MicroBatchScheduler,
                               QueryRejected, make_trace)

CPU = "cpu"
#: seconds a collective (and the group's start) may take: short, so a
#: broken group shows within the killed-follower case's bound
TIMEOUT = 10.0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def sg(request):
    """One serving group of P gloo ranks for the module's cases."""
    group = open_serving_group(request.param, device=CPU, timeout=TIMEOUT)
    yield group
    group.close()
    assert not torch.distributed.is_initialized()


def carry(cg):
    return TC.from_arrays(cg.indptr, cg.indices, cg.weights, cg.n,
                          cg.directed)


@functools.lru_cache(maxsize=None)
def jgraph(kind: str, n: int, seed: int):
    if kind == "sparse":
        return JC.sparse_csr_graph(n, seed=seed)
    return JC.random_csr_graph(n, 3 * n, seed=seed)


@functools.lru_cache(maxsize=None)
def serial_row(kind: str, n: int, seed: int, source: int) -> np.ndarray:
    return np.asarray(j_sp(jgraph(kind, n, seed), source,
                           engine="serial").dist)


class Stack:
    """A registry, cache and scheduler on the serving group; ``close``
    evicts every graph, so the next case finds the followers empty."""

    def __init__(self, sg, threshold, *, max_batch=8, cache_rows=64, **kw):
        self.sg = sg
        self.policy = DispatchPolicy(shard_threshold=threshold, device=CPU,
                                     group=sg)
        self.registry = GraphRegistry(device=CPU, group=sg)
        self.cache = DistanceCache(cache_rows)
        self.sched = MicroBatchScheduler(self.registry, self.cache,
                                         max_batch=max_batch,
                                         dispatch=self.policy, **kw)

    def close(self):
        for name in self.registry.names:
            self.registry.evict(name)


@pytest.fixture
def stack(sg):
    made = []

    def make(*args, **kw):
        made.append(Stack(sg, *args, **kw))
        return made[-1]

    yield make
    for s in made:
        s.close()
    if sg.broken is None:
        assert all(r["slots"] == 0 for r in sg.stats())


# ---------------------------------------------------------------------------
# registry staging + shard-aware keys
# ---------------------------------------------------------------------------

def test_row_key_carries_owner_shard(sg, stack):
    h = stack(None).registry.register("g", carry(jgraph("sparse", 100, 6)))
    P = sg.size
    assert h.row_key(3) == ("g", 3)
    for s in (3, 25, 50, 99):
        assert h.row_key(s, shards=P) == ("g", s // (100 // P), s)
    if P == 4:                                  # JAX's literal keys
        assert h.row_key(3, shards=4) == ("g", 0, 3)
        assert h.row_key(25, shards=4) == ("g", 1, 25)
        assert h.row_key(99, shards=4) == ("g", 3, 99)
        assert h.owner_shard(50, 4) == 2


def test_partition_staging_memoized_restaged_and_accounted(sg, stack):
    P = sg.size
    reg = stack(None).registry
    h = reg.register("g", carry(jgraph("sparse", 64, 7)))
    base = reg.bytes_in_use
    parts = h.partition(P)
    assert parts is h.partition(P)              # memoized per nprocs
    assert reg.bytes_in_use == base + parts.nbytes
    ops = h.partition_ops(P)
    assert ops is h.partition_ops(P)
    ranks = sg.stats()
    assert [r["slots"] for r in ranks] == [1] * P
    staged = sum(r["staged_bytes"] for r in ranks)
    assert staged > 0
    assert reg.bytes_in_use == base + parts.nbytes + staged
    # a different arity restages: the old blocks go on every rank, and
    # this group stages only its own arity
    other = 3 if P != 3 else 2
    assert h.partition(other).nprocs == other
    assert [r["slots"] for r in sg.stats()] == [0] * P
    with pytest.raises(ValueError, match="owners"):
        h.partition_ops(other)
    assert h.partition(P) is parts
    assert h.partition_ops(P) is not ops
    assert reg.bytes_in_use == base + parts.nbytes + staged


def test_partition_refuses_dynamic_graphs(stack):
    reg = stack(None).registry
    h = reg.register("d", DynamicGraph(carry(jgraph("sparse", 32, 8))))
    with pytest.raises(ValueError, match="dynamic"):
        h.partition(2)


# ---------------------------------------------------------------------------
# the scheduler's sharded branches
# ---------------------------------------------------------------------------

def test_scheduler_sharded_batch_and_p2p_bitwise(sg, stack):
    s = stack(500)
    sched, cache = s.sched, s.cache
    s.registry.register("big", carry(jgraph("sparse", 2000, 3)))
    s.registry.register("small", carry(jgraph("sparse", 100, 4)))
    for src in (5, 9, 5, 700, 1999):
        sched.submit("big", src)
    sched.submit("small", 3)
    answers = sched.drain()
    assert sched.sharded_batches == 1 and sched.sharded_sources == 4
    assert sched.engine_batches == 2            # small went single-device
    for a in answers:
        kind, n, seed = (("sparse", 2000, 3) if a.query.graph == "big"
                         else ("sparse", 100, 4))
        assert a.ok and a.via == "batch"
        assert np.array_equal(a.value, serial_row(kind, n, seed,
                                                  a.query.source))
    keys = cache.keys_for("big")
    h = s.registry.get("big")
    assert keys and all(len(k) == 3 for k in keys)
    assert all(k[1] == h.owner_shard(k[2], sg.size) for k in keys)
    assert all(len(k) == 2 for k in cache.keys_for("small"))

    # sharded p2p: the full fixpoint, bitwise, and its row is cached
    sched.submit("big", 42, 77)
    a = sched.drain()[0]
    ref = serial_row("sparse", 2000, 3, 42)
    assert a.via == "target" and np.float32(a.value) == ref[77]
    assert sched.sharded_p2p == 1 and sched.sharded_edges > 0
    row = cache.peek(h.row_key(42, shards=sg.size))
    assert row is not None and np.array_equal(row, ref)
    sched.submit("big", 42, 99)                 # a repeat hits the cache
    assert sched.drain()[0].via == "cache"


def test_sharded_evicted_graph_race_fails_typed_while_live_serves(sg, stack):
    s = stack(500)
    sched, reg = s.sched, s.registry
    reg.register("ga", carry(jgraph("sparse", 1200, 21)))
    reg.register("gb", carry(jgraph("sparse", 1200, 22)))
    sched.submit("ga", 5)
    sched.drain()                               # ga is staged everywhere
    assert [r["slots"] for r in sg.stats()] == [1] * sg.size
    sched.submit("ga", 11)
    sched.submit("ga", 40, 900)
    sched.submit("gb", 17)
    reg.evict("ga")
    by_source = {a.query.source: a for a in sched.tick()}
    for src in (11, 40):
        assert by_source[src].status == "graph_gone"
        assert not by_source[src].ok
    live = by_source[17]
    assert live.status == "ok" and live.exact
    assert np.array_equal(live.value, serial_row("sparse", 1200, 22, 17))
    assert sched.sharded_batches == 2           # gb really went sharded
    assert not s.cache.keys_for("ga")           # eviction purged rows
    # the followers dropped ga's blocks: gb's is all that is staged
    ranks = sg.stats()
    assert [r["slots"] for r in ranks] == [1] * sg.size
    h = reg.get("gb")
    assert reg.bytes_in_use == h.nbytes
    assert h.nbytes == (h.cg.nbytes + h.partition(sg.size).nbytes
                        + sum(r["staged_bytes"] for r in ranks))


def test_sharded_spans_and_cost_records_carry_the_group(sg, stack):
    """The sharded branches' spans (``stage`` inside ``batch_solve`` /
    ``p2p_solve``, with ``P=``) and cost records (``nprocs=``, the
    engine's ``sweeps`` and ``edges_relaxed``), as JAX's scheduler writes
    them; they come from the leader alone."""
    from repro_torch.obs import CostLog, Tracer, set_cost_log, set_tracer

    s = stack(500)
    s.registry.register("big", carry(jgraph("sparse", 2000, 3)))
    tr, cl = Tracer(), CostLog()
    prev = set_tracer(tr), set_cost_log(cl)
    try:
        for src in (5, 9, 700):
            s.sched.submit("big", src)
        s.sched.drain()
        s.sched.submit("big", 42, 77)
        s.sched.drain()
    finally:
        set_tracer(prev[0])
        set_cost_log(prev[1])
    solves = {sp.name: sp.args for sp in tr.spans
              if sp.name in ("batch_solve", "p2p_solve")}
    assert solves["batch_solve"]["engine"] == "multisource_csr_sharded"
    assert solves["p2p_solve"]["engine"] == "frontier_sharded"
    assert {a["P"] for a in solves.values()} == {sg.size}
    assert solves["batch_solve"]["B"] == 4
    assert sum(sp.name == "stage" for sp in tr.spans) == 2
    recs = [r.to_dict() for r in cl.records]
    assert [(r["engine"], r["batch"], r["nprocs"]) for r in recs] == [
        ("multisource_csr_sharded", 4, sg.size),
        ("frontier_sharded", 1, sg.size)]
    assert recs[0]["edges_relaxed"] + recs[1]["edges_relaxed"] == \
        s.sched.sharded_edges
    assert all(r["converged"] and r["backend"] == "cpu" for r in recs)


def test_sharded_occupancy_and_bucket_padding(stack):
    s = stack(100)
    s.registry.register("g", carry(jgraph("sparse", 400, 9)))
    for src in (1, 2, 3):                       # 3 distinct -> bucket 4
        s.sched.submit("g", src)
    answers = s.sched.tick()
    assert s.sched.sharded_batches == 1
    assert s.sched.mean_occupancy == pytest.approx(3 / 4)
    for a in answers:
        assert np.array_equal(a.value,
                              serial_row("sparse", 400, 9, a.query.source))


def test_sharded_capped_solve_is_not_converged_and_not_cached(stack):
    s = stack(100, max_sweeps=1)
    s.registry.register("g", carry(jgraph("sparse", 400, 10)))
    s.sched.submit("g", 7)
    s.sched.submit("g", 8)
    batch = s.sched.tick()
    s.sched.submit("g", 9, 300)
    p2p = s.sched.tick()
    for a in batch + p2p:
        assert a.status == "not_converged" and a.value is None
    assert s.sched.not_converged == 3
    assert s.sched.sharded_batches == 1 and s.sched.sharded_p2p == 1
    assert not s.cache.keys_for("g")


def _closed_loop(sched, events, chunk=6):
    """Submit ``chunk`` events, tick once, repeat; then drain."""
    out = []
    for i in range(0, len(events), chunk):
        for e in events[i:i + chunk]:
            sched.submit(e.graph, e.source, e.target, arrival=e.arrival)
        out.extend(sched.tick())
    out.extend(sched.drain())
    return {a.query.qid: a for a in out}


@pytest.mark.parametrize("scenario, seed", [("zipf", 0), ("p2p", 1)])
def test_seeded_trace_answers_equal_jax_single_device(sg, stack, scenario,
                                                      seed):
    graphs = {"big": ("random", 1500, 31), "small": ("random", 300, 32)}
    sizes = [(name, spec[1]) for name, spec in graphs.items()]
    events = make_trace(scenario, sizes, num_queries=60, rate=1000.0,
                        seed=seed)
    j_events = j_make_trace(scenario, sizes, num_queries=60, rate=1000.0,
                            seed=seed)
    assert [(e.graph, e.source, e.target) for e in events] == [
        (e.graph, e.source, e.target) for e in j_events]
    s = stack(1000, max_batch=8, cache_rows=256)
    jreg = JRegistry()
    jsched = JScheduler(jreg, JCache(256), max_batch=8)
    for name, spec in graphs.items():
        s.registry.register(name, carry(jgraph(*spec)), landmarks=4)
        jreg.register(name, jgraph(*spec), landmarks=4)
    port = _closed_loop(s.sched, events)
    ref = _closed_loop(jsched, j_events)
    assert sorted(port) == sorted(ref)
    assert s.sched.sharded_sources > 0
    for qid, a in port.items():
        b = ref[qid]
        assert (a.status, a.exact) == (b.status, b.exact) == ("ok", True)
        assert np.asarray(a.value, np.float32).tobytes() == np.asarray(
            b.value, np.float32).tobytes(), qid
        if a.via != b.via:
            # a cached sharded p2p row (JAX caches no target= row) answers
            # a query JAX's scheduler had to solve, and leaves a smaller
            # residue in its tick: one p2p query, solved alone
            assert (a.via, b.via) in (("cache", "batch"), ("cache", "target"),
                                      ("target", "batch")), (qid, a.via,
                                                             b.via)
            assert a.query.graph == "big" and s.sched.sharded_p2p > 0


# ---------------------------------------------------------------------------
# engine="auto" on an SPMD group of 4 ranks
# ---------------------------------------------------------------------------

def _auto_rank(group, big, small):
    from repro_torch.serve import policy_override

    torch.set_num_threads(1)
    out = {}
    with policy_override(DispatchPolicy(shard_threshold=500, device=CPU,
                                        group=group)):
        for key, g, src in (("single", big, 3), ("batch", big, [3, 7]),
                            ("small", small, 0)):
            res = shortest_paths(g, src, engine="auto", device=CPU,
                                 group=group)
            out[key] = (res.engine, res.dist)
    return out


def test_auto_engine_routes_sharded_on_a_group_of_four(tmp_path):
    big, small = jgraph("sparse", 2000, 11), jgraph("sparse", 100, 12)
    ranks = spawn(_auto_rank, 4, backend="gloo", store_dir=tmp_path,
                  timeout=120, args=(carry(big), carry(small)))
    ref = np.asarray(j_sp(big, 3, engine="serial").dist)
    ref7 = np.asarray(j_sp(big, 7, engine="serial").dist)
    ref_small = np.asarray(j_sp(small, 0, engine="serial").dist)
    for out in ranks:
        assert out["single"][0] == "frontier_sharded"
        assert np.array_equal(out["single"][1], ref)
        assert out["batch"][0] == "multisource_csr_sharded"
        assert np.array_equal(out["batch"][1][0], ref)
        assert np.array_equal(out["batch"][1][1], ref7)
        assert out["small"][0] == "frontier"
        assert np.array_equal(out["small"][1], ref_small)


# ---------------------------------------------------------------------------
# refusals and a broken group
# ---------------------------------------------------------------------------

def test_scheduler_refuses_a_sharding_policy_without_the_group(sg):
    policy = DispatchPolicy(shard_threshold=500, device=CPU, group=sg)
    assert policy.nprocs == sg.size
    with pytest.raises(ValueError, match="serving group"):
        MicroBatchScheduler(GraphRegistry(device=CPU), DistanceCache(4),
                            dispatch=policy)
    # without a group a CPU policy has one rank and never shards
    assert DispatchPolicy(shard_threshold=500, device=CPU).nprocs == 1
    if sg.size > 2:
        with pytest.raises(ValueError, match=f"group has {sg.size}"):
            MicroBatchScheduler(
                GraphRegistry(device=CPU, group=sg), DistanceCache(4),
                dispatch=DispatchPolicy(shard_threshold=500, device=CPU,
                                        group=sg, nprocs=2))


def test_leader_side_refusal_sends_no_command(sg, stack):
    s = stack(500)
    h = s.registry.register("big", carry(jgraph("sparse", 2000, 3)))
    h.partition_ops(sg.size)
    slot = h.partition_slot
    sent = sg.commands
    with pytest.raises(QueryRejected, match="out of range"):
        s.sched.submit("big", 2000)
    for bad in (lambda: sg.solve(slot, 2000),
                lambda: sg.solve(slot, 3, max_sweeps=-1),
                lambda: sg.solve_batch(slot, [1, -1]),
                lambda: sg.solve_batch(slot + 1000, [1])):
        with pytest.raises(ValueError):
            bad()
    assert sg.commands == sent
    s.sched.submit("big", 5, 9)
    a = s.sched.drain()[0]
    assert a.ok and np.float32(a.value) == serial_row("sparse", 2000, 3,
                                                      5)[9]
    assert sg.commands == sent + 1


def test_killed_follower_is_a_typed_error_and_one_device_serves(sg, stack):
    """Runs last on its group: the group stays broken."""
    s = stack(500)
    s.registry.register("big", carry(jgraph("sparse", 2000, 3)))
    s.registry.register("small", carry(jgraph("sparse", 100, 4)))
    s.sched.submit("big", 5)
    assert s.sched.drain()[0].ok                # the group serves
    victim = sg.size - 1
    sg.procs[victim - 1].kill()
    sg.procs[victim - 1].join()
    t0 = time.monotonic()
    s.sched.submit("big", 6)
    s.sched.submit("small", 3)
    answers = {a.query.graph: a for a in s.sched.tick()}
    assert time.monotonic() - t0 <= 15.0
    bad = answers["big"]
    assert bad.status == "solve_failed" and isinstance(bad.error,
                                                       GroupBroken)
    assert bad.error.rank == victim and f"rank {victim}" in str(bad.error)
    good = answers["small"]
    assert good.ok and np.array_equal(good.value,
                                      serial_row("sparse", 100, 4, 3))
    # every later sharded solve fails at once, naming the rank
    t0 = time.monotonic()
    s.sched.submit("big", 7, 8)
    again = s.sched.drain()[0]
    assert isinstance(again.error, GroupBroken) and again.error.rank == victim
    with pytest.raises(GroupBroken, match=f"rank {victim}"):
        sg.stats()
    assert time.monotonic() - t0 < 1.0
