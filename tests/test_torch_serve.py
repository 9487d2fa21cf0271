"""Port parity for the serving path: repro_torch.serve (device="cpu") against
repro.serve on the same graphs, carried across with ``from_arrays``, and
the same seeded traces.

The invariant of the JAX suite holds on the port: whatever path an answer
takes (cache hit, landmark row, bucket-padded multisource batch, target
early-exit frontier solve, incremental repair after a mutation), it is
bitwise equal to a fresh ``serial`` solve.  On top, the port's scheduler
answers every seeded trace exactly as the JAX scheduler does: the same
answers in the same order (value bytes, via, status, exact), the same
ticks, ``snapshot()`` and ``stats()`` — save ``bytes_in_use``, since the
port stages its scatter indices as int64 where JAX stages int32, which is
checked against the port's own tensors instead.  Also: registry eviction
and byte accounting, the cache's LRU and freeze rule (torch-backed rows
included), landmark bounds (``LandmarkSet.D`` bitwise JAX's), the dispatch
tables (a CPU policy routes as JAX's; a CUDA policy names the kernel
twins, built here with a stubbed device count), ``engine="auto"``, the
``target=`` early exit, and the robustness cases of the JAX suite:
validation, eviction races, deadlines, shedding, degradation, retries,
sweep caps, rollback and seeded chaos.
"""
import numpy as np
import pytest
import torch

from repro.core import csr as JC
from repro.core import graph as JG
from repro.core.api import shortest_paths as j_sp
from repro.dynamic import DynamicGraph as JDyn
from repro.serve import DispatchPolicy as JPolicy
from repro.serve import DistanceCache as JCache
from repro.serve import FaultPlan as JFaultPlan
from repro.serve import GraphRegistry as JRegistry
from repro.serve import MicroBatchScheduler as JScheduler
from repro.serve import MutationEvent as JMutationEvent
from repro.serve import build_landmarks as j_build_landmarks
from repro.serve import make_churn_trace as j_make_churn_trace
from repro.serve import make_trace as j_make_trace
from repro.serve.workload import zipf_vertices as j_zipf_vertices
from repro_torch.core import csr as TC
from repro_torch.core.api import shortest_paths
from repro_torch.core.frontier import frontier_operands, sssp_frontier
from repro_torch.dynamic import DynamicGraph
from repro_torch.serve import (SCENARIOS, DispatchPolicy, DistanceCache,
                               FaultPlan, GraphRegistry, LatencyRecorder,
                               MicroBatchScheduler, MutationEvent,
                               QueryRejected, SchedulerStalled,
                               build_landmarks, make_churn_trace, make_trace,
                               policy_override, set_default_policy)
from repro_torch.serve import dispatch as TD
from repro_torch.serve.landmarks import sample_landmark_ids
from repro_torch.serve.workload import zipf_vertices

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def carry(cg):
    return TC.from_arrays(cg.indptr, cg.indices, cg.weights, cg.n,
                          cg.directed)


def _port(g):
    """The port's twin of a JAX graph object (CSR or dynamic)."""
    if isinstance(g, JDyn):
        return DynamicGraph(carry(g.base), overlay_capacity=g.overlay_capacity)
    return carry(g)


def _stack(cg, *, budget=None, cache_rows=256, max_batch=8, landmarks=0,
           name="g", jax=False, **kw):
    """A registry + cache + scheduler holding ``cg`` (a JAX graph) under
    ``name``: the JAX package's stack, or the port's on the CPU."""
    if jax:
        registry = JRegistry(byte_budget=budget)
        cache = JCache(capacity=cache_rows)
        sched = JScheduler(registry, cache, max_batch=max_batch, **kw)
    else:
        registry = GraphRegistry(byte_budget=budget, device=CPU)
        cache = DistanceCache(capacity=cache_rows)
        sched = MicroBatchScheduler(registry, cache, max_batch=max_batch,
                                    **kw)
    if cg is not None:
        registry.register(name, cg if jax else _port(cg), landmarks=landmarks)
    return registry, cache, sched


def _serial_rows(cg, sources):
    return {s: j_sp(cg, s, engine="serial").dist for s in set(sources)}


def _assert_exact(answers, rows_by_graph):
    """Every Answer bitwise-equal to the serial row of its query."""
    for a in answers:
        q = a.query
        ref = rows_by_graph[q.graph][q.source]
        if q.target is None:
            assert np.array_equal(a.value, ref), (q, a.via)
        else:
            got, want = np.float32(a.value), ref[q.target]
            assert got == want or (np.isinf(got) and np.isinf(want)), \
                (q, a.via, got, want)


def _key(a):
    v = a.value
    if isinstance(v, np.ndarray):
        v = ("row", np.asarray(v, np.float32).tobytes())
    return (a.query.qid, a.via, a.status, a.exact, v, a.bounds,
            a.service_start)


def _same_answers(port, jax):
    assert [_key(a) for a in port] == [_key(a) for a in jax]


def _stats_but_bytes(sched):
    s = sched.stats()
    s["registry"] = dict(s["registry"])
    s["registry"].pop("bytes_in_use")
    s["registry"].pop("over_budget")
    return s


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_registry_lru_eviction_by_byte_budget():
    graphs = [JC.random_csr_graph(200, 600, seed=i) for i in range(3)]
    one = graphs[0].nbytes
    assert carry(graphs[0]).nbytes == one
    logs = []
    for jax in (False, True):
        registry = (JRegistry(byte_budget=int(2.5 * one)) if jax
                    else GraphRegistry(byte_budget=int(2.5 * one),
                                       device=CPU))
        evicted = []
        registry.add_evict_hook(evicted.append)
        for i, cg in enumerate(graphs):
            registry.register(f"g{i}", cg if jax else carry(cg))
        # third registration blows the 2.5-graph budget: g0 (LRU) must go
        assert evicted == ["g0"]
        assert registry.names == ("g1", "g2")
        assert registry.stats()["evicted"] == 1
        with pytest.raises(KeyError):
            registry.get("g0")
        registry.get("g1")           # g2 is now the LRU victim
        g3 = JC.random_csr_graph(200, 600, seed=9)
        registry.register("g3", g3 if jax else carry(g3))
        assert "g1" in registry and "g2" not in registry
        logs.append((evicted, registry.names, registry.bytes_in_use,
                     registry.stats()))
    assert logs[0] == logs[1]        # nothing staged: bytes agree too


def test_registry_staged_bytes_are_accounted():
    cg = JC.random_csr_graph(100, 300, seed=0)
    registry = GraphRegistry(device=CPU)
    h = registry.register("g", carry(cg))
    base = registry.bytes_in_use
    assert base == cg.nbytes
    csr = h.csr_ops()
    staged = registry.bytes_in_use
    assert staged == base + sum(t.nbytes for t in csr.values())
    front = h.frontier_ops()
    assert h.csr_ops() is csr and h.frontier_ops() is front   # staged once
    # frontier_ops shares csr_ops' tensors: the increment is the
    # out-CSR views only, each distinct tensor counted once
    for k in ("src", "dst", "w"):
        assert front[k] is csr[k]
    extra = sum(front[k].nbytes for k in ("out_indptr", "out_dst", "out_w"))
    assert registry.bytes_in_use == staged + extra
    assert all(t.device.type == "cpu" for t in front.values())


def test_registry_landmark_bytes_and_rows_match_jax():
    cg = JC.random_csr_graph(150, 450, seed=3)
    h = GraphRegistry(device=CPU).register("g", carry(cg), landmarks=5,
                                           landmark_seed=2)
    jh = JRegistry().register("g", cg, landmarks=5, landmark_seed=2)
    assert np.array_equal(h.landmarks.ids, jh.landmarks.ids)
    assert h.landmarks.D.tobytes() == np.asarray(jh.landmarks.D).tobytes()
    assert h.landmarks.nbytes == jh.landmarks.nbytes
    assert not h.landmarks.D.flags.writeable


def test_registry_single_graph_over_budget_is_admitted():
    cg = carry(JC.random_csr_graph(300, 900, seed=1))
    registry = GraphRegistry(byte_budget=10, device=CPU)      # absurdly small
    registry.register("g", cg)
    assert "g" in registry and registry.stats()["over_budget"]


def test_registry_refuses_the_sharded_view():
    registry = GraphRegistry(device=CPU)
    h = registry.register("g", carry(JC.random_csr_graph(40, 120, seed=0)))
    for call in (h.partition, h.partition_ops):
        with pytest.raises(NotImplementedError, match="sharded"):
            call(2)
    assert h.row_key(7) == ("g", 7)
    assert h.row_key(7, shards=2) == ("g", 0, 7)     # owner block of 7


def test_registry_eviction_purges_cache_rows():
    g0, g1 = (JC.random_csr_graph(150, 450, seed=i) for i in (0, 1))
    registry, cache, sched = _stack(g0, budget=int(1.5 * g0.nbytes),
                                    name="g0")
    sched.submit("g0", 3)
    sched.drain()
    assert cache.peek(("g0", 3)) is not None
    registry.register("g1", carry(g1))            # evicts g0
    assert cache.peek(("g0", 3)) is None          # purged with its graph
    sched.submit("g0", 4)
    sched.submit("g1", 2)
    answers = sched.tick()
    by_graph = {a.query.graph: a for a in answers}
    assert by_graph["g0"].via == "error" and by_graph["g0"].value is None
    assert by_graph["g0"].status == "graph_gone" and not by_graph["g0"].ok
    assert by_graph["g1"].status == "ok" and by_graph["g1"].exact
    assert np.array_equal(by_graph["g1"].value,
                          j_sp(g1, 2, engine="serial").dist)


def test_registry_reregister_same_name_purges_stale_rows():
    g_old = JC.random_csr_graph(150, 450, seed=0)
    g_new = JC.random_csr_graph(150, 450, seed=5)
    registry, cache, sched = _stack(g_old)
    sched.submit("g", 7)
    sched.drain()
    registry.register("g", carry(g_new))          # same name, new graph
    sched.submit("g", 7)
    (ans,) = sched.drain()
    assert np.array_equal(ans.value, j_sp(g_new, 7, engine="serial").dist)


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

def test_cache_lru_counters_and_eviction():
    stats = []
    for mod_cache in (DistanceCache, JCache):
        cache = mod_cache(capacity=2)
        r = {k: np.full(4, float(k)) for k in range(3)}
        cache.put(("g", 0), r[0])
        cache.put(("g", 1), r[1])
        assert cache.get(("g", 0)) is r[0]            # 0 now MRU
        cache.put(("g", 2), r[2])                     # evicts 1 (LRU)
        assert cache.get(("g", 1)) is None
        assert cache.get(("g", 2)) is r[2]
        assert (cache.hits, cache.misses, cache.evictions) == (2, 1, 1)
        assert cache.stats()["hit_rate"] == pytest.approx(2 / 3, abs=1e-3)
        stats.append((cache.stats(), cache.metrics.snapshot()))
    assert stats[0] == stats[1]


def test_cache_capacity_zero_disables():
    cache = DistanceCache(capacity=0)
    cache.put(("g", 0), np.zeros(4))
    assert cache.get(("g", 0)) is None and len(cache) == 0
    with pytest.raises(ValueError):
        DistanceCache(capacity=-1)


def test_cache_purge_graph_is_selective():
    cache = DistanceCache(capacity=8)
    cache.put(("a", 0), np.zeros(2))
    cache.put(("a", 1), np.zeros(2))
    cache.put(("b", 0), np.ones(2))
    assert cache.purge_graph("a") == 2
    assert cache.peek(("b", 0)) is not None and len(cache) == 1


def test_cache_put_freezes_rows_against_caller_mutation():
    cache = DistanceCache(capacity=4)
    backing = np.arange(6, dtype=np.float32)
    view = backing[:4]
    assert not view.flags.owndata
    cache.put(("g", 0), view)
    backing[:] = -1.0                    # mutate after put
    assert np.array_equal(cache.get(("g", 0)),
                          np.arange(4, dtype=np.float32))
    row = np.ones(4, dtype=np.float32)
    cache.put(("g", 1), row)
    with pytest.raises(ValueError):
        row[0] = 99.0                    # owned: frozen in place
    assert np.array_equal(cache.get(("g", 1)), np.ones(4))


@pytest.mark.parametrize("form", ["numpy", "cpu_numpy", "tensor", "row_of"])
def test_cache_put_copies_torch_backed_rows(form):
    """A row that shares a tensor's storage (``t.numpy()``,
    ``t.cpu().numpy()``, the tensor itself, a row of a batched result) is
    copied before it is frozen: writing the source tensor after ``put``
    never reaches the cached bytes, and the tensor stays writable."""
    cache = DistanceCache(capacity=4)
    t = torch.arange(8, dtype=torch.float32).reshape(2, 4)
    src = t[0]
    row = {"numpy": src.numpy(), "cpu_numpy": src.cpu().numpy(),
           "tensor": src, "row_of": t.numpy()[0]}[form]
    cache.put(("g", 0), row)
    t.fill_(-1.0)                        # the source tensor moves on
    got = cache.get(("g", 0))
    assert np.array_equal(got, np.arange(4, dtype=np.float32))
    assert not got.flags.writeable
    assert float(t[0, 0]) == -1.0


def test_cache_rejects_non_tuple_keys():
    cache = DistanceCache(capacity=4)
    with pytest.raises(TypeError, match="tuple"):
        cache.put("g", np.zeros(2))
    cache.put(("g", 0), np.zeros(2))
    cache.put(("g", 1, 0), np.ones(2))   # versioned/sharded arities coexist
    assert sorted(cache.keys_for("g")) == [("g", 0), ("g", 1, 0)]
    assert cache.purge_graph("g") == 2 and len(cache) == 0


# ---------------------------------------------------------------------------
# scheduler: dedup, bucketing, exactness per path
# ---------------------------------------------------------------------------

def test_scheduler_dedup_one_solve_for_repeat_sources():
    cg = JC.random_csr_graph(120, 360, seed=2)
    _, _, sched = _stack(cg)
    for _ in range(10):
        sched.submit("g", 5)
    for t in (1, 2, 3):
        sched.submit("g", 5, t)
    answers = sched.tick()
    assert len(answers) == 13
    assert sched.engine_batches == 1              # ONE solve served all 13
    assert sched.engine_sources == 1
    assert sched.dedup_saved == 12
    _assert_exact(answers, {"g": _serial_rows(cg, [5])})


def test_scheduler_bucket_padding_hits_powers_of_two():
    cg = JC.random_csr_graph(100, 300, seed=3)
    _, _, sched = _stack(cg, max_batch=8)
    for s in (1, 2, 3):                           # 3 distinct -> bucket 4
        sched.submit("g", s)
    sched.tick()
    assert sched.mean_occupancy == pytest.approx(3 / 4)
    assert sched._bucket(1) == 1 and sched._bucket(3) == 4
    assert sched._bucket(8) == 8 and sched._bucket(100) == 8  # clamped
    assert sched._bucket(3, cap=2) == 3 and sched._bucket(5, cap=6) == 6


def test_scheduler_overflow_requeues_beyond_max_batch():
    cg = JC.random_csr_graph(60, 180, seed=4)
    _, _, sched = _stack(cg, max_batch=4)
    for s in range(10):
        sched.submit("g", s)
    first = sched.tick()
    assert len(first) == 4 and sched.pending == 6
    rest = sched.drain()
    assert len(rest) == 6
    _assert_exact(first + rest, {"g": _serial_rows(cg, range(10))})


def test_scheduler_admission_split_and_requeue_order():
    cg = JC.random_csr_graph(60, 180, seed=6)
    _, _, sched = _stack(cg, max_batch=2)
    qs = [sched.submit("g", s) for s in (7, 8, 9, 7, 10)]
    first = sched.tick()
    assert [a.query.qid for a in first] == [qs[0].qid, qs[1].qid, qs[3].qid]
    assert sched.engine_batches == 1 and sched.engine_sources == 2
    assert [q.qid for q in sched._queue] == [qs[2].qid, qs[4].qid]
    later = sched.submit("g", 11)
    second = sched.tick()
    assert [a.query.qid for a in second] == [qs[2].qid, qs[4].qid]
    third = sched.tick()
    assert [a.query.qid for a in third] == [later.qid]
    _assert_exact(first + second + third,
                  {"g": _serial_rows(cg, [7, 8, 9, 10, 11])})


def test_scheduler_multigraph_overflow_fair_requeue():
    ga, gb = (JC.random_csr_graph(50, 150, seed=i) for i in (7, 8))
    registry, cache, sched = _stack(ga, max_batch=2, name="a")
    registry.register("b", carry(gb))
    for s in range(4):
        sched.submit("a", s)
        sched.submit("b", s)
    first = sched.tick()
    assert len(first) == 4
    assert [(q.graph, q.source) for q in sched._queue] == [
        ("a", 2), ("a", 3), ("b", 2), ("b", 3)]
    newer = sched.submit("a", 4)
    second = sched.tick()
    assert {(a.query.graph, a.query.source) for a in second} == {
        ("a", 2), ("a", 3), ("b", 2), ("b", 3)}
    assert [q.qid for q in sched._queue] == [newer.qid]
    third = sched.tick()
    assert [a.query.qid for a in third] == [newer.qid]
    rows = {"a": _serial_rows(ga, [0, 1, 2, 3, 4]),
            "b": _serial_rows(gb, range(4))}
    _assert_exact(first + second + third, rows)


def test_scheduler_cache_hits_skip_engine():
    cg = JC.random_csr_graph(80, 240, seed=5)
    _, cache, sched = _stack(cg)
    sched.submit("g", 11)
    sched.drain()
    batches = sched.engine_batches
    sched.submit("g", 11)
    sched.submit("g", 11, 40)
    answers = sched.drain()
    assert sched.engine_batches == batches        # no new solve
    assert all(a.via == "cache" for a in answers)
    _assert_exact(answers, {"g": _serial_rows(cg, [11])})


def test_scheduler_target_solo_path_exact_and_uncached():
    cg = JC.random_csr_graph(150, 450, seed=6)
    _, cache, sched = _stack(cg, landmarks=4)
    ids = set(sched.registry.get("g").landmarks.ids.tolist())
    s = next(v for v in range(150) if v not in ids)
    sched.submit("g", s, (s + 37) % 150)
    (ans,) = sched.drain()
    assert ans.via == "target" and sched.target_solves == 1
    assert cache.peek(("g", s)) is None           # partial row: not cached
    _assert_exact([ans], {"g": _serial_rows(cg, [s])})
    # the CPU handle's frontier sweep is the engine's plain default
    assert sched.registry.get("g").frontier_sweep_fn() is None


def test_scheduler_landmark_row_answers_are_engine_rows():
    cg = JC.random_csr_graph(90, 270, seed=7)
    _, _, sched = _stack(cg, landmarks=6)
    lm = int(sched.registry.get("g").landmarks.ids[0])
    sched.submit("g", lm)
    sched.submit("g", lm, (lm + 1) % 90)
    answers = sched.drain()
    assert all(a.via == "landmark" for a in answers)
    assert sched.engine_batches == 0
    _assert_exact(answers, {"g": _serial_rows(cg, [lm])})


def test_scheduler_landmark_disconnection_answer():
    edges = np.stack([np.arange(49), np.arange(1, 50)], 1)
    cg = JG.csr_from_edge_list(52, edges, np.ones(49) * 2.0)
    registry, _, sched = _stack(cg, landmarks=0)
    handle = registry.get("g")
    handle.landmarks = build_landmarks(carry(cg), 8, seed=0, device=CPU)
    src = int(next(i for i in range(50)
                   if np.isfinite(handle.landmarks.D[:, i]).any()
                   and i not in set(handle.landmarks.ids.tolist())))
    sched.submit("g", src, 51)                    # 50..51 is the island
    (ans,) = sched.drain()
    assert ans.via == "landmark" and np.isinf(ans.value)
    assert np.isinf(j_sp(cg, src, engine="serial").dist[51])


# ---------------------------------------------------------------------------
# trace replay: the port's scheduler against the JAX scheduler
# ---------------------------------------------------------------------------

def _replay_pair(scenario, **kw):
    g0 = JC.random_csr_graph(130, 390, seed=8)
    g1 = JC.random_csr_graph(90, 270, seed=9)
    out = []
    for jax in (False, True):
        registry, _, sched = _stack(g0, landmarks=5, max_batch=4, name="g0",
                                    jax=jax, **kw)
        registry.register("g1", g1 if jax else carry(g1), landmarks=5)
        events = (j_make_trace if jax else make_trace)(
            scenario, [("g0", 130), ("g1", 90)], num_queries=50, rate=1e4,
            seed=10)
        for e in events:
            sched.submit(e.graph, e.source, e.target, arrival=e.arrival)
        out.append((sched, sched.drain()))
    return out, {"g0": g0, "g1": g1}


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_trace_replay_bitwise_exact_and_equal_to_jax(scenario):
    ((sched, answers), (jsched, janswers)), graphs = _replay_pair(scenario)
    assert len(answers) == 50
    rows = {name: _serial_rows(g, [a.query.source for a in answers
                                   if a.query.graph == name])
            for name, g in graphs.items()}
    _assert_exact(answers, rows)
    _same_answers(answers, janswers)
    assert sched.ticks == jsched.ticks
    assert sched.snapshot() == jsched.snapshot()
    assert _stats_but_bytes(sched) == _stats_but_bytes(jsched)
    rec = LatencyRecorder()
    for a in answers:
        rec.observe(a, now=1.0)
    assert rec.summary()["queries"] == 50
    if scenario == "zipf":
        served_free = (sched.dedup_saved + sched.answered_via["cache"]
                       + sched.answered_via["landmark"])
        assert served_free > 0


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_trace_replay_with_deadlines_equal_to_jax(scenario):
    """Deadlined replay ticking on the event clock: expiries, degraded
    answers and service_start stamps equal JAX's."""
    out = []
    for jax in (False, True):
        g0 = JC.random_csr_graph(130, 390, seed=8)
        _, _, sched = _stack(g0, landmarks=4, max_batch=2, name="g0",
                             jax=jax, degrade_margin=0.004)
        events = (j_make_trace if jax else make_trace)(
            scenario, [("g0", 130)], num_queries=40, rate=2000.0, seed=4,
            deadline=0.005)
        answers = []
        for i, e in enumerate(events):
            sched.submit(e.graph, e.source, e.target, arrival=e.arrival,
                         deadline=e.deadline)
            if i % 4 == 3:
                answers += sched.tick(now=e.arrival + 0.002)
        answers += sched.drain(now=events[-1].arrival + 0.01)
        out.append((sched, answers))
    (sched, answers), (jsched, janswers) = out
    _same_answers(answers, janswers)
    assert sched.snapshot() == jsched.snapshot()


def _dyn_graph():
    return JDyn(JC.random_csr_graph(120, 360, seed=11), overlay_capacity=16)


@pytest.mark.parametrize("seed,repair_rows", [(0, 8), (3, 1), (5, 0)])
def test_churn_replay_bitwise_exact_and_equal_to_jax(seed, repair_rows):
    """A churn trace (mutations among queries) replayed event by event on
    both schedulers: the same answers and mutation acks, the same cache
    reconciliation (rows kept / repaired / invalidated) and snapshot, and
    every exact answer bitwise equal to serial on the snapshot of the
    version that answered it."""
    out = []
    for jax in (False, True):
        dyn = _dyn_graph()
        registry, _, sched = _stack(dyn, landmarks=3, max_batch=4,
                                    name="d", jax=jax,
                                    repair_rows=repair_rows)
        if not jax:
            dyn = registry.get("d").dyn
        events = (j_make_churn_trace if jax else make_churn_trace)(
            [("d", dyn.base)], num_events=60, rate=1e3, seed=seed,
            mutate_frac=0.3, p2p_frac=0.4)
        mut_cls = JMutationEvent if jax else MutationEvent
        answers, refs = [], {}
        for e in events:
            if isinstance(e, mut_cls):
                sched.submit_mutation(e.graph, e.op, e.u, e.v, e.w,
                                      arrival=e.arrival)
            else:
                sched.submit(e.graph, e.source, e.target, arrival=e.arrival)
            for a in sched.drain(e.arrival):
                answers.append(a)
                if a.via != "mutate" and not jax:
                    key = (dyn.version, a.query.source)
                    if key not in refs:
                        refs[key] = shortest_paths(
                            dyn.snapshot(), a.query.source,
                            engine="serial", device=CPU).dist
                    _assert_exact([a], {"d": {a.query.source: refs[key]}})
        out.append((sched, answers, [astuple(e) for e in events]))
    (sched, answers, events), (jsched, janswers, jevents) = out
    assert events == jevents
    assert any(a.via == "mutate" for a in answers)
    _same_answers(answers, janswers)
    assert sched.snapshot() == jsched.snapshot()
    assert _stats_but_bytes(sched) == _stats_but_bytes(jsched)


def astuple(e):
    import dataclasses

    return (type(e).__name__,) + dataclasses.astuple(e)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_make_trace_draws_jax_events(scenario):
    kw = dict(num_queries=80, rate=50.0, seed=7, zipf_a=1.2, p2p_frac=0.6,
              hot_seed=3, deadline=0.25)
    graphs = [("a", 300), ("b", 77)]
    port = make_trace(scenario, graphs, **kw)
    jax = j_make_trace(scenario, graphs, **kw)
    assert [astuple(e) for e in port] == [astuple(e) for e in jax]


def test_make_churn_trace_draws_jax_events():
    cg = JC.random_csr_graph(200, 600, seed=2)
    kw = dict(num_events=150, rate=100.0, mutate_frac=0.4, p2p_frac=0.5,
              seed=9, hot_seed=1)
    port = make_churn_trace([("g", carry(cg))], **kw)
    jax = j_make_churn_trace([("g", cg)], **kw)
    assert [astuple(e) for e in port] == [astuple(e) for e in jax]
    with pytest.raises(ValueError):
        make_churn_trace([("g", carry(cg))], num_events=1, rate=0.0)


def test_zipf_trace_is_skewed_and_deterministic():
    v = zipf_vertices(np.random.default_rng(0), 1000, 5000, 1.1)
    assert np.array_equal(v, j_zipf_vertices(np.random.default_rng(0),
                                             1000, 5000, 1.1))
    _, counts = np.unique(v, return_counts=True)
    assert counts.max() > 5 * np.median(counts)   # heavy head
    t1 = make_trace("zipf", [("g", 50)], num_queries=20, rate=10, seed=3)
    t2 = make_trace("zipf", [("g", 50)], num_queries=20, rate=10, seed=3)
    assert t1 == t2
    a = make_trace("zipf", [("g", 200)], num_queries=300, rate=10,
                   seed=1, hot_seed=42)
    b = make_trace("zipf", [("g", 200)], num_queries=300, rate=10,
                   seed=2, hot_seed=42)
    assert len({e.source for e in a} & {e.source for e in b}) > 0
    with pytest.raises(ValueError):
        make_trace("bursty", [("g", 5)], num_queries=1, rate=1.0)


# ---------------------------------------------------------------------------
# landmarks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(5))
def test_landmark_rows_and_bounds_match_jax(seed):
    from conftest import dijkstra_oracle

    cg = JC.random_csr_graph(80, 200, seed=seed)
    ls = build_landmarks(carry(cg), 6, seed=seed, device=CPU)
    jls = j_build_landmarks(cg, 6, seed=seed)
    assert np.array_equal(ls.ids, jls.ids)
    assert ls.D.dtype == np.float32
    assert ls.D.tobytes() == np.asarray(jls.D).tobytes()
    rng = np.random.default_rng(seed)
    for _ in range(20):
        s, t = int(rng.integers(80)), int(rng.integers(80))
        d = dijkstra_oracle(cg, s)[t]
        lb, ub = ls.lower_bound(s, t), ls.upper_bound(s, t)
        assert (lb, ub, ls.conservative_lb(s, t)) == (
            jls.lower_bound(s, t), jls.upper_bound(s, t),
            jls.conservative_lb(s, t))
        if np.isinf(d):
            assert np.isinf(ub)
        else:
            assert lb <= d * (1 + 1e-5) + 1e-5
            assert ub >= d * (1 - 1e-5) - 1e-5
        assert ls.conservative_lb(s, t) <= max(lb, 0.0)


def test_landmark_pinned_ids_on_dynamic_overlay_match_jax():
    jdyn = _dyn_graph()
    dyn = _port(jdyn)
    edits = [("add", 0, 119, 0.75), ("update", int(jdyn.base.indices[0]),
                                     int(jdyn.base.dst_ids()[0]), 70.0)]
    for d in (dyn, jdyn):
        for ed in edits:
            d.apply(ed)
        d.commit()
    from repro.dynamic.repair import dynamic_segment_sweep_multi as j_sweep
    from repro_torch.dynamic.repair import dynamic_segment_sweep_multi

    ids = np.array([3, 50, 117], np.int32)
    ls = build_landmarks(dyn, 3, ids=ids, csr_ops=dyn.dyn_ops(device=CPU),
                         sweep_fn=dynamic_segment_sweep_multi)
    jls = j_build_landmarks(jdyn, 3, ids=ids, csr_ops=jdyn.dyn_ops(),
                            sweep_fn=j_sweep)
    assert ls.D.tobytes() == np.asarray(jls.D).tobytes()


def test_landmark_refuses_directed_graphs():
    cg = carry(JC.random_csr_graph(40, 120, seed=0, directed=True))
    with pytest.raises(ValueError, match="directed"):
        build_landmarks(cg, 3, device=CPU)


def test_sample_landmark_ids_distinct_and_bounded():
    ids = sample_landmark_ids(50, 50, seed=1)
    assert sorted(ids.tolist()) == list(range(50))
    with pytest.raises(ValueError):
        sample_landmark_ids(10, 11)


# ---------------------------------------------------------------------------
# dispatch and engine="auto"
# ---------------------------------------------------------------------------

def _graphs():
    """Routing inputs on both sides of every threshold: (name, JAX graph)."""
    return {
        "small": JC.random_csr_graph(300, 900, seed=1),
        "sparse-5000": JC.sparse_csr_graph(5000, seed=2),
        "hub-5000": JC.skewed_hub_csr_graph(5000, seed=3),
        "dense-array": JG.random_graph(40, 0.2, seed=4).adj,
        "dynamic": _dyn_graph(),
    }


def _port_input(g):
    return g if isinstance(g, np.ndarray) else _port(g)


TWIN = {"frontier": "frontier_kernel",
        "delta_stepping": "delta_stepping_kernel"}


@pytest.mark.parametrize("name", list(_graphs()))
@pytest.mark.parametrize("kind", ["single", "batch", "p2p"])
def test_cpu_policy_routes_like_jax(name, kind):
    g = _graphs()[name]
    choice = DispatchPolicy(device=CPU).choose(_port_input(g), kind=kind)
    jchoice = JPolicy().choose(g, kind=kind)
    assert (choice.engine, choice.nprocs, choice.sharded, choice.delta,
            choice.batch_cap, choice.via) == (
        jchoice.engine, jchoice.nprocs, jchoice.sharded, jchoice.delta,
        jchoice.batch_cap, jchoice.via)
    assert choice.mesh is None and jchoice.mesh is None


def _fake_gpus(monkeypatch, count):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)


@pytest.mark.parametrize("name", list(_graphs()))
@pytest.mark.parametrize("kind", ["single", "batch", "p2p"])
def test_cuda_policy_names_the_kernel_twin(monkeypatch, name, kind):
    """Built with a stubbed device count (no tensor is made): static graphs
    route to the kernel twin of JAX's choice, dynamic ones to the plain
    engine; nothing shards on one card."""
    g = _graphs()[name]
    _fake_gpus(monkeypatch, 1)
    policy = DispatchPolicy(device="cuda")
    assert policy.nprocs == 1 and policy.device.type == "cuda"
    choice = policy.choose(_port_input(g), kind=kind)
    want = JPolicy().choose(g, kind=kind).engine
    if name != "dynamic":
        want = TWIN.get(want, want)
    assert choice.engine == want and not choice.sharded


def test_cuda_policy_on_four_cards_routes_sharded_and_the_scheduler_refuses(
        monkeypatch):
    _fake_gpus(monkeypatch, 4)
    policy = DispatchPolicy(device="cuda")
    assert policy.nprocs == 4
    big = TC.sparse_csr_graph(20000, seed=0)
    assert policy.choose(big, kind="batch").engine == "multisource_csr_sharded"
    assert policy.choose(big, kind="p2p").engine == "frontier_sharded"
    assert DispatchPolicy(device="cuda", nprocs=2).nprocs == 2
    registry = GraphRegistry(device="cuda")
    sched = MicroBatchScheduler(registry, DistanceCache(4), dispatch=policy)
    registry.register("big", big)                 # nothing staged yet
    assert sched._row_key(registry.get("big"), 7) == ("big", 0, 7)
    for target in (None, 5):
        sched.submit("big", 7, target)
        with pytest.raises(NotImplementedError, match="sharded"):
            sched.tick()
        sched._queue.clear()


def test_default_policy_per_device_and_override():
    cpu = TD.default_policy(CPU)
    assert cpu is TD.default_policy(torch.device("cpu"))
    assert cpu.device.type == "cpu"
    mine = DispatchPolicy(device=CPU, delta_threshold=None)
    with policy_override(mine) as p:
        assert p is mine and TD.default_policy(CPU) is mine
    assert TD.default_policy(CPU) is cpu
    assert set_default_policy(mine) is None
    assert set_default_policy(None) is mine
    with pytest.raises(ValueError, match="kind"):
        cpu.choose(TC.sparse_csr_graph(10), kind="bulk")


@pytest.mark.parametrize("name,kw", [
    ("small", {}),
    ("small", {"target": 17}),
    ("small", {"source": [0, 4, 9]}),
    ("sparse-5000", {}),
    ("sparse-5000", {"delta": 30.0}),
    ("hub-5000", {}),
    ("dense-array", {}),
    ("dynamic", {}),
])
def test_auto_engine_routes_like_jax_and_is_bitwise(name, kw):
    g = _graphs()[name]
    src = kw.pop("source", 0)
    res = shortest_paths(_port_input(g), src, engine="auto", device=CPU, **kw)
    jres = j_sp(g, src, engine="auto", **kw)
    assert res.engine == jres.engine
    assert res.dist.tobytes() == np.asarray(jres.dist).tobytes()
    if jres.pred is None:
        assert res.pred is None
    else:
        assert np.array_equal(res.pred, np.asarray(jres.pred))
    assert (res.sweeps, res.edges_relaxed, res.converged) == (
        jres.sweeps, jres.edges_relaxed, jres.converged)
    # and bitwise the named engine's answer
    named = shortest_paths(_port_input(g), src, engine=res.engine,
                           device=CPU, **kw)
    assert named.dist.tobytes() == res.dist.tobytes()


# ---------------------------------------------------------------------------
# target= early exit (core/frontier.py + api threading)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,seed", [(60, 180, 0), (200, 600, 1),
                                      (150, 300, 2)])
def test_target_early_exit_bitwise_vs_full_solve(n, m, seed):
    cg = JC.random_csr_graph(n, m, seed=seed)
    tg = carry(cg)
    full = shortest_paths(tg, 0, engine="frontier", device=CPU)
    rng = np.random.default_rng(seed)
    for t in {0, n - 1, *rng.integers(0, n, 5).tolist()}:
        part = shortest_paths(tg, 0, engine="frontier", target=int(t),
                              device=CPU)
        jpart = j_sp(cg, 0, engine="frontier", target=int(t))
        assert part.dist[t] == full.dist[t]
        assert part.dist.tobytes() == np.asarray(jpart.dist).tobytes()
        assert (part.sweeps, part.edges_relaxed) == (jpart.sweeps,
                                                     jpart.edges_relaxed)
        assert part.sweeps <= full.sweeps
        assert part.edges_relaxed <= full.edges_relaxed


def test_target_early_exit_with_admissible_lb_is_exact_and_cheaper():
    cg = JC.random_csr_graph(300, 900, seed=3)
    tg = carry(cg)
    ls = build_landmarks(tg, 8, seed=3, device=CPU)
    full = shortest_paths(tg, 7, engine="frontier", device=CPU)
    for t in (50, 150, 299):
        lb = ls.conservative_lb(7, t)
        part = shortest_paths(tg, 7, engine="frontier", target=t,
                              target_lb=lb, device=CPU)
        jpart = j_sp(cg, 7, engine="frontier", target=t, target_lb=lb)
        assert part.dist[t] == full.dist[t]
        assert part.edges_relaxed == jpart.edges_relaxed
        assert part.edges_relaxed <= full.edges_relaxed


def test_target_exit_settled_region_is_exact():
    tg = carry(JC.random_csr_graph(120, 360, seed=4))
    full = shortest_paths(tg, 0, engine="frontier", device=CPU)
    part = shortest_paths(tg, 0, engine="frontier", target=60, device=CPU)
    settled = part.dist < part.dist[60]
    assert np.array_equal(part.dist[settled], full.dist[settled])


def test_target_unreachable_runs_to_fixpoint():
    edges = np.stack([np.arange(9), np.arange(1, 10)], 1)
    tg = TC.csr_from_edge_list(12, edges, np.ones(9))   # 10..11 islanded
    res = shortest_paths(tg, 0, engine="frontier", target=11, device=CPU)
    assert np.isinf(res.dist[11])
    full = shortest_paths(tg, 0, engine="frontier", device=CPU)
    assert np.array_equal(res.dist, full.dist)


def test_target_rejected_for_non_frontier_engines():
    tg = carry(JC.random_csr_graph(30, 90, seed=5))
    with pytest.raises(ValueError, match="frontier"):
        shortest_paths(tg, 0, engine="bellman_csr", target=3, device=CPU)


def test_target_with_delta_schedule_exact():
    tg = carry(JC.random_csr_graph(150, 450, seed=6))
    full = shortest_paths(tg, 2, engine="frontier", device=CPU)
    part = shortest_paths(tg, 2, engine="frontier", target=99, delta=25.0,
                          device=CPU)
    assert part.dist[99] == full.dist[99]


def test_raw_sssp_frontier_target_counts_reduced_work():
    tg = carry(JC.random_csr_graph(400, 1200, seed=7))
    ops = frontier_operands(tg, device=CPU)
    d_full, _, s_full, e_full, _ = sssp_frontier(ops, 0, n=tg.n)
    nbr = int(ops["out_dst"][int(ops["out_indptr"][0])])
    d, _, s, e, _ = sssp_frontier(ops, 0, n=tg.n, target=nbr)
    assert d[nbr] == d_full[nbr]
    assert s <= s_full and e <= e_full


def test_frontier_operands_reuse_staged_base():
    tg = carry(JC.random_csr_graph(50, 150, seed=8))
    from repro_torch.core.bellman_csr import csr_operands

    base = csr_operands(tg, device=CPU)
    ops = frontier_operands(tg, device=CPU, base_ops=base)
    assert all(ops[k] is base[k] for k in base)
    assert set(base) == {"src", "dst", "w"}        # base left as it was
    fresh = frontier_operands(tg, device=CPU)
    for k, t in fresh.items():
        assert torch.equal(ops[k], t)


# ---------------------------------------------------------------------------
# robustness: typed failures, deadlines, degradation, chaos
# ---------------------------------------------------------------------------

def test_submit_validation_rejects_malformed_queries_eagerly():
    cg = JC.random_csr_graph(50, 150, seed=0)
    _, _, sched = _stack(cg)
    bad = [
        dict(graph=3, source=0),
        dict(graph="g", source=True),
        dict(graph="g", source=1.5),
        dict(graph="g", source=-1),
        dict(graph="g", source=50),
        dict(graph="g", source=0, target=-2),
        dict(graph="g", source=0, target=99),
    ]
    for kw in bad:
        with pytest.raises(QueryRejected):
            sched.submit(**kw)
    with pytest.raises(QueryRejected):
        sched.submit("g", 0, deadline=float("nan"))
    assert sched.pending == 0
    assert sched.stats()["submissions_rejected"] == len(bad) + 1
    sched.submit("g", 3)
    (a,) = sched.drain()
    assert a.ok and a.exact
    assert np.array_equal(a.value, j_sp(cg, 3, engine="serial").dist)


def test_submit_unregistered_graph_is_answered_graph_gone_at_tick():
    _, _, sched = _stack(None)
    q = sched.submit("ghost", 2)
    (a,) = sched.tick()
    assert a.query is q and a.status == "graph_gone"
    assert not a.ok and not a.exact and a.value is None


def test_evicted_graph_race_fails_typed_while_live_graph_serves():
    g0 = JC.random_csr_graph(120, 360, seed=1)
    g1 = JC.random_csr_graph(120, 360, seed=2)
    registry, _, sched = _stack(g0, name="g0")
    registry.register("g1", carry(g1))
    sched.submit("g0", 5)
    sched.submit("g1", 7)
    registry.evict("g0")
    answers = {a.query.graph: a for a in sched.tick()}
    assert answers["g0"].status == "graph_gone" and not answers["g0"].ok
    assert answers["g1"].status == "ok" and answers["g1"].exact
    assert np.array_equal(answers["g1"].value,
                          j_sp(g1, 7, engine="serial").dist)
    assert registry.evict("g0") is None


def test_expired_query_answered_deadline_exceeded_before_solving():
    cg = JC.random_csr_graph(60, 180, seed=3)
    _, _, sched = _stack(cg)
    sched.submit("g", 4, arrival=0.0, deadline=1.0)
    sched.submit("g", 9, arrival=0.0)
    by_src = {a.query.source: a for a in sched.tick(now=2.0)}
    assert by_src[4].status == "deadline_exceeded" and by_src[4].value is None
    assert by_src[9].ok
    assert np.array_equal(by_src[9].value, j_sp(cg, 9, engine="serial").dist)
    assert sched.stats()["deadline_expired"] == 1


def test_bounded_queue_rejects_p2p_and_sheds_for_full_rows():
    cg = JC.random_csr_graph(60, 180, seed=4)
    _, _, sched = _stack(cg, max_queue=2)
    sched.submit("g", 1, 2)
    sched.submit("g", 3, 4)
    with pytest.raises(QueryRejected):
        sched.submit("g", 5, 6)
    q = sched.submit("g", 7)
    assert sched.pending == 2
    answers = sched.drain()
    shed = [a for a in answers if a.status == "rejected"]
    assert len(shed) == 1 and shed[0].query.source == 3
    served = {a.query.source: a for a in answers if a.ok}
    assert set(served) == {1, 7} and served[7].query is q
    st = sched.stats()
    assert st["shed"] == 1 and st["submissions_rejected"] == 1


def test_p2p_degrades_to_landmark_bracket_under_pressure():
    cg = JC.sparse_csr_graph(200, seed=5)
    registry, _, sched = _stack(cg, landmarks=4, degrade_margin=0.5)
    ids = set(int(i) for i in registry.get("g").landmarks_ready().ids)
    src = next(v for v in range(cg.n) if v not in ids)
    tgt = next(v for v in range(cg.n - 1, -1, -1)
               if v not in ids and v != src)
    sched.submit("g", src, tgt, deadline=1.0)
    (a,) = sched.drain(now=0.8)
    assert a.via == "degraded" and a.status == "ok" and not a.exact
    lb, ub = a.bounds
    true = float(j_sp(cg, src, engine="serial").dist[tgt])
    assert lb <= true <= ub and a.value == ub
    assert sched.stats()["degraded_p2p"] == 1


def test_full_row_degrades_to_stale_version_under_pressure():
    jdyn = JDyn(JC.random_csr_graph(100, 300, seed=6), overlay_capacity=16)
    registry, cache, sched = _stack(jdyn, degrade_margin=0.5, repair_rows=0)
    dyn = registry.get("g").dyn
    sched.submit("g", 8)
    (fresh,) = sched.drain()
    v0_row = np.asarray(fresh.value).copy()
    us = np.asarray(dyn.base.indices)
    vs = np.asarray(dyn.base.dst_ids())
    u, v = next(
        (int(a), int(b)) for a, b in zip(us, vs)
        if np.isfinite(v0_row[a])
        and np.float32(v0_row[a] + dyn.weight_of(a, b)) == v0_row[b])
    registry.mutate("g", [("update", u, v,
                           float(dyn.weight_of(u, v)) + 50.0)])
    assert sched.rows_staled >= 1
    sched.submit("g", 8, deadline=1.0)
    (a,) = sched.drain(now=0.9)
    assert a.via == "degraded" and a.status == "ok" and not a.exact
    assert np.array_equal(a.value, v0_row)
    assert sched.stats()["degraded_batch"] == 1
    sched.submit("g", 8)
    (b,) = sched.drain()
    assert b.exact
    assert np.array_equal(b.value, shortest_paths(
        dyn.snapshot(), 8, engine="serial", device=CPU).dist)


def test_transient_fault_is_retried_to_a_bitwise_exact_answer():
    cg = JC.random_csr_graph(80, 240, seed=7)
    plan = FaultPlan(seed=1, rates={"solve": 1.0}, max_per_site=1)
    _, _, sched = _stack(cg, faults=plan, retry_budget=2)
    sched.submit("g", 6)
    (a,) = sched.drain()
    assert a.ok and a.exact
    assert np.array_equal(a.value, j_sp(cg, 6, engine="serial").dist)
    st = sched.stats()
    assert st["solve_exceptions"] == 1 and st["retries"] == 1
    assert plan.counts()["solve"] == 1


def test_persistent_fault_exhausts_retry_budget_to_solve_failed():
    cg = JC.random_csr_graph(80, 240, seed=8)
    plan = FaultPlan(seed=2, rates={"solve": 1.0})
    _, _, sched = _stack(cg, faults=plan, retry_budget=2)
    sched.submit("g", 6)
    (a,) = sched.drain()
    assert a.status == "solve_failed" and not a.ok and a.value is None
    assert a.query.attempts == 3
    assert sched.stats()["retries"] == 2


def test_stage_fault_is_retried_like_a_solve_fault():
    cg = JC.random_csr_graph(80, 240, seed=8)
    plan = FaultPlan(seed=2, rates={"stage": 1.0}, max_per_site=1)
    _, _, sched = _stack(cg, faults=plan, retry_budget=1)
    sched.submit("g", 6, 20)
    (a,) = sched.drain()
    assert a.ok and a.exact and plan.counts()["stage"] == 1
    assert np.float32(a.value) == j_sp(cg, 6, engine="serial").dist[20]


def test_clip_fault_surfaces_not_converged_and_caches_nothing():
    cg = JC.sparse_csr_graph(150, seed=9)
    plan = FaultPlan(seed=3, rates={"clip": 1.0}, clip_sweeps=1)
    _, cache, sched = _stack(cg, faults=plan)
    sched.submit("g", 0)
    sched.submit("g", 0, 140)
    answers = sched.drain()
    assert len(answers) == 2
    assert all(a.status == "not_converged" and not a.ok for a in answers)
    assert len(cache) == 0
    assert sched.stats()["not_converged"] == 2


def test_poisoned_mutation_batch_rolls_back_atomically():
    jdyn = JDyn(JC.random_csr_graph(90, 270, seed=10), overlay_capacity=16)
    plan = FaultPlan(seed=4, rates={"mutate": 1.0}, max_per_site=1)
    registry, _, sched = _stack(jdyn, faults=plan)
    dyn = registry.get("g").dyn
    u, v = int(dyn.base.indices[0]), int(dyn.base.dst_ids()[0])
    w0 = float(dyn.weight_of(u, v))
    sched.submit_mutation("g", "update", u, v, w0 + 5.0)
    acks = sched.tick()
    assert len(acks) == 1 and acks[0].status == "rejected"
    assert dyn.version == 0 and float(dyn.weight_of(u, v)) == w0
    sched.submit("g", 12)
    (a,) = sched.drain()
    assert a.exact
    assert np.array_equal(a.value, j_sp(jdyn.base, 12, engine="serial").dist)


def test_mutation_of_a_static_graph_is_rejected():
    cg = JC.random_csr_graph(40, 120, seed=1)
    registry, _, sched = _stack(cg)
    with pytest.raises(ValueError, match="static"):
        registry.mutate("g", [("add", 0, 1, 1.0)])
    with pytest.raises(KeyError):
        registry.mutate("nope", [])
    sched.submit_mutation("g", "add", 0, 39, 1.0)
    (ack,) = sched.tick()
    assert ack.status == "rejected" and sched.last_mutation_error


def test_drain_raises_stalled_instead_of_spinning_forever():
    cg = JC.random_csr_graph(40, 120, seed=11)
    _, _, sched = _stack(cg)
    sched._solve_batch = lambda handle, queries: []
    sched.submit("g", 2)
    with pytest.raises(SchedulerStalled):
        sched.drain()


def test_fault_plan_schedule_is_a_pure_function_of_seed():
    def mk(mod):
        return mod(seed=42, rates={"solve": 0.5, "clip": 0.3},
                   max_per_site=3)
    a, b, j = mk(FaultPlan), mk(FaultPlan), mk(JFaultPlan)
    sites = ("solve", "clip", "solve", "evict") * 20
    fires = [(a.roll(s), b.roll(s), j.roll(s)) for s in sites]
    assert all(x == y == z for x, y, z in fires)
    assert a.counts() == b.counts() == j.counts()
    assert a.counts()["solve"] <= 3
    assert a.probes["solve"] == b.probes["solve"] == 40
    assert a.summary() == j.summary()
    with pytest.raises(ValueError):
        FaultPlan(rates={"disk": 1.0})


def test_chaos_replay_statuses_are_deterministic():
    def once(jax):
        cg = JC.random_csr_graph(70, 210, seed=12)
        plan = (JFaultPlan if jax else FaultPlan)(
            seed=9, rates={"solve": 0.4, "clip": 0.4, "evict": 0.1},
            max_per_site=2)
        registry, _, sched = _stack(cg, faults=plan, retry_budget=1,
                                    jax=jax)
        for s in (3, 9, 3, 40, 41, 42):
            sched.submit("g", s)
        sched.submit("g", 5, 60)
        return ([(a.query.qid, a.status, a.exact) for a in sched.drain()],
                sched.snapshot())

    assert once(False) == once(False) == once(True)


def _path_graph(n):
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    return TC.csr_from_edge_list(n, edges, np.ones(n - 1))


@pytest.mark.parametrize("engine", ["bellman_csr", "frontier",
                                    "multisource_csr"])
def test_max_sweeps_cap_reports_not_converged(engine):
    tg = _path_graph(12)                          # needs ~11 sweeps from 0
    src = [0] if engine == "multisource_csr" else 0
    capped = shortest_paths(tg, src, engine=engine, max_sweeps=2, device=CPU)
    assert capped.converged is False and capped.sweeps == 2
    free = shortest_paths(tg, src, engine=engine, device=CPU)
    assert free.converged is True
    dist = free.dist[0] if engine == "multisource_csr" else free.dist
    assert np.array_equal(dist, np.arange(12, dtype=np.float32))
