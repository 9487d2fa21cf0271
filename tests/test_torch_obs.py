"""Port parity for the observability layer: repro_torch.obs and its serving
and facade integration (device="cpu") against repro.obs.

- metrics: the same series, qualification, kind errors and sorted
  snapshot as the JAX registry given the same operations;
- tracing: span nesting under an injected clock, Chrome and JSONL export
  equal to JAX's tracer's, and the disabled mode: a NullTracer run
  answers identically and records nothing;
- unification: every ``stats()`` count equals its ``snapshot()`` series;
- determinism: same-seed replays (also under a seeded FaultPlan) give
  equal snapshots, equal to the JAX scheduler's;
- the latency split of ``LatencyRecorder``;
- cost records: the facade shim emits schema-valid v2 records whose
  fields equal the JAX shim's, except ``backend`` / ``device_kind``
  ("cpu"), and the validate CLI accepts the port's files.

The JAX suite's two zero-retrace tests have no counterpart: eager PyTorch
traces nothing, so there is no retrace to count.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import obs as J
from repro.core import csr as JC
from repro.core.api import shortest_paths as j_sp
from repro.serve import DistanceCache as JCache
from repro.serve import FaultPlan as JFaultPlan
from repro.serve import GraphRegistry as JRegistry
from repro.serve import MicroBatchScheduler as JScheduler
from repro.serve import make_trace as j_make_trace
from repro_torch import obs as T
from repro_torch.core import csr as TC
from repro_torch.core.api import shortest_paths
from repro_torch.obs.validate import (reconstruct_answer_chains,
                                      validate_chrome_trace,
                                      validate_cost_records)
from repro_torch.serve import (DistanceCache, FaultPlan, GraphRegistry,
                               LatencyRecorder, MicroBatchScheduler,
                               make_trace)

ROOT = Path(__file__).resolve().parents[1]
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


def _stack(cg, *, landmarks=0, name="g", **kw):
    registry = GraphRegistry(device=CPU)
    cache = DistanceCache(capacity=64)
    sched = MicroBatchScheduler(registry, cache, max_batch=8, **kw)
    registry.register(name, carry(cg), landmarks=landmarks)
    return sched


def _jstack(cg, *, landmarks=0, name="g", **kw):
    registry = JRegistry()
    cache = JCache(capacity=64)
    sched = JScheduler(registry, cache, max_batch=8, **kw)
    registry.register(name, cg, landmarks=landmarks)
    return sched


def _replay(cg, *, seed=3, queries=24, landmarks=0, jax=False):
    sched = (_jstack if jax else _stack)(cg, landmarks=landmarks)
    trace = (j_make_trace if jax else make_trace)(
        "zipf", [("g", cg.n)], num_queries=queries, rate=1000.0, seed=seed,
        hot_seed=5)
    for e in trace:
        sched.submit("g", e.source, e.target, arrival=e.arrival)
    return sched, sched.drain(0.0)


# ---------------------------------------------------------------- metrics


def _exercise(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("hits")
    c.inc()
    c.inc(2)
    reg.gauge("rows", fn=lambda: 7)
    h = reg.histogram("lat")
    for v in (1.0, 2.0, 9.0):
        h.observe(v)
    reg.counter("answered", via="batch").inc(5)
    reg.counter("answered", via="cache").inc(1)
    return reg, c, h


def test_metrics_registry_series():
    reg, c, h = _exercise(T)
    assert reg.counter("hits") is c and c.value == 3
    assert h.count == 3 and h.min == 1.0 and h.max == 9.0
    assert h.percentile(50.0) == 2.0
    assert h.summary() == _exercise(J)[2].summary()
    snap = reg.snapshot()
    assert snap["answered{via=batch}"] == 5
    assert snap["answered{via=cache}"] == 1
    assert snap["hits"] == 3 and snap["rows"] == 7
    assert snap["lat.count"] == 3          # histogram: count only
    assert list(snap) == sorted(snap)
    assert snap == _exercise(J)[0].snapshot()
    with pytest.raises(TypeError):
        reg.gauge("hits")                  # kind mismatch
    reg.reset()
    assert reg.snapshot()["hits"] == 0 and reg.snapshot()["lat.count"] == 0


def test_retrace_api_is_kept_and_unused():
    # the port keeps JAX's retrace-counter API; no port code marks traces
    assert T.trace_count("probe_fn") == 0
    wrapped = T.count_traces("probe_fn")(lambda x: x + 1)
    assert wrapped(1) == 2 and T.trace_count("probe_fn") == 1
    names = {dict(s.labels).get("fn")
             for s in T.default_registry().find("jit.retrace")}
    assert names <= {"probe_fn"}


# ---------------------------------------------------------------- tracing


def _clock():
    t = [0.0]

    def clock():
        t[0] += 1.0
        return t[0]
    return clock


def _nested(mod):
    tr = mod.Tracer(clock=_clock())
    with tr.span("tick", tick=1) as sp:          # t0=1
        with tr.span("batch_solve", qids=(7,)):  # t0=2, t1=3
            pass
        tr.instant("answer", qid=7, via="batch", status="ok", exact=True)
        sp.set(answers=1)
    return tr


def test_span_nesting_under_injected_clock(tmp_path):
    tr = _nested(T)
    inner, outer = tr.spans
    assert (inner.name, outer.name) == ("batch_solve", "tick")
    assert inner.depth == 1 and outer.depth == 0
    assert (inner.t0, inner.t1) == (2.0, 3.0)
    assert (outer.t0, outer.t1) == (1.0, 5.0)
    assert outer.args == {"tick": 1, "answers": 1}
    doc = tr.to_chrome()
    assert validate_chrome_trace(doc) == []
    ts = [e["ts"] for e in doc["traceEvents"]]
    assert ts == sorted(ts)
    # both exports equal the JAX tracer's for the same spans
    jt = _nested(J)
    assert doc == jt.to_chrome()
    tr.write_jsonl(tmp_path / "t.jsonl")
    jt.write_jsonl(tmp_path / "j.jsonl")
    assert ((tmp_path / "t.jsonl").read_text()
            == (tmp_path / "j.jsonl").read_text())


@pytest.mark.parametrize("doc", [
    {},
    {"traceEvents": [{"ph": "X", "name": "tick", "ts": 1.0, "pid": 1,
                      "tid": 1}]},                       # no dur
    {"traceEvents": [{"ph": "?", "name": "x", "ts": 0.0, "pid": 1,
                      "tid": 1}]},                       # unknown ph
    {"traceEvents": [{"ph": "X", "name": 3, "ts": "0", "dur": -1.0,
                      "pid": 1, "tid": 1, "args": []}]},
])
def test_chrome_schema_rejects_malformed_like_jax(doc):
    from repro.obs.validate import validate_chrome_trace as j_validate

    errs = validate_chrome_trace(doc)
    assert errs and errs == j_validate(doc)


def test_disabled_tracing_is_noop_and_answers_identical():
    cg = JC.random_csr_graph(96, 288, seed=1)
    _, base = _replay(cg)                       # NULL_TRACER default
    assert T.get_tracer() is T.NULL_TRACER
    tr = T.Tracer()
    prev = T.set_tracer(tr)
    try:
        _, traced = _replay(cg)
    finally:
        T.set_tracer(prev)
    assert len(base) == len(traced) and len(tr.spans) > 0
    for a, b in zip(base, traced):
        assert a.query.qid == b.query.qid and a.via == b.via
        assert np.array_equal(np.asarray(a.value), np.asarray(b.value))
    # the disabled side really recorded nothing
    _, again = _replay(cg)
    assert len(again) == len(base)
    assert T.NULL_TRACER.spans == [] and T.NULL_TRACER.instants == []


def test_answer_chains_reconstruct_from_traced_replay():
    cg = JC.random_csr_graph(96, 288, seed=1)
    tr = T.Tracer()
    prev = T.set_tracer(tr)
    try:
        _replay(cg)
    finally:
        T.set_tracer(prev)
    doc = tr.to_chrome()
    assert validate_chrome_trace(doc) == []
    assert reconstruct_answer_chains(doc) == []
    # drop the submit instants: every exact engine answer must now fail
    doc["traceEvents"] = [e for e in doc["traceEvents"]
                          if e.get("name") != "submit"]
    errs = reconstruct_answer_chains(doc)
    assert errs and all("no submit instant" in e for e in errs)


def test_traced_replay_spans_match_jax():
    """The same replay traced on both sides: the same span names in the
    same order, and the same solve-span payloads apart from the
    wall-clock fields (cost records are compared in the test below)."""
    cg = JC.random_csr_graph(96, 288, seed=2)
    docs = []
    for mod, jax in ((T, False), (J, True)):
        tr = mod.Tracer(clock=_clock())
        prev = mod.set_tracer(tr)
        try:
            _replay(cg, landmarks=3, jax=jax)
        finally:
            mod.set_tracer(prev)
        docs.append(tr.to_chrome())
    assert docs[0] == docs[1]


# ------------------------------------------------------------ unification


def test_stats_unification_nothing_lost():
    cg = JC.random_csr_graph(96, 288, seed=2)
    sched, answers = _replay(cg, landmarks=4)
    assert answers
    snap = sched.snapshot()
    s = sched.stats()
    for key in ("ticks", "engine_batches", "engine_sources",
                "target_solves", "dedup_saved", "rows_kept",
                "rows_repaired", "rows_invalidated", "rows_staled",
                "repair_edges", "submissions_rejected", "shed",
                "deadline_expired", "degraded_p2p", "degraded_batch",
                "solve_exceptions", "retries", "not_converged",
                "sharded_batches", "sharded_p2p", "sharded_sources",
                "sharded_edges"):
        assert snap[f"sched.{key}"] == s[key], key
    for via, count in s["answered_via"].items():
        assert snap.get(f"sched.answered{{via={via}}}", 0) == count, via
    c = s["cache"]
    assert snap["cache.hits"] == c["hits"]
    assert snap["cache.misses"] == c["misses"]
    assert snap["cache.evictions"] == c["evictions"]
    assert snap["cache.rows"] == c["rows"]
    r = s["registry"]
    assert snap["registry.graphs"] == r["graphs"]
    assert snap["registry.registered"] == r["registered"]
    assert snap["registry.evicted"] == r["evicted"]
    assert snap["registry.mutations"] == r["mutations"]
    assert snap["registry.edges_mutated"] == r["edges_mutated"]
    # legacy attribute reads still resolve
    assert sched.ticks == s["ticks"]
    assert sched.dedup_saved == s["dedup_saved"]
    assert sched.cache.hits == c["hits"]
    assert sched.registry.registered == r["registered"]


def test_snapshot_deterministic_under_seeded_replay():
    cg = JC.random_csr_graph(96, 288, seed=4)
    s1, _ = _replay(cg, seed=9)
    s2, _ = _replay(cg, seed=9)
    assert s1.snapshot() == s2.snapshot()
    j, _ = _replay(cg, seed=9, jax=True)
    assert s1.snapshot() == j.snapshot()


def test_snapshot_deterministic_under_seeded_chaos():
    cg = JC.random_csr_graph(96, 288, seed=4)
    snaps = []
    for jax in (False, False, True):
        plan = (JFaultPlan if jax else FaultPlan)(
            seed=11, rates={"solve": 0.3, "clip": 0.2})
        sched = (_jstack if jax else _stack)(cg, faults=plan,
                                             retry_budget=2)
        trace = make_trace("zipf", [("g", cg.n)], num_queries=24,
                           rate=1000.0, seed=9, hot_seed=5)
        for e in trace:
            sched.submit("g", e.source, e.target, arrival=e.arrival)
        sched.drain(0.0)
        snaps.append(sched.snapshot())
    assert snaps[0] == snaps[1] == snaps[2]


# ---------------------------------------------------------- latency split


def test_latency_recorder_splits_queue_and_service():
    cg = JC.random_csr_graph(64, 192, seed=7)
    sched = _stack(cg)
    sched.submit("g", 0, arrival=0.0)
    sched.submit("g", 1, arrival=0.5)
    answers = sched.drain(2.0)                  # served at now=2.0
    rec = LatencyRecorder()
    for a in answers:
        assert a.service_start == 2.0
        a.done_at = 3.0
        rec.observe(a, a.done_at)
    lat = rec.summary()
    assert lat["queue_p99_ms"] == pytest.approx(1995.0)
    assert lat["queue_p50_ms"] == pytest.approx(1750.0)
    assert lat["service_p50_ms"] == pytest.approx(1000.0)
    assert lat["service_p99_ms"] == pytest.approx(1000.0)
    assert lat["p99_ms"] == pytest.approx(2995.0)
    assert LatencyRecorder().summary() == {"queries": 0}


# ----------------------------------------------------------- cost records


COMPARED = ("engine", "graph", "n", "m", "batch", "nprocs", "delta",
            "sweeps", "edges_relaxed", "converged")


def _records(mod, solve):
    cl = mod.CostLog()
    prev = mod.set_cost_log(cl)
    try:
        res = solve()
    finally:
        mod.set_cost_log(prev)
    return cl.records, res


@pytest.mark.parametrize("engine,kw", [
    ("frontier", {}),
    ("frontier", {"target": 40}),
    ("delta_stepping", {}),
    ("delta_stepping", {"delta": 30.0}),
    ("bellman_csr", {}),
    ("multisource_csr", {"source": [0, 5, 9]}),
    ("auto", {}),
    ("auto", {"source": [1, 2]}),
    ("serial", {}),
])
def test_api_shim_emits_schema_valid_cost_records(engine, kw):
    cg = JC.random_csr_graph(64, 192, seed=8)
    tg = carry(cg)
    src = kw.pop("source", 0)
    recs, res = _records(T, lambda: shortest_paths(tg, src, engine=engine,
                                                   device=CPU, **kw))
    jrecs, jres = _records(J, lambda: j_sp(cg, src, engine=engine, **kw))
    assert len(recs) == len(jrecs) == 1
    r, jr = recs[0].to_dict(), jrecs[0].to_dict()
    assert {k: r[k] for k in COMPARED} == {k: jr[k] for k in COMPARED}
    assert (r["backend"], r["device_kind"]) == ("cpu", "cpu")
    assert r["wall_ms"] > 0 and r["n"] == cg.n
    assert validate_cost_records([r]) == []
    assert res.dist.tobytes() == np.asarray(jres.dist).tobytes()
    # disabled log: nothing recorded, result identical
    again = shortest_paths(tg, src, engine=engine, device=CPU, **kw)
    assert again.dist.tobytes() == res.dist.tobytes()


def test_solve_span_and_cost_record_name_the_device():
    tg = TC.sparse_csr_graph(80)
    tr, cl = T.Tracer(), T.CostLog()
    prev_t, prev_c = T.set_tracer(tr), T.set_cost_log(cl)
    try:
        shortest_paths(tg, 0, engine="frontier", device=CPU)
    finally:
        T.set_tracer(prev_t)
        T.set_cost_log(prev_c)
    (span,) = tr.spans
    assert span.name == "solve" and span.args["engine"] == "frontier"
    assert span.args["edges_relaxed"] == cl.records[0].edges_relaxed
    assert T.backend_info(CPU) == ("cpu", "cpu")
    assert T.backend_info(torch.device("cpu")) == ("cpu", "cpu")
    with pytest.raises(ValueError, match="backend"):
        T.CostLog().emit(engine="frontier", n=1, m=0, sweeps=0,
                         edges_relaxed=0, wall_ms=0.0, converged=True)
    T.NULL_COST_LOG.emit(engine="frontier")       # the null log drops it
    assert T.NULL_COST_LOG.records == []


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def test_validate_cli_accepts_the_ports_trace_and_cost_files(tmp_path):
    cg = JC.random_csr_graph(96, 288, seed=5)
    tr, cl = T.install_capture()
    try:
        _replay(cg, landmarks=3)
        shortest_paths(carry(cg), 0, engine="frontier", device=CPU)
    finally:
        T.set_tracer(None)
        T.set_cost_log(None)
    path = str(tmp_path / "serve.json")
    assert T.finalize_capture(tr, cl, path) == []
    cost = T.cost_path_for(path)
    rows = [json.loads(line) for line in Path(cost).read_text().splitlines()]
    assert rows and all(r["backend"] == "cpu" for r in rows)
    assert {r["engine"] for r in rows} >= {"multisource_csr", "frontier"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.validate", path, cost],
        env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout
    # a trace without answers fails the chain check
    bare = tmp_path / "bare.json"
    T.Tracer().write_chrome(str(bare))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.validate", str(bare)],
        env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 1 and "no answer instants" in out.stderr
