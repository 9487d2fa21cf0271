"""Port parity for self-tuning: repro_torch.tune (device="cpu") against
repro.tune on the same records, graphs and policies.

The counterparts of tests/test_tune.py's contracts hold on the port —
deterministic fits, conservative fallback, statics plumbing through the
scheduler, the one-sided replay gate, the policy seam, v2 cost records and
the calibration sweep — and on top:

- the port's ``CostModel.to_json()`` is byte-identical to JAX's, from
  synthetic records and from the committed ``CALIBRATION.json`` (both
  through ``fit_model`` and ``load_model``);
- ``graph_features`` is equal on sparse, road and hub graphs carried
  across with ``from_arrays``;
- ``TunedPolicy(device="cpu")`` returns JAX's ``EngineChoice`` (engine,
  Δ, batch cap, via) for the same model on a grid of graphs;
- a CUDA policy, built with a stubbed device count, races the kernel
  twins and keeps the measured Δ for ``delta_stepping_kernel``; a model
  measured on another backend is refused;
- ``replay_records`` gives JAX's verdict on the same records.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import csr as JC
from repro.core.api import shortest_paths as j_sp
from repro.dynamic import DynamicGraph as JDyn
from repro.tune import TunedPolicy as JTuned
from repro.tune import fit_model as j_fit_model
from repro.tune import graph_features as j_graph_features
from repro.tune import replay_records as j_replay_records
from repro.tune.model import load_model as j_load_model
from repro_torch.core import csr as TC
from repro_torch.core.api import shortest_paths
from repro_torch.dynamic import DynamicGraph
from repro_torch.obs import CostLog, set_cost_log
from repro_torch.obs.validate import validate_cost_records
from repro_torch.serve import (DistanceCache, GraphRegistry,
                               MicroBatchScheduler)
from repro_torch.serve.dispatch import (DispatchPolicy, EngineChoice,
                                        default_policy, policy_override,
                                        set_default_policy)
from repro_torch.tune import (TunedPolicy, fit_model, graph_features,
                              load_model, replay_records)
from repro_torch.tune.model import CostModel

ROOT = Path(__file__).resolve().parents[1]
CALIBRATION = str(ROOT / "CALIBRATION.json")
CPU = "cpu"
META_CPU = {"backend": "cpu"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def carry(cg):
    return TC.from_arrays(cg.indptr, cg.indices, cg.weights, cg.n,
                          cg.directed)


# ---------------------------------------------------------------------------
# synthetic calibration records (tests/test_tune.py's): noiseless power laws
# the fit recovers exactly, with delta_stepping the cheapest engine
# ---------------------------------------------------------------------------

def _rec(engine, n, m, wall_ms, *, batch=1, nprocs=1, delta=0.0,
         corpus="sparse", hops=10.0, skew=2.0, converged=True,
         delta_kind=None, backend="cpu"):
    r = {"engine": engine, "graph": "t", "n": n, "m": m, "batch": batch,
         "nprocs": nprocs, "delta": delta, "sweeps": 3,
         "edges_relaxed": m, "wall_ms": wall_ms, "converged": converged,
         "corpus": corpus, "hops": hops, "skew": skew,
         "backend": backend, "device_kind": backend}
    if delta_kind:
        r["delta_kind"] = delta_kind
    return r


TWINS = {"frontier": "frontier_kernel", "bellman_csr": "bellman_csr_kernel",
         "delta_stepping": "delta_stepping_kernel"}


def _synthetic_records(twins=False, backend="cpu"):
    """Grid n in {256..2048}, m = 3n: frontier ~ n/100 ms, bellman ~
    n/50 ms, delta_stepping ~ n/1000 ms with two Δ candidates per point
    (Δ=8 measured better than Δ=4); ``twins`` names the kernel twins, as
    a calibration on the card does."""
    name = (lambda e: TWINS.get(e, e)) if twins else (lambda e: e)
    recs = []
    for n in (256, 512, 1024, 2048):
        m = 3 * n
        recs.append(_rec(name("frontier"), n, m, n / 100.0,
                         backend=backend))
        recs.append(_rec(name("bellman_csr"), n, m, n / 50.0,
                         backend=backend))
        recs.append(_rec(name("delta_stepping"), n, m, n / 500.0, delta=4.0,
                         delta_kind="auto", backend=backend))
        recs.append(_rec(name("delta_stepping"), n, m, n / 1000.0, delta=8.0,
                         delta_kind="alt", backend=backend))
        for b in (2, 4):
            recs.append(_rec("multisource_csr", n, m, b * n / 150.0,
                             batch=b, backend=backend))
    return recs


@pytest.fixture()
def model():
    return fit_model(_synthetic_records(), seed=0, meta=META_CPU)


# ---------------------------------------------------------------------------
# model fitting: the JAX contracts, and the copy's JSON byte for byte
# ---------------------------------------------------------------------------

def test_fit_deterministic_under_fixed_seed_and_equal_to_jax():
    recs = _synthetic_records()
    a = fit_model(recs, seed=0, meta={"k": 1})
    b = fit_model(list(recs), seed=0, meta={"k": 1})
    assert a.to_json() == b.to_json()
    assert CostModel.from_json(a.to_json()).to_json() == a.to_json()
    assert a.to_json() == j_fit_model(recs, seed=0, meta={"k": 1}).to_json()


def test_fit_from_committed_calibration_is_byte_identical_to_jax():
    with open(CALIBRATION) as f:
        doc = json.load(f)
    recs = doc["records"]
    for seed in (0, 3):
        assert (fit_model(recs, seed=seed).to_json()
                == j_fit_model(recs, seed=seed).to_json())
    assert (load_model(CALIBRATION).to_json()
            == j_load_model(CALIBRATION).to_json())


def test_fit_recovers_power_law_and_statics(model):
    fit = model.fit_for("frontier", 1)
    assert fit is not None and fit.rms_log_err < 1e-6
    assert model.predict("frontier", n=1024, m=3072) == pytest.approx(
        1024 / 100.0, rel=1e-3)
    assert model.predict("delta_stepping", n=1024, m=3072) \
        == pytest.approx(1024 / 1000.0, rel=1e-3)
    assert model.best_delta("delta_stepping", n=1024, m=3072) == 8.0
    assert model.best_batch(n=1024, m=3072) in (2, 4)


def test_best_delta_keeps_auto_width_within_noise():
    recs = []
    for n in (256, 512, 1024):
        m = 3 * n
        recs.append(_rec("delta_stepping", n, m, 10.0, delta=4.0,
                         delta_kind="auto"))
        recs.append(_rec("delta_stepping", n, m, 9.5, delta=8.0,
                         delta_kind="alt"))
    mdl = fit_model(recs, seed=0)
    assert mdl.best_delta("delta_stepping", n=512, m=1536) == 4.0
    assert mdl.to_json() == j_fit_model(recs, seed=0).to_json()


def test_fit_skips_thin_groups_and_bad_records():
    recs = [_rec("frontier", 256, 768, 1.0),
            _rec("frontier", 512, 1536, 2.0),  # only 2 points: skipped
            _rec("weird", 256, 768, 1.0, converged=False),
            _rec("weird", 256, 768, 0.0)]      # zero wall: dropped
    m = fit_model(recs, seed=0)
    assert m.fit_for("frontier", 1) is None
    assert m.fit_for("weird", 1) is None
    assert m.meta["dropped_records"] == 2
    assert any(s.startswith("frontier@P1") for s in m.meta["skipped_groups"])
    assert m.to_json() == j_fit_model(recs, seed=0).to_json()


# ---------------------------------------------------------------------------
# features
# ---------------------------------------------------------------------------

def test_graph_features_memoized_and_sane():
    cg = TC.random_csr_graph(256, 768, seed=11)
    f1 = graph_features(cg)
    assert f1["n"] == 256 and f1["m"] == cg.nnz
    assert f1["hops"] >= 1 and f1["skew"] >= 1.0
    assert graph_features(cg) is f1             # memoized on the graph


@pytest.mark.parametrize("corpus", ["sparse", "road", "hub"])
def test_graph_features_equal_jax(corpus):
    make = {"sparse": lambda: JC.random_csr_graph(2000, 6000, seed=5),
            "road": lambda: JC.road_like_csr_graph(2500, seed=2),
            "hub": lambda: JC.skewed_hub_csr_graph(2000, seed=4)}[corpus]
    jg = make()
    assert graph_features(carry(jg)) == j_graph_features(jg)


# ---------------------------------------------------------------------------
# TunedPolicy: JAX's choices on the CPU, the twins on CUDA
# ---------------------------------------------------------------------------

def _choice(c):
    return (c.engine, c.nprocs, c.delta, c.batch_cap, c.via)


def test_tuned_policy_routes_by_model_inside_support(model):
    jcg = JC.random_csr_graph(1024, 3072, seed=7)
    cg = carry(jcg)
    pol = TunedPolicy(model, nprocs=1, device=CPU)
    base = DispatchPolicy(nprocs=1, device=CPU).choose(cg, kind="single")
    choice = pol.choose(cg, kind="single")
    assert base.engine == "frontier" and base.via == "threshold"
    assert choice.engine == "delta_stepping" and choice.via == "model"
    assert choice.delta == 8.0          # measured-best static rides along
    assert pol.model_routed == 1 and pol.fallback_routed == 0
    jchoice = JTuned(model, nprocs=1).choose(jcg, kind="single")
    assert _choice(choice) == _choice(jchoice)
    with policy_override(pol):
        tuned = shortest_paths(cg, 0, engine="auto", device=CPU)
    assert tuned.engine == "delta_stepping"
    serial = j_sp(jcg, 0, engine="serial")
    assert tuned.dist.tobytes() == np.asarray(serial.dist).tobytes()


def test_tuned_policy_falls_back_outside_support(model):
    pol = TunedPolicy(model, nprocs=1, device=CPU)
    tiny = TC.random_csr_graph(50, 150, seed=3)      # n << support/margin
    choice = pol.choose(tiny, kind="single")
    assert choice.via == "threshold" and choice.engine == "frontier"
    assert pol.fallback_routed == 1 and pol.model_routed == 0
    huge = TC.random_csr_graph(8192, 24576, seed=4)  # above support * 2
    assert pol.choose(huge, kind="single").via == "threshold"


def test_tuned_policy_dynamic_graph_falls_back(model):
    dyn = DynamicGraph(TC.random_csr_graph(1024, 3072, seed=9))
    pol = TunedPolicy(model, nprocs=1, device=CPU)
    assert pol.choose(dyn, kind="single").via == "threshold"
    jdyn = JDyn(JC.random_csr_graph(1024, 3072, seed=9))
    assert _choice(pol.choose(dyn, kind="batch")) == _choice(
        JTuned(model, nprocs=1).choose(jdyn, kind="batch"))


def _policy_graphs():
    return {
        "sparse-1024": lambda: JC.random_csr_graph(1024, 3072, seed=7),
        "sparse-5000": lambda: JC.random_csr_graph(5000, 15000, seed=2),
        "sparse-12000": lambda: JC.random_csr_graph(12000, 36000, seed=1),
        "road-10000": lambda: JC.road_like_csr_graph(10000, seed=3),
        "hub-4096": lambda: JC.skewed_hub_csr_graph(4096, seed=6),
        "hub-20000": lambda: JC.skewed_hub_csr_graph(20000, seed=8),
        "tiny": lambda: JC.random_csr_graph(50, 150, seed=3),
    }


@pytest.mark.parametrize("source", ["synthetic", "committed"])
@pytest.mark.parametrize("kind", ["single", "batch", "p2p"])
def test_tuned_policy_cpu_choices_equal_jax(source, kind):
    """Same model, same graphs: the port's CPU TunedPolicy and JAX's
    return the same engine, Δ, batch cap and arm, and count the same."""
    mdl = (load_model(CALIBRATION) if source == "committed"
           else fit_model(_synthetic_records(), seed=0, meta=META_CPU))
    pol = TunedPolicy(mdl, nprocs=1, device=CPU)
    jpol = JTuned(mdl, nprocs=1)
    for name, make in _policy_graphs().items():
        jcg = make()
        assert _choice(pol.choose(carry(jcg), kind=kind)) == _choice(
            jpol.choose(jcg, kind=kind)), name
    assert (pol.model_routed, pol.fallback_routed) == (
        jpol.model_routed, jpol.fallback_routed)
    if source == "committed" and kind == "single":
        assert pol.model_routed >= 1


def _fake_gpus(monkeypatch, count):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)


def test_cuda_tuned_policy_races_the_twins_and_keeps_delta(monkeypatch):
    """A card's calibration names the twins; the CUDA policy races them
    and hands the measured-best Δ to delta_stepping_kernel (the plain
    name's filter and Δ rule must hold for the twin).  Stubbed device
    count: no tensor is made."""
    _fake_gpus(monkeypatch, 1)
    gpu = fit_model(_synthetic_records(twins=True, backend="gpu"), seed=0,
                    meta={"backend": "gpu"})
    pol = TunedPolicy(gpu, device="cuda")
    assert pol.nprocs == 1
    cg = TC.random_csr_graph(1024, 3072, seed=7)
    base = DispatchPolicy(device="cuda").choose(cg, kind="single")
    choice = pol.choose(cg, kind="single")
    assert base.engine == "frontier_kernel"
    assert choice.engine == "delta_stepping_kernel" and choice.via == "model"
    assert choice.delta == 8.0
    # the same model with the plain names: the same choice, plain engine
    cpu_choice = TunedPolicy(model=fit_model(
        _synthetic_records(), seed=0, meta=META_CPU), device=CPU).choose(
            cg, kind="single")
    assert (cpu_choice.engine, cpu_choice.delta) == ("delta_stepping", 8.0)
    assert pol.choose(cg, kind="p2p").engine == "frontier_kernel"
    batch = pol.choose(cg, kind="batch")
    assert batch.engine == "multisource_csr" and batch.batch_cap in (2, 4)
    # a graph whose weights keep Δ-stepping off the candidates
    hub = TC.skewed_hub_csr_graph(1024, seed=1)
    from repro_torch.core.delta_stepping import delta_profile
    if not delta_profile(hub)["routable"]:
        assert pol.choose(hub, kind="single").engine != \
            "delta_stepping_kernel"


@pytest.mark.parametrize("device,meta", [
    ("cuda", {"backend": "cpu"}), ("cpu", {"backend": "gpu"}),
    ("cpu", {}), ("cuda", {})])
def test_tuned_policy_refuses_a_model_of_another_backend(monkeypatch,
                                                         device, meta):
    _fake_gpus(monkeypatch, 1)
    mdl = fit_model(_synthetic_records(), seed=0, meta=meta)
    with pytest.raises(ValueError, match="backend"):
        TunedPolicy(mdl, device=device)


def test_tuned_policy_refuses_the_committed_cpu_calibration_on_cuda(
        monkeypatch):
    _fake_gpus(monkeypatch, 1)
    with pytest.raises(ValueError, match="'cpu'"):
        TunedPolicy(load_model(CALIBRATION), device="cuda")


# ---------------------------------------------------------------------------
# statics plumbing through the scheduler
# ---------------------------------------------------------------------------

class _StaticsPolicy(DispatchPolicy):
    """Threshold policy that pins statics, standing in for a model."""

    def batch_cap(self, g):
        return 2

    def choose(self, g, *, kind="single"):
        base = super().choose(g, kind=kind)
        if kind == "p2p" and base.nprocs == 1:
            return EngineChoice(base.engine, None, base.axis, 1,
                                delta=7.5, chunk=128, via="model")
        return base


def _stack(cg, policy, *, max_batch=8):
    registry = GraphRegistry(device=CPU)
    sched = MicroBatchScheduler(registry, DistanceCache(capacity=64),
                                max_batch=max_batch, dispatch=policy)
    registry.register("g", cg)
    return sched


def test_scheduler_admission_respects_policy_batch_cap():
    jcg = JC.random_csr_graph(256, 768, seed=5)
    sched = _stack(carry(jcg), _StaticsPolicy(nprocs=1, device=CPU))
    for s in (3, 9, 17, 33, 57):
        sched.submit("g", s)
    first = sched.tick()
    assert len(first) == 2              # cap=2 < max_batch=8 throttles
    rest = []
    for _ in range(3):
        rest += sched.tick()
    assert len(first) + len(rest) == 5  # requeued queries drain
    ref = j_sp(jcg, 3, engine="serial").dist
    got = next(a for a in first + rest if a.query.source == 3)
    assert np.asarray(got.value).tobytes() == np.asarray(ref).tobytes()


def test_scheduler_p2p_uses_choice_statics(monkeypatch):
    import repro_torch.serve.scheduler as sched_mod

    seen = {}
    real = sched_mod.sssp_frontier

    def spy(*args, **kwargs):
        seen.update(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(sched_mod, "sssp_frontier", spy)
    jcg = JC.random_csr_graph(256, 768, seed=5)
    sched = _stack(carry(jcg), _StaticsPolicy(nprocs=1, device=CPU))
    sched.submit("g", 3, 77)
    (ans,) = sched.tick()
    # the port's frontier engine has no scatter chunk: Δ alone reaches it
    assert seen.get("delta") == 7.5 and "chunk" not in seen
    ref = j_sp(jcg, 3, engine="serial").dist[77]
    assert np.float32(ans.value) == np.float32(ref)


# ---------------------------------------------------------------------------
# replay gate: the JAX contracts and JAX's verdict on the same records
# ---------------------------------------------------------------------------

def test_replay_clean_log_passes(model):
    rep = replay_records(_synthetic_records(), model, tol=1.5)
    assert rep["pass"] and rep["replayed"] > 0 and not rep["failures"]


def test_replay_fails_on_perturbed_log(model):
    slow = [dict(r, wall_ms=r["wall_ms"] * 10) for r in _synthetic_records()]
    rep = replay_records(slow, model, tol=3.0)
    assert not rep["pass"]
    assert any(k.startswith("frontier@P1") for k in rep["failures"])


def test_replay_one_sided_by_default(model):
    fast = [dict(r, wall_ms=r["wall_ms"] / 10)
            for r in _synthetic_records()]
    assert replay_records(fast, model, tol=3.0)["pass"]
    assert not replay_records(fast, model, tol=3.0, two_sided=True)["pass"]


def test_replay_skips_uncovered_records_with_reasons(model):
    recs = [_rec("frontier", 10 ** 6, 3 * 10 ** 6, 1.0),   # out of support
            _rec("repair", 512, 1536, 1.0),                # unfitted
            _rec("frontier", 512, 1536, 1.0, converged=False)]
    rep = replay_records(recs, model, tol=3.0)
    assert rep["replayed"] == 0 and not rep["pass"]
    assert rep["skipped"]["out_of_support:frontier@P1"] == 1
    assert rep["skipped"]["unfitted:repair@P1"] == 1
    assert rep["skipped"]["not_converged"] == 1


def test_replay_refuses_backend_mismatch(model):
    recs = [dict(r, backend="gpu") for r in _synthetic_records()]
    rep = replay_records(recs, model, tol=3.0, expect_backend="cpu")
    assert rep["backend_mismatch"] == len(recs) and not rep["pass"]


@pytest.mark.parametrize("case", ["clean", "slow", "fast_two_sided",
                                  "uncovered", "backend", "committed"])
def test_replay_verdict_equals_jax(model, case):
    recs = _synthetic_records()
    kw = {"tol": 3.0}
    mdl = model
    if case == "slow":
        recs = [dict(r, wall_ms=r["wall_ms"] * 10) for r in recs]
    elif case == "fast_two_sided":
        recs = [dict(r, wall_ms=r["wall_ms"] / 10) for r in recs]
        kw["two_sided"] = True
    elif case == "uncovered":
        recs = recs[:2] + [_rec("frontier", 10 ** 6, 3 * 10 ** 6, 1.0),
                           _rec("repair", 512, 1536, 1.0)]
        kw["min_records"] = 1
    elif case == "backend":
        recs = recs[:5] + [dict(r, backend="gpu") for r in recs[5:]]
        kw["expect_backend"] = "cpu"
    elif case == "committed":
        with open(CALIBRATION) as f:
            recs = json.load(f)["records"]
        mdl = load_model(CALIBRATION)
        kw = {"tol": 1.5, "expect_backend": "cpu"}
    assert replay_records(recs, mdl, **kw) == j_replay_records(recs, mdl,
                                                               **kw)


def test_replay_cli_exit_codes(tmp_path, model):
    from repro_torch.tune.replay import main

    costs = tmp_path / "costs.jsonl"
    costs.write_text("".join(json.dumps(r) + "\n" for r in
                             json.load(open(CALIBRATION))["records"]))
    assert main([str(costs), "--calibration", CALIBRATION]) == 0
    slow = tmp_path / "slow.jsonl"
    slow.write_text("".join(
        json.dumps(dict(r, wall_ms=r["wall_ms"] * 50)) + "\n"
        for r in json.load(open(CALIBRATION))["records"]))
    assert main([str(slow), "--calibration", CALIBRATION]) == 1
    gpu = tmp_path / "gpu.jsonl"
    gpu.write_text("".join(
        json.dumps(dict(r, backend="gpu")) + "\n"
        for r in json.load(open(CALIBRATION))["records"]))
    assert main([str(gpu), "--calibration", CALIBRATION]) == 1
    assert main([str(gpu), "--calibration", CALIBRATION,
                 "--allow-backend-mismatch"]) == 0


# ---------------------------------------------------------------------------
# policy seam + v2 records + calibration
# ---------------------------------------------------------------------------

def test_set_default_policy_returns_previous_and_override_restores():
    p1 = DispatchPolicy(nprocs=1, device=CPU)
    p2 = DispatchPolicy(nprocs=1, device=CPU)
    prev0 = set_default_policy(p1)
    try:
        assert default_policy() is p1
        with policy_override(p2) as installed:
            assert installed is p2 and default_policy() is p2
        assert default_policy() is p1
        with pytest.raises(RuntimeError):
            with policy_override(p2):
                assert default_policy() is p2
                raise RuntimeError("boom")
        assert default_policy() is p1           # restored on exception
        assert set_default_policy(None) is p1   # returns the previous
    finally:
        set_default_policy(prev0)


def test_cost_records_v2_backend_stamped_and_v1_still_valid():
    cg = TC.random_csr_graph(64, 192, seed=1)
    log = CostLog()
    prev = set_cost_log(log)
    try:
        shortest_paths(cg, 0, engine="frontier", device=CPU)
    finally:
        set_cost_log(prev)
    rows = [r.to_dict() for r in log.records]
    assert rows and (rows[0]["backend"], rows[0]["device_kind"]) == (
        "cpu", "cpu")
    assert validate_cost_records(rows) == []
    v1 = [{k: v for k, v in r.items()
           if k not in ("backend", "device_kind")} for r in rows]
    assert validate_cost_records(v1) == []
    assert validate_cost_records([dict(rows[0], backend=123)]) != []


def test_micro_calibration_sweep_fits_end_to_end():
    from repro_torch.tune.calibrate import sweep

    records = sweep((("sparse", 64, 192), ("road", 64, None)), repeats=1,
                    smoke=True, batches=(2,), verbose=False, device=CPU)
    assert records and validate_cost_records(records) == []
    assert {r["engine"] for r in records} == {
        "frontier", "bellman_csr", "delta_stepping", "multisource_csr"}
    assert all(r["backend"] == "cpu" and r["hops"] >= 1 for r in records)
    m = fit_model(records, min_records=1)
    assert m.engines()
    for eng, p in m.engines():
        assert m.predict(eng, n=64, m=192, nprocs=p) > 0


def test_calibration_file_stamped_and_fits_a_cpu_policy(tmp_path,
                                                        monkeypatch):
    from repro_torch.tune import calibrate

    monkeypatch.setattr(calibrate, "SMOKE_GRID", calibrate.SMOKE_GRID[:4])
    out = calibrate.run(smoke=True, repeats=1, out=str(tmp_path / "c.json"),
                        verbose=False, device=CPU)
    doc = json.load(open(out))
    meta = doc["meta"]
    assert (meta["backend"], meta["device_kind"], meta["smoke"]) == (
        "cpu", "cpu", True)
    assert meta["torch"] == torch.__version__ and "jax" not in meta
    mdl = load_model(out)
    assert mdl.meta["backend"] == "cpu"
    pol = TunedPolicy(mdl, device=CPU)
    pol.choose(TC.random_csr_graph(512, 1536, seed=2), kind="single")
    assert pol.model_routed + pol.fallback_routed == 1


@pytest.fixture(scope="module")
def two_rank_calibration(tmp_path_factory):
    """A smoke calibration with the sharded records of 2 gloo ranks."""
    from repro_torch.tune import calibrate

    out = tmp_path_factory.mktemp("cal2") / "c.json"
    calibrate.run(smoke=True, repeats=1, devices=2, out=str(out),
                  verbose=False, device=CPU)
    return str(out)


def test_calibration_on_two_ranks_adds_the_sharded_records(
        two_rank_calibration):
    from repro_torch.tune import calibrate

    doc = json.load(open(two_rank_calibration))
    # the key sets of JAX's records (delta_kind on the Δ races only)
    jax_keys = {frozenset(r) for r in json.load(open(CALIBRATION))["records"]}
    assert doc["meta"]["devices"] == 2
    recs = doc["records"]
    assert all(frozenset(r) in jax_keys for r in recs)
    sharded = [r for r in recs if r["engine"].endswith("_sharded")]
    assert {r["nprocs"] for r in sharded} == {2}
    assert all(r["nprocs"] == 1 for r in recs if r not in sharded)
    for corpus, n, m in calibrate.SMOKE_GRID:
        g = calibrate.make_graph(corpus, n, m)
        mine = [(r["engine"], r["batch"]) for r in sharded
                if (r["corpus"], r["n"], r["m"]) == (corpus, g.n, g.nnz)]
        assert mine == [("frontier_sharded", 1), ("bellman_csr_sharded", 1)] \
            + [("multisource_csr_sharded", b)
               for b in calibrate.BATCHES_SMOKE], (corpus, n)
    assert all(r["converged"] and r["wall_ms"] > 0 for r in sharded)
    # JAX's loader and fit take the file as they take their own
    assert j_load_model(two_rank_calibration).to_json() == load_model(
        two_rank_calibration).to_json()


_JAX_CHOICES = """
import json, sys
from repro.core import csr as C
from repro.serve import DispatchPolicy
from repro.tune import TunedPolicy
from repro.tune.model import load_model

model = load_model(sys.argv[1])
out = []
for corpus, n in json.loads(sys.argv[2]):
    g = (C.random_csr_graph(n, 3 * n, seed=4 * n) if corpus == "sparse"
         else C.road_like_csr_graph(n, seed=n) if corpus == "road"
         else C.skewed_hub_csr_graph(n, seed=n))
    row = {}
    for name, pol in (("base", DispatchPolicy(nprocs=2)),
                      ("tuned", TunedPolicy(model, nprocs=2))):
        assert pol.nprocs == 2
        ch = pol.choose(g, kind="single")
        row[name] = [ch.engine, ch.nprocs, ch.via,
                     None if ch.delta is None else float(ch.delta),
                     ch.batch_cap]
    out.append(row)
print("CHOICES=" + json.dumps(out))
"""


def test_tune_bench_two_rank_legs_choose_as_jax(two_rank_calibration,
                                               tmp_path):
    """The P = 2 legs run on 2 gloo ranks; each policy's choice equals
    JAX's at nprocs=2 on the same model (taken in a child with 2 forced
    host devices: the choice is pure and runs no JAX sharded engine)."""
    import os
    import subprocess
    import sys

    from repro_torch.benchmarks import tune_bench

    out = tmp_path / "tune.json"
    tune_bench.run(smoke=True, repeats=1, devices=2,
                   calibration=two_rank_calibration, out=str(out),
                   device=CPU)
    doc = json.load(open(out))
    assert doc["gate_tune"]["pass"] and doc["meta"]["devices"] == 2
    rows = doc["results"]
    assert [r["nprocs"] for r in rows] == [1, 2] * len(tune_bench.SMOKE_LEGS)
    assert all(r["agrees_bitwise"] and r["agrees_serial"] for r in rows)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", _JAX_CHOICES, two_rank_calibration,
         json.dumps(tune_bench.SMOKE_LEGS)],
        capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    jax_rows = json.loads(res.stdout.split("CHOICES=")[1])
    for mine, theirs in zip([r for r in rows if r["nprocs"] == 2], jax_rows):
        for name in ("base", "tuned"):
            got = mine[name]
            assert [got["engine"], got["nprocs"], got["via"], got["delta"],
                    got["batch_cap"]] == theirs[name], (mine["corpus"],
                                                        mine["n"], name)


def test_calibration_defaults_to_cuda_and_raises_without_a_gpu(tmp_path):
    from repro_torch.tune import calibrate

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        calibrate.main(["--smoke", "--out", str(tmp_path / "c.json")])
    assert calibrate.DEFAULT_OUT.endswith("CALIBRATION_torch.json")
