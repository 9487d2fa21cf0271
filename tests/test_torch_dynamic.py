"""Port parity for the dynamic-graph path: repro_torch.dynamic (device="cpu")
against repro.dynamic on the same graphs and the same seeded edits.

Overlay semantics, validation, coalescing, rollback and compaction; the
snapshot arrays byte-identical to the JAX package's; staged tensors that
later host edits cannot reach; ``pull_edge_slots`` against a naive loop;
chained repairs whose dist / pred are bitwise equal to JAX's repair and to
``serial`` on the snapshot, with the same sweeps, edges_relaxed, cone and
converged; the dynamic sweeps driving the core engines; ``row_affected``;
and ``EdgeChurn`` drawing JAX's edit sequence.  Every comparison is
bitwise: no tolerance.
"""
from dataclasses import astuple

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import csr as JC
from repro.dynamic import DynamicGraph as JDyn
from repro.dynamic import repair_sssp as j_repair
from repro.dynamic import row_affected as j_row_affected
from repro.dynamic import solve_dynamic as j_solve
from repro.dynamic.repair import sssp_frontier_dynamic as j_frontier_dyn
from repro.serve.workload import EdgeChurn as JChurn
from repro_torch.core import csr as TC
from repro_torch.core.api import shortest_paths as t_sp
from repro_torch.core.bellman_csr import (sssp_bellman_csr,
                                          sssp_multisource_csr)
from repro_torch.core.frontier import pull_edge_slots, sssp_frontier
from repro_torch.dynamic import (DynamicGraph, dynamic_segment_sweep,
                                 dynamic_segment_sweep_multi,
                                 make_dynamic_flat_sweep_fn, repair_sssp,
                                 row_affected, solve_dynamic,
                                 sssp_frontier_dynamic)
from repro_torch.serve.workload import EdgeChurn

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # small tensors: intra-op threads only add contention under xdist
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def carry(cg):
    return TC.from_arrays(cg.indptr, cg.indices, cg.weights, cg.n,
                          cg.directed)


class Pair:
    """A JAX DynamicGraph and the port's over the same base, edited alike."""

    def __init__(self, cg, **kw):
        self.j = JDyn(cg, **kw)
        self.t = DynamicGraph(carry(cg), **kw)

    @property
    def n(self):
        return self.t.n

    def apply(self, edit):
        self.j.apply(edit)
        self.t.apply(edit)

    def commit(self):
        jb, tb = self.j.commit(), self.t.commit()
        assert astuple(tb) == astuple(jb)
        assert (self.t.version, self.t.compactions, self.t.overlay_used) == (
            self.j.version, self.j.compactions, self.j.overlay_used)
        return jb, tb


def mixed_edits(dyn, rng, count):
    """``count`` seeded mixed edits (add / delete / update) valid on
    ``dyn`` (a DynamicGraph or a Pair), applied to it, as in
    tests/test_dynamic.py."""
    probe = dyn.t if isinstance(dyn, Pair) else dyn
    applied = 0
    while applied < count:
        u, v = int(rng.integers(probe.n)), int(rng.integers(probe.n))
        if u == v:
            continue
        if probe.has_edge(u, v):
            if rng.random() < 0.45:
                dyn.apply(("delete", u, v))
            else:
                dyn.apply(("update", u, v, float(rng.uniform(0.5, 100))))
        else:
            dyn.apply(("add", u, v, float(rng.uniform(0.5, 100))))
        applied += 1


def same_graph(t_cg, j_cg):
    for name in ("indptr", "indices", "weights"):
        a, b = getattr(t_cg, name), np.asarray(getattr(j_cg, name))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert (t_cg.n, t_cg.directed) == (j_cg.n, j_cg.directed)


def serial(dyn, s):
    return t_sp(dyn.snapshot(), s, engine="serial", device=CPU)


def same_result(t, j):
    assert t.dist.tobytes() == np.asarray(j.dist).tobytes()
    assert np.array_equal(t.pred, np.asarray(j.pred))
    assert (t.sweeps, t.edges_relaxed, t.converged) == (
        j.sweeps, j.edges_relaxed, j.converged)


def repair_both(pair, t_prev, j_prev, **kw):
    jb, tb = pair.commit()
    jr, js = j_repair(pair.j, j_prev, jb, **kw)
    tr, ts = repair_sssp(pair.t, t_prev, tb, device=CPU, **kw)
    assert astuple(ts) == astuple(js)
    same_result(tr, jr)
    return tr, jr, ts


# ---------------------------------------------------------------------------
# overlay semantics
# ---------------------------------------------------------------------------

def test_overlay_mutation_semantics_and_snapshot():
    cg = JC.random_csr_graph(80, 240, seed=0)
    pair = Pair(cg, overlay_capacity=8)
    u = np.asarray(cg.indices, np.int64)
    v = cg.dst_ids().astype(np.int64)
    mirror = {(int(a), int(b)): np.float32(w)
              for a, b, w in zip(u, v, cg.weights) if a < b}
    pair.apply(("add", 0, 79, 3.25))
    mirror[(0, 79)] = np.float32(3.25)
    some = next(iter(mirror))
    pair.apply(("update", some[1], some[0], 42.0))
    mirror[some] = np.float32(42.0)
    gone = next(k for k in mirror if k != some)
    pair.apply(("delete", *gone))
    del mirror[gone]
    _, batch = pair.commit()
    assert pair.t.version == 1 and len(batch) == 3
    keys = sorted(mirror)
    want = TC.csr_from_edge_list(80, np.array(keys, np.int64),
                                 np.array([mirror[k] for k in keys]))
    snap = pair.t.snapshot()
    same_graph(snap, pair.j.snapshot())
    for name in ("indptr", "indices", "weights"):
        assert np.array_equal(getattr(snap, name), getattr(want, name))
    assert pair.t.weight_of(79, 0) == np.float32(3.25)
    assert not pair.t.has_edge(*gone)
    assert pair.t.nnz_live == pair.j.nnz_live == snap.nnz


def test_overlay_rejects_invalid_mutations():
    cg = TC.random_csr_graph(20, 60, seed=1)
    dyn = DynamicGraph(cg)
    live = (int(cg.indices[0]), int(cg.dst_ids()[0]))
    absent = next((a, b) for a in range(20) for b in range(a + 1, 20)
                  if not dyn.has_edge(a, b))
    with pytest.raises(ValueError, match="already present"):
        dyn.add_edge(*live, 1.0)
    with pytest.raises(ValueError, match="not present"):
        dyn.update_edge(*absent, 1.0)
    with pytest.raises(ValueError, match="not present"):
        dyn.delete_edge(*absent)
    with pytest.raises(ValueError, match="finite and > 0"):
        dyn.add_edge(*absent, 0.0)
    with pytest.raises(ValueError, match="finite and > 0"):
        dyn.update_edge(*live, -1.0)
    with pytest.raises(ValueError, match="finite and > 0"):
        dyn.add_edge(*absent, float("inf"))
    with pytest.raises(ValueError, match="self-loops"):
        dyn.delete_edge(4, 4)
    with pytest.raises(IndexError):
        dyn.add_edge(0, 20, 1.0)
    with pytest.raises(ValueError, match="unknown edit op"):
        dyn.apply(("upsert", 0, 1, 2.0))
    with pytest.raises(ValueError, match="overlay_capacity"):
        DynamicGraph(cg, overlay_capacity=0)
    assert dyn.version == 0 and len(dyn.commit()) == 0   # nothing leaked


def test_overlay_commit_coalesces_and_rollback_restores():
    cg = JC.random_csr_graph(30, 90, seed=2)
    pair = Pair(cg)
    live = (int(cg.indices[0]), int(cg.dst_ids()[0]))
    w0 = pair.t.weight_of(*live)
    absent = next((a, b) for a in range(30) for b in range(a + 1, 30)
                  if not pair.t.has_edge(a, b))
    for edit in (("add", *absent, 5.0), ("delete", *absent),
                 ("update", *live, 77.0), ("update", *live, w0)):
        pair.apply(edit)
    jb, tb = pair.commit()
    assert len(tb) == 0 and pair.t.version == 0
    # rollback: an uncommitted batch is undone edge by edge
    before = pair.t.snapshot()
    pair.apply(("add", *absent, 5.0))
    pair.apply(("update", *live, 9.0))
    assert pair.t.rollback() == pair.j.rollback() == 2
    assert not pair.t.has_edge(*absent) and pair.t.weight_of(*live) == w0
    jb, tb = pair.commit()
    assert len(tb) == 0
    same_graph(pair.t.snapshot(), pair.j.snapshot())
    same_graph(pair.t.snapshot(), before)


def test_overlay_growth_keeps_base_frozen_and_solves_like_jax():
    cg = JC.random_csr_graph(40, 120, seed=3)
    pair = Pair(cg, overlay_capacity=2, compact_threshold=None)
    base_w = pair.t.base.weights.copy()
    rng = np.random.default_rng(0)
    for _ in range(7):                       # forces growth 2 -> 16
        while True:
            a, b = int(rng.integers(40)), int(rng.integers(40))
            if a != b and not pair.t.has_edge(a, b):
                break
        pair.apply(("add", a, b, 2.0))
    pair.commit()
    assert pair.t.overlay_used == 14
    assert pair.t.overlay_capacity == pair.j.overlay_capacity >= 14
    assert pair.t.overlay_growths == pair.j.overlay_growths
    assert np.array_equal(pair.t.base.weights, base_w)
    assert not pair.t.base.weights.flags.writeable
    same_result(solve_dynamic(pair.t, 0, device=CPU), j_solve(pair.j, 0))
    assert solve_dynamic(pair.t, 0, device=CPU).dist.tobytes() == \
        serial(pair.t, 0).dist.tobytes()


def test_overlay_compaction_preserves_graph_and_version():
    cg = JC.random_csr_graph(60, 180, seed=4)
    pair = Pair(cg, overlay_capacity=64, compact_threshold=4)
    rng = np.random.default_rng(1)
    for _ in range(3):
        mixed_edits(pair, rng, 4)
        pair.commit()
        same_graph(pair.t.snapshot(), pair.j.snapshot())
    assert pair.t.compactions >= 1 and pair.t.overlay_used <= 4
    v, snap = pair.t.version, pair.t.snapshot()
    compacted = pair.t.compact()
    pair.j.compact()
    assert pair.t.version == v
    same_graph(compacted, snap)
    same_graph(pair.t.base, pair.j.base)
    same_result(solve_dynamic(pair.t, 5, device=CPU), j_solve(pair.j, 5))


def test_staged_tensors_are_copies_of_the_host_mirrors():
    cg = TC.random_csr_graph(50, 150, seed=5)
    dyn = DynamicGraph(cg, overlay_capacity=8)
    ops = dyn.dyn_ops(device=CPU)
    assert set(ops) == {"src", "dst", "in_indptr", "out_indptr", "out_dst",
                        "w", "out_w", "ov_src", "ov_dst", "ov_w"}
    old = dyn.staged_ops()
    frozen = {k: t.clone() for k, t in old.items()}
    # host edits write the mirrors in place; the staged version keeps its
    # values, before the commit and after it
    live = (int(cg.indices[0]), int(cg.dst_ids()[0]))
    dyn.update_edge(*live, 77.0)
    absent = next((a, b) for a in range(50) for b in range(a + 1, 50)
                  if not dyn.has_edge(a, b))
    dyn.add_edge(*absent, 1.5)
    for k, t in old.items():
        assert torch.equal(t, frozen[k]), k
    dyn.commit()
    for k, t in old.items():
        assert torch.equal(t, frozen[k]), k
    new = dyn.dyn_ops(device=CPU)
    assert not torch.equal(new["w"], old["w"])
    assert int((new["ov_dst"] < dyn.n).sum()) == 2
    assert new["src"] is old["src"]        # the index tensors stay pinned
    assert dyn.staged_nbytes == sum(t.nbytes for t in new.values())


def test_dyn_ops_match_jax_operands():
    cg = JC.random_csr_graph(70, 210, seed=6)
    pair = Pair(cg, overlay_capacity=8)
    mixed_edits(pair, np.random.default_rng(2), 6)
    pair.commit()
    jops, tops = pair.j.dyn_ops(), pair.t.dyn_ops(device=CPU)
    assert set(tops) == set(jops)
    for k in jops:
        assert np.array_equal(tops[k].numpy(), np.asarray(jops[k])), k


# ---------------------------------------------------------------------------
# pull_edge_slots against a naive loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [5, 6])
def test_pull_edge_slots_matches_naive_reference(seed):
    cg = TC.random_csr_graph(50, 200, seed=seed)
    n = cg.n
    indptr = np.concatenate([cg.indptr, cg.indptr[-1:]])
    src, w = np.asarray(cg.indices), np.asarray(cg.weights)
    rng = np.random.default_rng(seed)
    dist = rng.uniform(0, 30, n).astype(np.float32)
    dist[rng.uniform(size=n) < 0.3] = np.inf
    rows = np.flatnonzero(rng.uniform(size=n) < 0.4)
    fids = np.concatenate([rows, [n, n]])     # two sentinel rows, no slots
    starts = indptr[fids]
    degs = indptr[fids + 1] - starts
    off = np.cumsum(degs) - degs
    ip = torch.tensor(indptr, dtype=torch.int32)
    f = torch.tensor(fids)
    st = ip[f]
    dg = ip[f + 1] - st
    cs = torch.cumsum(dg, 0)
    assert np.array_equal((cs - dg).numpy(), off)
    d = torch.tensor(dist)
    nd = pull_edge_slots(d, f, d, st, cs - dg, cs[-1],
                         torch.tensor(src).long(), torch.tensor(w))
    want = dist.copy()
    for r in rows:
        for p in range(int(cg.indptr[r]), int(cg.indptr[r + 1])):
            want[r] = min(want[r], np.float32(dist[src[p]] + w[p]))
    assert nd.numpy().tobytes() == want.tobytes()
    assert d.numpy().tobytes() == dist.tobytes()      # nd not written
    empty = pull_edge_slots(d, f[:0], d, st[:0], st[:0].long(), 0,
                            torch.tensor(src).long(), torch.tensor(w))
    assert torch.equal(empty, d) and empty is not d


# ---------------------------------------------------------------------------
# repair: bitwise against JAX's repair and against serial on the snapshot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,seed", [(60, 180, 0), (200, 600, 1),
                                      (150, 300, 2)])
def test_repair_chained_mixed_batches_match_jax(n, m, seed):
    cg = JC.random_csr_graph(n, m, seed=seed)
    pair = Pair(cg, overlay_capacity=16)
    rng = np.random.default_rng(seed)
    t_res = solve_dynamic(pair.t, 0, device=CPU)
    j_res = j_solve(pair.j, 0)
    same_result(t_res, j_res)
    cones = []
    for rnd in range(5):
        mixed_edits(pair, rng, 4)
        t_res, j_res, st = repair_both(pair, t_res, j_res)
        cones.append(st.cone)
        ref = serial(pair.t, 0)
        assert t_res.dist.tobytes() == ref.dist.tobytes(), rnd
        assert np.array_equal(t_res.pred, ref.pred), rnd
        same_graph(pair.t.snapshot(), pair.j.snapshot())
    assert t_res.engine == "repair"


def test_repair_each_direction_and_disconnection_reconnection():
    edges = np.stack([np.arange(11), np.arange(1, 12)], 1)
    cg = JC.csr_from_edge_list(12, edges, np.full(11, 2.0, np.float32))
    pair = Pair(cg)
    t_res = solve_dynamic(pair.t, 0, device=CPU)
    j_res = j_solve(pair.j, 0)
    steps = ((("update", 3, 4, 0.5),), 0),   \
        ((("update", 3, 4, 10.0),), 8), \
        ((("delete", 5, 6),), 6), \
        ((("add", 2, 9, 1.0),), 0)
    for edits, cone in steps:
        for e in edits:
            pair.apply(e)
        t_res, j_res, st = repair_both(pair, t_res, j_res)
        assert st.cone == cone
        ref = serial(pair.t, 0)
        assert t_res.dist.tobytes() == ref.dist.tobytes()
        assert np.array_equal(t_res.pred, ref.pred)
        if edits[0][0] == "delete":            # the tail is cut off
            assert np.isinf(t_res.dist[6:]).all()
            assert np.all(t_res.pred[6:] == -1)
    assert np.isfinite(t_res.dist).all()        # reconnected via 2 -> 9


def test_repair_shortcut_when_batch_cannot_touch_row():
    cg = JC.random_csr_graph(100, 300, seed=6)
    pair = Pair(cg)
    t_res = solve_dynamic(pair.t, 0, device=CPU)
    j_res = j_solve(pair.j, 0)
    pred = t_res.pred
    arc = next((int(u), int(v)) for u, v in zip(cg.indices, cg.dst_ids())
               if pred[v] != u and pred[u] != v)
    pair.apply(("update", *arc, pair.t.weight_of(*arc) + 50.0))
    jb, tb = pair.commit()
    t2, st = repair_sssp(pair.t, t_res, tb, device=CPU)
    j2, jst = j_repair(pair.j, j_res, jb)
    assert astuple(st) == astuple(jst) and st.shortcut and t2 is t_res
    assert t2.dist.tobytes() == serial(pair.t, 0).dist.tobytes()


def test_repair_with_delta_schedule_matches_jax():
    cg = JC.random_csr_graph(150, 450, seed=7)
    pair = Pair(cg)
    t_res = solve_dynamic(pair.t, 3, device=CPU)
    j_res = j_solve(pair.j, 3)
    mixed_edits(pair, np.random.default_rng(3), 6)
    t_res, _, _ = repair_both(pair, t_res, j_res, delta=25.0)
    assert t_res.dist.tobytes() == serial(pair.t, 3).dist.tobytes()
    same_result(solve_dynamic(pair.t, 3, delta=25.0, device=CPU),
                j_solve(pair.j, 3, delta=25.0))


def test_repair_sublinear_vs_full_resolve():
    cg = JC.random_csr_graph(2000, 6000, seed=8)
    pair = Pair(cg)
    t_res = solve_dynamic(pair.t, 0, device=CPU)
    j_res = j_solve(pair.j, 0)
    mixed_edits(pair, np.random.default_rng(4), 2)
    t_res, _, _ = repair_both(pair, t_res, j_res)
    full = solve_dynamic(pair.t, 0, device=CPU)
    same_result(full, j_solve(pair.j, 0))
    assert t_res.dist.tobytes() == full.dist.tobytes()
    assert t_res.edges_relaxed < full.edges_relaxed


@pytest.mark.parametrize("n", [10, 100, 1000, 2000])
def test_repair_paper_corpus_matches_jax_and_serial(n):
    """One mixed batch per point of the paper's sparse corpus shape
    (m = 3n), repaired bitwise as JAX repairs it and as serial solves the
    mutated graph."""
    cg = JC.random_csr_graph(n, 3 * n, seed=n)
    pair = Pair(cg, overlay_capacity=16)
    t_res = solve_dynamic(pair.t, 0, device=CPU)
    j_res = j_solve(pair.j, 0)
    mixed_edits(pair, np.random.default_rng(n), min(8, max(2, n // 100)))
    t_res, _, _ = repair_both(pair, t_res, j_res)
    ref = serial(pair.t, 0)
    assert t_res.dist.tobytes() == ref.dist.tobytes()
    assert np.array_equal(t_res.pred, ref.pred)


def test_repair_on_a_directed_graph_matches_jax():
    cg = JC.random_csr_graph(120, 400, seed=12, directed=True)
    pair = Pair(cg, overlay_capacity=16)
    t_res = solve_dynamic(pair.t, 0, device=CPU)
    j_res = j_solve(pair.j, 0)
    rng = np.random.default_rng(12)
    for _ in range(3):
        mixed_edits(pair, rng, 5)
        t_res, j_res, _ = repair_both(pair, t_res, j_res)
    assert t_res.dist.tobytes() == serial(pair.t, 0).dist.tobytes()


def test_repair_requires_pred_and_one_row():
    cg = TC.random_csr_graph(30, 90, seed=10)
    dyn = DynamicGraph(cg)
    res = solve_dynamic(dyn, 0, device=CPU)
    dyn.delete_edge(int(cg.indices[0]), int(cg.dst_ids()[0]))
    batch = dyn.commit()
    res.pred = None
    with pytest.raises(ValueError, match="pred"):
        repair_sssp(dyn, res, batch, device=CPU)
    res = solve_dynamic(dyn, 0, device=CPU)
    res.dist, res.pred = res.dist[None], res.pred[None]
    with pytest.raises(ValueError, match="one source row"):
        repair_sssp(dyn, res, batch, device=CPU)


def test_dynamic_entry_points_refuse_a_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dyn = DynamicGraph(TC.random_csr_graph(20, 60, seed=0))
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_dynamic(dyn, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        dyn.dyn_ops()
    assert dyn.staged_nbytes == 0


# ---------------------------------------------------------------------------
# the dynamic sweeps: the core engines on overlay operands
# ---------------------------------------------------------------------------

def test_dynamic_sweeps_drive_core_engines_bitwise():
    cg = JC.random_csr_graph(90, 270, seed=11)
    pair = Pair(cg)
    mixed_edits(pair, np.random.default_rng(6), 10)
    pair.commit()
    snap = pair.t.snapshot()
    ops = pair.t.dyn_ops(device=CPU)

    def ser(s):
        return t_sp(snap, s, engine="serial", device=CPU).dist.tobytes()

    d, _, _, _ = sssp_bellman_csr(ops, 4, n=pair.n,
                                  sweep_fn=dynamic_segment_sweep)
    assert d.numpy().tobytes() == ser(4)
    D, _, _ = sssp_multisource_csr(ops, torch.tensor([0, 7, 33]), n=pair.n,
                                   sweep_fn=dynamic_segment_sweep_multi)
    for i, s in enumerate((0, 7, 33)):
        assert D[i].numpy().tobytes() == ser(s)
    d, p, _, _, _ = sssp_frontier(ops, 2, n=pair.n,
                                  sweep_fn=make_dynamic_flat_sweep_fn(),
                                  target=60)
    full = t_sp(snap, 2, engine="serial", device=CPU).dist
    assert d[60].item() == full[60] and p is None


@pytest.mark.parametrize("delta", [None, 20.0])
def test_sssp_frontier_dynamic_matches_jax_counters(delta):
    cg = JC.random_csr_graph(300, 900, seed=13)
    pair = Pair(cg, overlay_capacity=32)
    mixed_edits(pair, np.random.default_rng(13), 12)
    pair.commit()
    jd, jp, js, je, jc = j_frontier_dyn(pair.j.dyn_ops(), jnp.int32(7),
                                        n=pair.n, delta=delta)
    td, tp, ts, te, tc = sssp_frontier_dynamic(pair.t.dyn_ops(device=CPU),
                                               7, n=pair.n, delta=delta)
    assert td.numpy().tobytes() == np.asarray(jd).tobytes()
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    assert (ts, te, tc) == (int(js), int(je), bool(jc))
    ref = t_sp(pair.t, 7, engine="frontier", device=CPU)   # the snapshot
    assert td.numpy().tobytes() == ref.dist.tobytes()
    assert np.array_equal(tp.numpy(), ref.pred)


# ---------------------------------------------------------------------------
# row_affected and the churn sampler
# ---------------------------------------------------------------------------

def test_row_affected_sound_selective_and_as_jax():
    cg = JC.random_csr_graph(80, 240, seed=17)
    pair = Pair(cg)
    rows = {s: serial(pair.t, s).dist for s in range(0, 80, 7)}
    rng = np.random.default_rng(7)
    kept_any = False
    for _ in range(6):
        mixed_edits(pair, rng, 3)
        jb, tb = pair.commit()
        for s, row in rows.items():
            affected = row_affected(row, tb, pair.t.directed)
            assert affected == j_row_affected(row, jb, pair.j.directed)
            new = serial(pair.t, s).dist
            if not affected:
                assert row.tobytes() == new.tobytes(), s
                kept_any = True
            rows[s] = new
    assert kept_any


@pytest.mark.parametrize("seed", [0, 3])
def test_edge_churn_draws_the_jax_sequence(seed):
    cg = JC.random_csr_graph(60, 150, seed=seed)
    j = JChurn(cg, np.random.default_rng(seed))
    t = EdgeChurn(carry(cg), np.random.default_rng(seed))
    dyn = DynamicGraph(carry(cg), overlay_capacity=64,
                       compact_threshold=None)
    for _ in range(400):
        a, b = t.sample(), j.sample()
        assert (a[0], a[1], a[2], a[3]) == (b[0], int(b[1]), int(b[2]), b[3])
        dyn.apply(a[:3] if a[3] is None else a)     # valid in order
        assert len(t) == len(j.live)
    assert sorted(t._live[:len(t)].tolist()) == sorted(
        int(u) * cg.n + int(v) for u, v in j.live)
    with pytest.raises(ValueError, match="undirected"):
        EdgeChurn(TC.random_csr_graph(30, 90, seed=1, directed=True),
                  np.random.default_rng(0))


def test_shortest_paths_solves_a_dynamic_graph_as_its_snapshot():
    cg = TC.random_csr_graph(70, 210, seed=14)
    dyn = DynamicGraph(cg)
    mixed_edits(dyn, np.random.default_rng(14), 5)
    dyn.commit()
    for eng in ("serial", "frontier", "delta_stepping"):
        got = t_sp(dyn, 1, engine=eng, device=CPU)
        want = t_sp(dyn.snapshot(), 1, engine=eng, device=CPU)
        assert got.dist.tobytes() == want.dist.tobytes()
        assert got.dist.tobytes() == solve_dynamic(dyn, 1,
                                                   device=CPU).dist.tobytes()
