"""Port parity for the frontier engines and the fused frontier push kernel:
repro_torch (device="cpu", plain paths) against the JAX package, bitwise —
dist, pred, sweeps, edges_relaxed and converged, with and without the
Δ throttle, the target early exit and a sweep cap."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import csr as JC
from repro.core import frontier as JF
from repro.core.api import shortest_paths as j_sp
from repro.kernels.frontier_relax.ops import \
    make_frontier_sweep_fn as j_make_sweep
from repro_torch.core import api as T
from repro_torch.core import csr as TC
from repro_torch.core import frontier as TF
from repro_torch.kernels.frontier_relax import kernel as t_kernel
from repro_torch.kernels.frontier_relax.ops import \
    make_frontier_sweep_fn as t_make_sweep
from repro_torch.kernels.frontier_relax.ref import frontier_relax_ref


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


def same_result(t, j):
    assert t.dist.tobytes() == np.asarray(j.dist).tobytes()
    if j.pred is None:
        assert t.pred is None
    else:
        assert np.array_equal(t.pred, np.asarray(j.pred))
    assert (t.sweeps, t.edges_relaxed, t.converged) == (
        j.sweeps, j.edges_relaxed, j.converged)


@pytest.mark.parametrize("n,frac", [(301, 0.1), (1000, 0.6), (77, 0.0)])
def test_frontier_sweep_bitwise_vs_jax_kernel_sweep(n, frac):
    """One compacted sweep: the port's kernel sweep and flat sweep against
    the JAX kernel sweep (Pallas interpret) on the same frontier.  The
    port's sweeps work in place: ``dist`` must end as JAX's new labels and
    ``pending`` as ``(pending & ~active) | (new < old)``."""
    cg = JC.skewed_hub_csr_graph(n, seed=n)
    rng = np.random.default_rng(n)
    d = rng.uniform(0, 500, n).astype(np.float32)
    d[rng.random(n) < 0.3] = np.inf
    active = rng.random(n) < frac
    pending = active | (rng.random(n) < 0.2)
    jops = JF.frontier_operands(cg, with_ell=True)
    want, jE = JF.relax_active(jops, jnp.asarray(d), jnp.asarray(active),
                               n=n, sweep=j_make_sweep(interpret=True))
    want = np.asarray(want)
    want_pending = (pending & ~active) | (want < d)
    tops = TF.frontier_operands(carry(cg), device="cpu")
    for sweep in (t_make_sweep(), TF.make_flat_sweep_fn()):
        got, pend = torch.tensor(d), torch.tensor(pending)
        tE = TF.relax_active(tops, got, torch.tensor(active), pend,
                             sweep=sweep)
        assert got.numpy().tobytes() == want.tobytes()
        assert np.array_equal(pend.numpy(), want_pending)
        assert int(tE) == int(jE)


def test_frontier_relax_wrapper_cpu_sentinels_and_checks():
    cg = TC.sparse_csr_graph(200, seed=1)
    ops = TF.frontier_operands(cg, device="cpu")
    rng = np.random.default_rng(2)
    d = torch.tensor(rng.uniform(0, 100, cg.n).astype(np.float32))
    fids = torch.tensor([3, 50, 199, cg.n, cg.n])          # two sentinels
    args = (ops["out_indptr"], ops["out_dst"], ops["out_w"])
    before = t_kernel.frontier_relax.launches
    got, fell = d.clone(), torch.zeros(cg.n, dtype=torch.bool)
    assert t_kernel.frontier_relax(got, fids, *args, fell) is fell
    assert t_kernel.frontier_relax.launches == before
    flat, pend = d.clone(), torch.zeros(cg.n, dtype=torch.bool)
    TF.relax_active(ops, flat, torch.isin(torch.arange(cg.n), fids), pend,
                    sweep=TF.make_flat_sweep_fn())
    assert torch.equal(got, flat) and torch.equal(fell, pend)
    assert torch.equal(fell, got < d) and bool(fell.any())
    same, none = d.clone(), torch.zeros(cg.n, dtype=torch.bool)
    t_kernel.frontier_relax(same, fids[3:], *args, none)   # sentinels only
    assert torch.equal(same, d) and not bool(none.any())
    with pytest.raises(TypeError):
        t_kernel.frontier_relax(d.clone(), fids.int(), *args, fell)
    with pytest.raises(TypeError):
        t_kernel.frontier_relax(d.clone(), fids, *args, fell.to(torch.uint8))
    with pytest.raises(ValueError):
        t_kernel.frontier_relax(d.clone(), fids, ops["out_indptr"][:10],
                                *args[1:], fell)
    ref, rfell = d.clone(), torch.zeros(cg.n, dtype=torch.bool)
    frontier_relax_ref(ref, fids, *args, rfell)
    assert torch.equal(ref, got) and torch.equal(rfell, fell)


def _hub_out_csr():
    """An outgoing CSR of 60 vertices (the sentinel row n included, as
    ``frontier_operands`` stages it): vertex 0 a hub of 40 out-arcs (more
    than the kernel's 32-arc whole-warp cut), vertices 50-59 isolated, the
    rest with 0-3 arcs."""
    rng = np.random.default_rng(7)
    n = 60
    deg = rng.integers(0, 4, n)
    deg[0], deg[50:] = 40, 0
    ip = np.concatenate([[0], np.cumsum(deg)])
    ip = np.concatenate([ip, ip[-1:]]).astype(np.int32)
    m = int(ip[n])
    dst = rng.integers(0, 50, m).astype(np.int32)
    w = rng.uniform(0.5, 20.0, m).astype(np.float32)
    return n, torch.tensor(ip), torch.tensor(dst), torch.tensor(w)


@pytest.mark.parametrize("case", ["sentinels", "empty", "hub_row",
                                  "isolated"])
def test_frontier_relax_ref_mask_is_new_below_snapshot(case):
    """The plain in-place push flags exactly the labels with new < snapshot
    (ORed into the mask it is given), and its labels equal a scatter-min
    into a copy of the snapshot."""
    n, ip, dst, w = _hub_out_csr()
    rng = np.random.default_rng(len(case))
    d = rng.uniform(0, 60, n).astype(np.float32)
    d[rng.random(n) < 0.2] = np.inf
    fids = {"sentinels": [1, 2, 3, n, n, n],
            "empty": [],
            "hub_row": [0, 5],
            "isolated": [50, 51, 52, 4]}[case]
    fids = torch.tensor(fids, dtype=torch.int64)
    if case == "hub_row":
        d[0] = 1.0                       # the hub's arcs carry candidates
    snap = torch.tensor(d)
    prior = torch.tensor(rng.random(n) < 0.3)
    got, fell = snap.clone(), prior.clone()
    assert frontier_relax_ref(got, fids, ip, dst, w, fell) is fell
    assert torch.equal(fell, prior | (got < snap))
    # the same push written out of place, over the frontier's arcs alone
    want = snap.clone()
    for u in fids.tolist():
        if 0 <= u < n:
            lo, hi = int(ip[u]), int(ip[u + 1])
            want.scatter_reduce_(0, dst[lo:hi].long(), snap[u] + w[lo:hi],
                                 "amin")
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if case == "empty":
        assert torch.equal(got, snap) and torch.equal(fell, prior)
    if case == "hub_row":
        assert int((fell & ~prior).sum()) > 0


@pytest.mark.parametrize("engine", ["frontier", "frontier_kernel"])
@pytest.mark.parametrize("delta", [None, 20.0])
def test_frontier_fixpoint_leaves_callers_state_unchanged(engine, delta):
    """The loop lowers copies of ``dist0`` and ``pending0`` in place; the
    caller's tensors keep their values."""
    cg = TC.road_like_csr_graph(400, seed=3)
    ops = TF.frontier_operands(cg, device="cpu")
    sweep = (t_make_sweep() if engine == "frontier_kernel"
             else TF.make_flat_sweep_fn())
    dist0 = torch.full((cg.n,), torch.inf)
    dist0[0] = 0.0
    pending0 = dist0 < torch.inf
    keep_d, keep_p = dist0.clone(), pending0.clone()
    dist, sweeps, _, converged = TF.frontier_fixpoint(
        ops, dist0, pending0, n=cg.n, sweep=sweep, cap=cg.n, delta=delta)
    assert converged and sweeps > 1
    assert torch.equal(dist0, keep_d) and torch.equal(pending0, keep_p)
    assert dist is not dist0 and int(torch.isfinite(dist).sum()) > 1


CORPORA = {
    "sparse": lambda: JC.sparse_csr_graph(257, seed=3),
    "sparse_10k": lambda: JC.sparse_csr_graph(10_000, seed=0),
    "road": lambda: JC.road_like_csr_graph(900, seed=1),
    "hub": lambda: JC.skewed_hub_csr_graph(2000, seed=2),
    "directed": lambda: JC.random_csr_graph(300, 900, seed=4, directed=True),
    "disconnected": lambda: JC.random_csr_graph(200, 150, seed=5,
                                                connected=False),
    "single_vertex": lambda: JC.random_csr_graph(1, 0, seed=0),
    "edgeless": lambda: JC.random_csr_graph(6, 0, seed=0, connected=False),
}


@pytest.mark.parametrize("corpus", list(CORPORA))
@pytest.mark.parametrize("delta", [None, 25.0, "auto"])
def test_frontier_engines_bitwise_vs_jax(corpus, delta):
    """Both port engines against the JAX frontier engine (its kernel twin
    is bitwise equal to it by the JAX package's own tests)."""
    cg = CORPORA[corpus]()
    kw = {} if delta is None else {"delta": delta}
    want = j_sp(cg, 0, engine="frontier", **kw)
    for eng in ("frontier", "frontier_kernel"):
        same_result(T.shortest_paths(carry(cg), 0, engine=eng, device="cpu",
                                     **kw), want)


@pytest.mark.parametrize("corpus,delta", [("road", None), ("hub", 30.0)])
def test_frontier_kernel_bitwise_vs_jax_kernel_engine(corpus, delta):
    cg = CORPORA[corpus]()
    kw = {} if delta is None else {"delta": delta}
    want = j_sp(cg, 2, engine="frontier_kernel", **kw)
    same_result(T.shortest_paths(carry(cg), 2, engine="frontier_kernel",
                                 device="cpu", **kw), want)


@pytest.mark.parametrize("corpus", list(CORPORA))
@pytest.mark.parametrize("mode", ["plain", "delta", "auto", "target",
                                  "delta_target"])
def test_frontier_engines_bitwise_vs_jax_kernel_engine_every_corpus(corpus,
                                                                    mode):
    """Both port engines against JAX's ``frontier_kernel`` (its Pallas
    kernel in interpret mode) on every corpus, with the Δ throttle and the
    target early exit."""
    cg = CORPORA[corpus]()
    kw = {"delta": 25.0} if mode in ("delta", "delta_target") else {}
    if mode == "auto":
        kw["delta"] = "auto"
    if mode in ("target", "delta_target"):
        dist = np.asarray(j_sp(cg, 0, engine="frontier").dist)
        finite = np.nonzero(np.isfinite(dist))[0]
        kw["target"] = int(finite[len(finite) // 2])
    want = j_sp(cg, 0, engine="frontier_kernel", **kw)
    for eng in ("frontier", "frontier_kernel"):
        same_result(T.shortest_paths(carry(cg), 0, engine=eng, device="cpu",
                                     **kw), want)


@pytest.mark.parametrize("corpus", ["sparse_10k", "road", "hub",
                                    "disconnected"])
@pytest.mark.parametrize("mode", ["target", "lb_exact", "lb_loose",
                                  "delta_target"])
def test_frontier_target_early_exit_bitwise_vs_jax(corpus, mode):
    cg = CORPORA[corpus]()
    full = j_sp(cg, 0, engine="frontier")
    dist = np.asarray(full.dist)
    finite = np.nonzero(np.isfinite(dist))[0]
    target = int(finite[len(finite) // 2])
    kw = {"target": target}
    if mode == "lb_exact":
        kw["target_lb"] = float(dist[target])
    elif mode == "lb_loose":
        kw["target_lb"] = float(dist[target]) * 0.5
    elif mode == "delta_target":
        kw["delta"] = 40.0
    want = j_sp(cg, 0, engine="frontier", **kw)
    for eng in ("frontier", "frontier_kernel"):
        got = T.shortest_paths(carry(cg), 0, engine=eng, device="cpu", **kw)
        same_result(got, want)
        assert got.pred is None and got.dist[target] == dist[target]


@pytest.mark.parametrize("cap,delta", [(0, None), (2, None), (3, 20.0)])
def test_frontier_max_sweeps_parity(cap, delta):
    cg = CORPORA["road"]()
    kw = {"max_sweeps": cap}
    if delta is not None:
        kw["delta"] = delta
    want = j_sp(cg, 0, engine="frontier", **kw)
    for eng in ("frontier", "frontier_kernel"):
        got = T.shortest_paths(carry(cg), 0, engine=eng, device="cpu", **kw)
        same_result(got, want)
        assert got.converged is False


@pytest.mark.parametrize("n,delta,max_sweeps,max_dist", [
    (10, None, None, None), (10, 5.0, None, None), (10, 5.0, 7, None),
    (1000, 2.5, None, 1e6), (1000, 0.001, None, 1e9),
    (50, 1.0, None, float("inf")), (50, 3.0, None, 0.0)])
def test_sweep_cap_matches_jax(n, delta, max_sweeps, max_dist):
    want = JF.sweep_cap(n, delta, max_sweeps,
                        None if max_dist is None else jnp.float32(max_dist))
    got = TF.sweep_cap(n, delta, max_sweeps,
                       None if max_dist is None else torch.tensor(max_dist))
    assert got == int(want)
