"""Port parity for the dense adjacency-matrix path: the paper's generators
and padding, the min-plus sweep ops, and the engines ``bellman``,
``bellman_kernel`` and ``multisource`` — repro_torch (device="cpu", plain
paths) against the JAX package, bitwise.

Min-plus is exact in f32 (adds and compares only), so every comparison is
bitwise, with ``pred`` and ``sweeps`` equal.  Inputs come from numpy
seeds; matrices built by the JAX package are carried into the port with
``repro_torch.core.graph.from_adjacency``.  JAX's Pallas kernels run in
interpret mode, as the JAX package's own tests run them on the CPU, and
its ``bellman_kernel`` engine is kept to n <= 257."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import bellman as JB
from repro.core import csr as JC
from repro.core import graph as JG
from repro.core.api import recover_pred as j_recover_pred
from repro.core.api import shortest_paths as j_sp
from repro.kernels.sssp_relax import kernel as j_kernel
from repro.kernels.sssp_relax import ops as j_ops
from repro.kernels.sssp_relax import ref as j_ref
from repro_torch.core import api as T
from repro_torch.core import bellman as TB
from repro_torch.core import csr as TC
from repro_torch.core import graph as TG
from repro_torch.core import multisource as TM
from repro_torch.kernels.sssp_relax import kernel as t_kernel
from repro_torch.kernels.sssp_relax import ops as t_ops
from repro_torch.kernels.sssp_relax import ref as t_ref


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # small tensors: intra-op threads only add contention under xdist
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def carry(g):
    return TG.from_adjacency(g.adj, g.directed)


def same_result(t, j):
    """Port result == JAX result: dist bitwise, pred, every field."""
    assert _same(t.dist, np.asarray(j.dist))
    if j.pred is None:
        assert t.pred is None
    else:
        assert _same(t.pred, np.asarray(j.pred))
    assert (t.sweeps, t.edges_relaxed, t.converged) == (
        j.sweeps, j.edges_relaxed, j.converged)
    assert type(t.sweeps) is type(j.sweeps)
    if j.sources is None:
        assert t.sources is None
    else:
        assert _same(t.sources, np.asarray(j.sources))


def mixed_dist(rng, n, inf_frac=0.3):
    d = rng.uniform(0.0, 50.0, n).astype(np.float32)
    d[rng.random(n) < inf_frac] = np.inf
    return d


# ---------------------------------------------------------------------------
# generators and the paper's padding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda M: M.dense_graph(100, seed=3),
    lambda M: M.sparse_graph(500, seed=1),
    lambda M: M.random_graph(120, 400, seed=9, directed=True),
    lambda M: M.paper_graph(*M.PAPER_SPARSE[2], seed=2),
], ids=["dense", "sparse", "directed", "paper"])
def test_dense_generators_byte_identical(make):
    j, t = make(JG), make(TG)
    assert _same(t.adj, j.adj)
    assert (t.n, t.directed, t.num_edges) == (j.n, j.directed, j.num_edges)


def test_paper_corpus_tables_match():
    assert TG.PAPER_DENSE == JG.PAPER_DENSE
    assert TG.PAPER_SPARSE == JG.PAPER_SPARSE


@pytest.mark.parametrize("n,p,expect", [(4, 3, 6), (2, 3, 3), (12, 4, 12),
                                        (13, 4, 16)])
def test_padded_size_paper_logic(n, p, expect):
    assert TG.padded_size(n, p) == expect == JG.padded_size(n, p)


@pytest.mark.parametrize("multiple", [1, 4, 7, 64])
def test_padded_byte_identical(multiple):
    j = JG.random_graph(10, 30, seed=2).padded(multiple)
    t = TG.random_graph(10, 30, seed=2).padded(multiple)
    assert _same(t.adj, j.adj) and (t.n, t.directed) == (j.n, j.directed)


def test_from_adjacency_copies_and_checks():
    adj = np.array(JG.random_graph(40, 120, seed=4).adj)
    g = TG.from_adjacency(adj, directed=True)
    adj[:] = 0.0                                  # the caller's buffer
    assert _same(g.adj, JG.random_graph(40, 120, seed=4).adj)
    assert not np.shares_memory(g.adj, adj) and g.directed
    with pytest.raises(ValueError):
        g.adj[0, 1] = 1.0
    with pytest.raises(ValueError):
        TG.from_adjacency(np.zeros((3, 4), np.float32))
    with pytest.raises(ValueError):
        TG.from_adjacency(np.zeros(9, np.float32))


# ---------------------------------------------------------------------------
# the sweep ops against JAX's (Pallas interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [64, 100, 137, 256])
def test_relax_sweep_bitwise_vs_jax(n):
    adj = JG.random_graph(n, 4 * n, seed=n).adj
    d = mixed_dist(np.random.default_rng(n), n)
    want = np.asarray(j_ops.relax_sweep(jnp.asarray(d), jnp.asarray(adj),
                                        interpret=True))
    got = t_ops.relax_sweep(torch.tensor(d), torch.tensor(adj))
    assert _same(got.numpy(), want)
    assert _same(want, np.asarray(j_ref.relax_sweep_ref(jnp.asarray(d),
                                                        jnp.asarray(adj))))
    # the plain version at any blocking of u
    for block in (1, 7, n):
        assert _same(t_ref.relax_sweep_ref(torch.tensor(d), torch.tensor(adj),
                                           block=block).numpy(), want)
    assert _same(TB._sweep_blocked(torch.tensor(d), torch.tensor(adj),
                                   32).numpy(),
                 np.asarray(JB._sweep_blocked(jnp.asarray(d),
                                              jnp.asarray(adj), 32)))


@pytest.mark.parametrize("s", [1, 3, 8, 9])
@pytest.mark.parametrize("n", [128, 200])
def test_relax_sweep_multi_bitwise_vs_jax(s, n):
    adj = JG.random_graph(n, 5 * n, seed=s * 100 + n).adj
    rng = np.random.default_rng(s)
    D = np.stack([mixed_dist(rng, n) for _ in range(s)])
    want = np.asarray(j_ops.relax_sweep_multi(jnp.asarray(D),
                                              jnp.asarray(adj),
                                              interpret=True))
    got = t_ops.relax_sweep_multi(torch.tensor(D), torch.tensor(adj))
    assert _same(got.numpy(), want)
    assert _same(t_ref.relax_sweep_multi_ref(torch.tensor(D),
                                             torch.tensor(adj),
                                             block=13).numpy(), want)
    assert _same(TM.relax_sweep_multi_ref(torch.tensor(D),
                                          torch.tensor(adj)).numpy(), want)


@pytest.mark.parametrize("n", [100, 256])
def test_relax_sweep_frontier_mode_bitwise_vs_jax(n):
    adj = JG.random_graph(n, 3 * n, seed=9).adj
    rng = np.random.default_rng(2)
    d = mixed_dist(rng, n, inf_frac=0.1)
    f = rng.random(n) < 0.5
    want = np.asarray(j_ops.relax_sweep(jnp.asarray(d), jnp.asarray(adj),
                                        jnp.asarray(f), interpret=True,
                                        frontier_mode=True))
    td, tf, ta = torch.tensor(d), torch.tensor(f), torch.tensor(adj)
    got = t_ops.relax_sweep(td, ta, tf, frontier_mode=True)
    assert _same(got.numpy(), want)
    # the raw JAX kernel (no fold) is the masked matvec; the fold on top
    # of it gives the same sweep
    if n % 128 == 0:
        raw = np.asarray(j_kernel.relax_matvec_frontier(
            jnp.asarray(d), jnp.asarray(f), jnp.asarray(adj), block_u=128,
            block_v=128, interpret=True))
        assert _same(np.minimum(d, raw), want)
    masked = torch.where(tf, td, torch.inf)
    assert _same(torch.minimum(td, t_kernel.relax_matvec(masked, ta)).numpy(),
                 want)
    with pytest.raises(ValueError):
        t_ops.relax_sweep(td, ta, frontier_mode=True)


def test_all_inf_dist():
    n = 128
    a = JG.random_graph(n, 2 * n, seed=4).adj
    adj = torch.tensor(a)
    d = torch.full((n,), torch.inf)
    got = t_ops.relax_sweep(d, adj)
    assert not torch.isfinite(got).any()
    assert _same(got.numpy(), np.asarray(j_ops.relax_sweep(
        jnp.asarray(d.numpy()), jnp.asarray(a), interpret=True)))
    D = torch.full((3, n), torch.inf)
    got = t_ops.relax_sweep_multi(D, adj)
    assert not torch.isfinite(got).any()
    assert _same(got.numpy(), np.asarray(j_ops.relax_sweep_multi(
        jnp.asarray(D.numpy()), jnp.asarray(a), interpret=True)))


def test_kernel_wrappers_check_inputs():
    adj = torch.zeros((4, 4))
    # float32, bfloat16 and float16 are taken; float64 and a mixed pair
    # are refused
    with pytest.raises(TypeError):
        t_kernel.relax_matvec(torch.zeros(4, dtype=torch.float64),
                              adj.double())
    with pytest.raises(TypeError):
        t_kernel.relax_matvec(torch.zeros(4, dtype=torch.bfloat16), adj)
    with pytest.raises(ValueError):
        t_kernel.relax_matvec(torch.zeros(5), adj)
    with pytest.raises(ValueError):
        t_kernel.relax_matmul(torch.zeros((2, 4)), torch.zeros((4, 4)).t())
    with pytest.raises(TypeError):
        t_kernel.relax_matvec_frontier(torch.zeros(4), torch.zeros(4), adj)


# ---------------------------------------------------------------------------
# engines against JAX's
# ---------------------------------------------------------------------------

GRAPHS = [(10, 30), (10, 45), (100, 300), (100, 4950), (257, 1000)]


def _graph(kind):
    if kind == "directed":
        return JG.random_graph(60, 240, seed=7, directed=True)
    if kind == "disconnected":
        return JG.random_graph(50, 60, seed=1, connected=False)
    n, m = kind
    return JG.random_graph(n, m, seed=n + m)


CASES = GRAPHS + ["directed", "disconnected"]
CASE_IDS = [f"{c[0]}-{c[1]}" if isinstance(c, tuple) else c for c in CASES]


@pytest.mark.parametrize("engine", ["bellman", "bellman_kernel"])
@pytest.mark.parametrize("kind", CASES, ids=CASE_IDS)
def test_bellman_engines_match_jax(engine, kind):
    jg = _graph(kind)
    src = 3 if kind == "directed" else 0
    j = j_sp(jg, src, engine=engine)
    t = T.shortest_paths(carry(jg), src, engine=engine, device="cpu")
    same_result(t, j)
    assert t.converged is None and t.edges_relaxed is None


@pytest.mark.parametrize("kind", CASES, ids=CASE_IDS)
def test_multisource_matches_jax(kind):
    jg = _graph(kind)
    srcs = np.arange(min(5, jg.n)) * (jg.n // min(5, jg.n))
    j = j_sp(jg, srcs, engine="multisource")
    t = T.shortest_paths(carry(jg), srcs, engine="multisource", device="cpu")
    same_result(t, j)
    assert t.pred is None and t.sources.dtype == np.int32


def test_multisource_single_int_source():
    jg = JG.random_graph(30, 90, seed=2)
    j = j_sp(jg, 4, engine="multisource")
    t = T.shortest_paths(carry(jg), 4, engine="multisource", device="cpu")
    same_result(t, j)
    assert t.dist.shape == (1, 30)


def test_use_frontier_matches_jax():
    for seed, n, m in [(5, 70, 280), (8, 200, 600)]:
        adj = JG.random_graph(n, m, seed=seed).adj
        jd, jp, js = JB.sssp_bellman(jnp.asarray(adj), jnp.int32(0),
                                     use_frontier=True)
        td, tp, ts = TB.sssp_bellman(torch.tensor(adj), 0,
                                     use_frontier=True)
        assert _same(td.numpy(), np.asarray(jd))
        assert _same(tp.numpy(), np.asarray(jp))
        assert ts == int(js)
        # the kernel ops as sweep_fn give the same fixpoint
        kd, _, _ = TB.sssp_bellman(torch.tensor(adj), 0,
                                   sweep_fn=t_ops.make_sweep_fn(),
                                   use_frontier=True)
        assert _same(kd.numpy(), np.asarray(jd))


def test_max_sweeps_cap_matches_jax():
    jg = JG.random_graph(100, 300, seed=3)
    for engine in ("bellman", "multisource"):
        j = j_sp(jg, 0, engine=engine, max_sweeps=2)
        t = T.shortest_paths(carry(jg), 0, engine=engine, device="cpu",
                             max_sweeps=2)
        same_result(t, j)
        assert t.sweeps == 2


def test_pred_tie_break_lowest_u():
    # integer weights: many u attain each minimum
    rng = np.random.default_rng(11)
    n = 80
    e, _ = JG.random_edge_list(n, 6 * n, seed=11)
    w = rng.integers(1, 4, size=len(e)).astype(np.float32)
    for directed in (False, True):
        jg = JG.from_edge_list(n, e, w, directed=directed)
        tg = TG.from_edge_list(n, e, w, directed=directed)
        assert _same(tg.adj, jg.adj)
        j = j_sp(jg, 0, engine="bellman")
        for engine in ("bellman", "bellman_kernel"):
            same_result(T.shortest_paths(tg, 0, engine=engine, device="cpu"),
                        j)
        # the blocked recovery (two u rows a block) keeps the lowest u
        adj = torch.tensor(tg.adj)
        d = torch.tensor(np.asarray(j.dist))
        old = TB._PRED_BLOCK_ELEMS
        try:
            TB._PRED_BLOCK_ELEMS = 2 * n
            assert _same(TB.predecessors_from_dist(d, adj, 0).numpy(),
                         np.asarray(j.pred))
        finally:
            TB._PRED_BLOCK_ELEMS = old
        # and matches the CSR recovery's tie-break
        c = T.shortest_paths(tg, 0, engine="bellman_csr", device="cpu")
        assert _same(c.pred, np.asarray(j.pred))


def test_recover_pred_dense_matches_jax():
    jg = JG.random_graph(90, 350, seed=11)
    srcs = np.array([0, 17, 42, 63])
    jr = j_sp(jg, srcs, engine="multisource")
    tg = carry(jg)
    tr = T.shortest_paths(tg, srcs, engine="multisource", device="cpu")
    want = np.asarray(j_recover_pred(jr, jg))
    assert _same(T.recover_pred(tr, tg, device="cpu"), want)
    assert _same(T.recover_pred(tr, tg.adj, device="cpu"), want)
    # a result without sources: the sources are each row's zero
    tr.sources = None
    assert _same(T.recover_pred(tr, tg, device="cpu"), want)
    one = T.shortest_paths(tg, 5, engine="bellman", device="cpu")
    assert T.recover_pred(one, tg, device="cpu") is one.pred


def test_dense_engines_densify_csr_input():
    jcg = JC.sparse_csr_graph(150, seed=6)
    tcg = TC.from_arrays(jcg.indptr, jcg.indices, jcg.weights, jcg.n,
                         jcg.directed)
    for engine in ("bellman", "bellman_kernel"):
        same_result(T.shortest_paths(tcg, 0, engine=engine, device="cpu"),
                    j_sp(jcg, 0, engine=engine))
    srcs = np.array([0, 9, 77])
    same_result(T.shortest_paths(tcg, srcs, engine="multisource",
                                 device="cpu"),
                j_sp(jcg, srcs, engine="multisource"))


def test_dense_engines_agree_with_serial_and_csr():
    tg = TG.sparse_graph(400, seed=0)
    s = T.shortest_paths(tg, 0, engine="serial", device="cpu")
    c = T.shortest_paths(tg.to_csr(), 0, engine="bellman_csr", device="cpu")
    b = T.shortest_paths(tg, 0, engine="bellman", device="cpu")
    k = T.shortest_paths(tg, 0, engine="bellman_kernel", device="cpu")
    for r in (c, b, k):
        assert _same(r.dist, s.dist)
    assert _same(b.pred, c.pred) and _same(k.pred, c.pred)
    assert b.sweeps == k.sweeps == c.sweeps


def test_dense_engines_refuse_cuda_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = TG.random_graph(10, 30, seed=0)
    for engine in ("bellman", "bellman_kernel", "multisource"):
        with pytest.raises(RuntimeError):
            T.shortest_paths(g, 0, engine=engine)


def test_driver_runs_dense_engines(capsys):
    from repro_torch.launch.sssp_run import main

    for engine in ("bellman_kernel", "multisource"):
        main(["--device", "cpu", "--engine", engine, "--nodes", "200",
              "--edges", "600", "--verify", "--repeats", "1",
              "--sources", "3"])
    out = capsys.readouterr().out
    assert out.count("verify: OK") == 2 and "engine=multisource" in out
