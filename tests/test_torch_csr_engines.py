"""Port parity for the CSR fixpoint engines and the relax kernel's wrappers:
repro_torch (device="cpu", plain paths) against the JAX package, bitwise.

Inputs come from numpy seeds; graphs built by the JAX package are carried
into the port with ``repro_torch.core.csr.from_arrays``.  JAX kernel
engines run in Pallas interpret mode, as the JAX package's own tests run
them on the CPU, and are kept few and small.  The JAX kernel reads a padded
ELL and the port's an incoming CSR: a random ELL case is handed to the port
as the CSR of its finite slots, the same candidates."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import csr as JC
from repro.core.api import recover_pred as j_recover_pred
from repro.core.api import shortest_paths as j_sp
from repro.kernels.csr_relax import ops as j_ops
from repro.kernels.csr_relax import ref as j_ref
from repro_torch.core import csr as TC
from repro_torch.core import api as T
from repro_torch.kernels.csr_relax import kernel as t_kernel
from repro_torch.kernels.csr_relax import ops as t_ops
from repro_torch.kernels.csr_relax import ref as t_ref


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
    """Port result == JAX result: dist bitwise, pred, counters."""
    assert t.dist.dtype == np.float32 and t.dist.shape == j.dist.shape
    assert t.dist.tobytes() == np.asarray(j.dist).tobytes()
    if j.pred is None:
        assert t.pred is None
    else:
        assert np.array_equal(t.pred, np.asarray(j.pred))
    assert (t.sweeps, t.edges_relaxed, t.converged) == (
        j.sweeps, j.edges_relaxed, j.converged)


def mixed_dist(rng, n):
    d = rng.uniform(0.0, 500.0, n).astype(np.float32)
    d[rng.random(n) < 0.3] = np.inf
    return d


def ell_case(rng, n, K, fill):
    idx = rng.integers(0, n, (n, K)).astype(np.int32)
    w = rng.uniform(1.0, 100.0, (n, K)).astype(np.float32)
    pad = rng.random((n, K)) < fill
    idx[pad], w[pad] = 0, np.inf
    return idx, w


def ell_to_csr(idx, w):
    """The int32 CSR (indptr, indices, weights) of an ELL's finite slots,
    row by row in slot order, as torch tensors."""
    keep = np.isfinite(w)
    indptr = np.concatenate([[0], np.cumsum(keep.sum(axis=1))])
    return (torch.tensor(indptr.astype(np.int32)), torch.tensor(idx[keep]),
            torch.tensor(w[keep]))


@pytest.mark.parametrize("n,K,fill", [(37, 5, 0.2), (301, 200, 0.5),
                                      (1, 8, 0.0), (1000, 24, 0.7)])
def test_csr_relax_ops_bitwise_vs_jax(n, K, fill):
    rng = np.random.default_rng(n + K)
    d = mixed_dist(rng, n)
    idx, w = ell_case(rng, n, K, fill)
    want = np.asarray(j_ops.csr_relax_sweep(
        jnp.asarray(d), jnp.asarray(idx), jnp.asarray(w), interpret=True))
    got = t_ops.csr_relax_sweep(torch.tensor(d), *ell_to_csr(idx, w))
    assert got.numpy().tobytes() == want.tobytes()
    ref = t_ref.ell_relax_ref(torch.tensor(d), torch.tensor(idx),
                              torch.tensor(w))
    assert ref.numpy().tobytes() == np.asarray(j_ref.ell_relax_ref(
        jnp.asarray(d), jnp.asarray(idx), jnp.asarray(w))).tobytes()


def test_segment_relax_ref_matches_jax_and_ell():
    cg = JC.sparse_csr_graph(513, seed=2)
    rng = np.random.default_rng(1)
    d = mixed_dist(rng, cg.n)
    src, dst = cg.indices, cg.dst_ids()
    want = np.asarray(j_ref.segment_relax_ref(
        jnp.asarray(d), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(cg.weights)))
    got = t_ref.segment_relax_ref(torch.tensor(d), torch.tensor(src),
                                  torch.tensor(dst), torch.tensor(cg.weights))
    assert got.numpy().tobytes() == want.tobytes()
    idx, w = cg.ell()
    ell = t_ref.ell_relax_ref(torch.tensor(d), torch.tensor(idx),
                              torch.tensor(w))
    assert ell.numpy().tobytes() == want.tobytes()
    csr = t_ref.ell_relax_csr_ref(
        torch.tensor(d), torch.tensor(cg.indptr.astype(np.int32)),
        torch.tensor(src), torch.tensor(cg.weights))
    assert csr.numpy().tobytes() == want.tobytes()


def test_ell_relax_wrapper_cpu_uses_plain_version_and_checks_inputs():
    rng = np.random.default_rng(3)
    ip, idx, w = ell_to_csr(*ell_case(rng, 50, 8, 0.3))
    d = torch.tensor(mixed_dist(rng, 50))
    before = t_kernel.ell_relax.launches
    got = t_kernel.ell_relax(d, ip, idx, w)
    assert t_kernel.ell_relax.launches == before      # no kernel on the CPU
    assert torch.equal(got, t_ref.ell_relax_csr_ref(d, ip, idx, w))
    with pytest.raises(TypeError):
        t_kernel.ell_relax(d.double(), ip, idx, w)
    with pytest.raises(TypeError):
        t_kernel.ell_relax(d, ip.long(), idx, w)
    with pytest.raises(ValueError):
        t_kernel.ell_relax(d[:49], ip, idx, w)
    with pytest.raises(ValueError):
        t_kernel.ell_relax(d, ip, idx, torch.stack([w, w], 1)[:, 0])


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
def test_bellman_csr_engines_bitwise_vs_jax(corpus):
    """Both port engines against the JAX engine (the JAX kernel engine is
    bitwise equal to it by the JAX package's own tests)."""
    cg = CORPORA[corpus]()
    tg = carry(cg)
    src = cg.n // 3
    want = j_sp(cg, src, engine="bellman_csr")
    for eng in ("bellman_csr", "bellman_csr_kernel"):
        got = T.shortest_paths(tg, src, engine=eng, device="cpu")
        same_result(got, want)
        assert got.engine == eng


@pytest.mark.parametrize("corpus", ["sparse", "disconnected"])
def test_bellman_csr_kernel_bitwise_vs_jax_kernel_engine(corpus):
    cg = CORPORA[corpus]()
    want = j_sp(cg, 1, engine="bellman_csr_kernel")
    same_result(T.shortest_paths(carry(cg), 1, engine="bellman_csr_kernel",
                                 device="cpu"), want)


@pytest.mark.parametrize("corpus", ["sparse", "directed", "disconnected",
                                    "single_vertex", "edgeless"])
def test_serial_bitwise_vs_jax(corpus):
    cg = CORPORA[corpus]()
    want = j_sp(cg, 0, engine="serial")
    got = T.shortest_paths(carry(cg), 0, engine="serial", device="cpu")
    same_result(got, want)
    dense = T.shortest_paths(carry(cg).to_dense().adj, 0, engine="serial",
                             device="cpu")
    assert dense.dist.tobytes() == got.dist.tobytes()


@pytest.mark.parametrize("cap", [0, 1, 3])
def test_bellman_csr_max_sweeps_parity(cap):
    cg = CORPORA["road"]()
    want = j_sp(cg, 0, engine="bellman_csr", max_sweeps=cap)
    for eng in ("bellman_csr", "bellman_csr_kernel"):
        got = T.shortest_paths(carry(cg), 0, engine=eng, device="cpu",
                               max_sweeps=cap)
        same_result(got, want)
        assert got.converged is False


@pytest.mark.parametrize("corpus", ["sparse", "directed", "disconnected"])
def test_multisource_csr_and_recover_pred_vs_jax(corpus):
    cg = CORPORA[corpus]()
    tg = carry(cg)
    srcs = [0, cg.n // 2, cg.n - 1, 5]
    want = j_sp(cg, srcs, engine="multisource_csr")
    got = T.shortest_paths(tg, srcs, engine="multisource_csr", device="cpu")
    same_result(got, want)
    assert np.array_equal(got.sources, np.asarray(want.sources))
    assert np.array_equal(T.recover_pred(got, tg, device="cpu"),
                          np.asarray(j_recover_pred(want, cg)))
    one = T.shortest_paths(tg, srcs[1], engine="bellman_csr", device="cpu")
    assert got.dist[1].tobytes() == one.dist.tobytes()
    no_src = T.SsspResult(got.dist, None, got.sweeps, got.engine)
    assert np.array_equal(T.recover_pred(no_src, tg, device="cpu"),
                          T.recover_pred(got, tg, device="cpu"))


def test_multisource_csr_max_sweeps_parity():
    cg = CORPORA["road"]()
    want = j_sp(cg, [0, 7], engine="multisource_csr", max_sweeps=4)
    got = T.shortest_paths(carry(cg), [0, 7], engine="multisource_csr",
                           device="cpu", max_sweeps=4)
    same_result(got, want)


def test_dense_graph_input_converts_like_jax():
    from repro.core import graph as JG
    from repro_torch.core import graph as TG

    j = JG.random_graph(90, 300, seed=6)
    t = TG.random_graph(90, 300, seed=6)
    want = j_sp(j, 4, engine="bellman_csr")
    same_result(T.shortest_paths(t, 4, engine="bellman_csr", device="cpu"),
                want)
    same_result(T.shortest_paths(t.adj, 4, engine="bellman_csr_kernel",
                                 device="cpu"), want)


@pytest.mark.parametrize("engine,kw,exc", [
    ("nope", {}, ValueError),
    ("bellman_csr", {"delta": 5.0}, ValueError),
    ("frontier", {"delta": -1.0}, ValueError),
    ("frontier", {"delta": float("inf")}, ValueError),
    ("delta_stepping", {"delta": "wide"}, ValueError),
    ("bellman_csr", {"target": 3}, ValueError),
    ("delta_stepping", {"target": 3}, ValueError),
    ("bellman", {"delta": 5.0}, ValueError),
    ("bellman_kernel", {"target": 3}, ValueError),
    ("multisource", {"delta": "auto"}, ValueError),
    ("dijkstra_sharded", {}, NotImplementedError),
    ("bellman_sharded", {}, NotImplementedError),
    ("bellman_csr_sharded", {}, NotImplementedError),
    ("frontier_sharded", {}, NotImplementedError),
    ("multisource_csr_sharded", {}, NotImplementedError),
    ("auto", {"delta": "wide"}, ValueError),
])
def test_eager_validation_and_unported_engines(engine, kw, exc):
    tg = TC.sparse_csr_graph(20)
    with pytest.raises(exc):
        T.shortest_paths(tg, 0, engine=engine, device="cpu", **kw)


def test_engine_tuple_matches_jax():
    from repro.core import api as J

    assert T.ENGINES == J.ENGINES
    assert set(T.PORTED_ENGINES) | set(T._LATER_SLICE) == set(T.ENGINES)


def test_cuda_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tg = TC.sparse_csr_graph(20)
    for eng in T.PORTED_ENGINES:
        with pytest.raises(RuntimeError, match="CUDA"):
            T.shortest_paths(tg, 0, engine=eng)       # default device="cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        T.recover_pred(T.SsspResult(np.zeros((1, 20), np.float32), None, 1,
                                    "multisource_csr"), tg)


def test_sssp_run_cli_runs_and_verifies_on_cpu(capsys):
    from repro_torch.launch import sssp_run

    for argv in (["--engine", "delta_stepping_kernel", "--corpus", "road",
                  "--nodes", "400"],
                 ["--engine", "multisource_csr", "--nodes", "300",
                  "--sources", "3"],
                 ["--engine", "serial", "--nodes", "50", "--directed"]):
        sssp_run.main(argv + ["--device", "cpu", "--repeats", "1",
                              "--verify"])
        out = capsys.readouterr().out
        assert "verify: OK" in out and "device=cpu" in out
