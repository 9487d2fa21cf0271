"""Port parity for the Δ-stepping engines and the fused light-bucket pull
kernel's wrappers: repro_torch (device="cpu", plain paths) against the JAX
package, bitwise — including the Δ choice, the phase counts and the edge
counter.  The JAX kernel reads a padded light ELL, the port's a light
incoming CSR of the same arcs."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import csr as JC
from repro.core import delta_stepping as JD
from repro.core.api import shortest_paths as j_sp
from repro.kernels.bucket_relax import ops as j_ops
from repro_torch.core import api as T
from repro_torch.core import csr as TC
from repro_torch.core import delta_stepping as TD
from repro_torch.kernels.bucket_relax import kernel as t_kernel
from repro_torch.kernels.bucket_relax import ops as t_ops
from repro_torch.kernels.bucket_relax.ref import (bucket_relax_csr_ref,
                                                  bucket_relax_ref)


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
    assert np.array_equal(t.pred, np.asarray(j.pred))
    assert (t.sweeps, t.edges_relaxed, t.converged) == (
        j.sweeps, j.edges_relaxed, j.converged)


CORPORA = {
    "sparse": lambda: JC.sparse_csr_graph(257, seed=3),
    "sparse_10k": lambda: JC.sparse_csr_graph(10_000, seed=0),
    "road": lambda: JC.road_like_csr_graph(900, seed=1),
    "road_10k": lambda: JC.road_like_csr_graph(10_000, seed=0),
    "hub": lambda: JC.skewed_hub_csr_graph(2000, seed=2),
    "hub_10k": lambda: JC.skewed_hub_csr_graph(10_000, seed=0),
    "dense": lambda: JC.random_csr_graph(60, 60 * 59 // 2, seed=7),
    "directed": lambda: JC.random_csr_graph(300, 900, seed=4, directed=True),
    "disconnected": lambda: JC.random_csr_graph(200, 150, seed=5,
                                                connected=False),
    "single_vertex": lambda: JC.random_csr_graph(1, 0, seed=0),
    "edgeless": lambda: JC.random_csr_graph(6, 0, seed=0, connected=False),
}


@pytest.mark.parametrize("corpus", list(CORPORA))
def test_delta_profile_matches_jax(corpus):
    cg = CORPORA[corpus]()
    tg = carry(cg)
    assert TD.delta_profile(tg) == JD.delta_profile(cg)
    assert TD.auto_delta(tg) == JD.auto_delta(cg)


@pytest.mark.parametrize("n,K,fill", [(37, 5, 0.2), (301, 200, 0.5),
                                      (1000, 24, 0.7)])
def test_bucket_relax_ops_bitwise_vs_jax(n, K, fill):
    """The JAX kernel on a random padded ELL; the port's on the CSR of its
    finite slots (the same candidates)."""
    rng = np.random.default_rng(n)
    d = rng.uniform(0.0, 500.0, n).astype(np.float32)
    d[rng.random(n) < 0.3] = np.inf
    idx = rng.integers(0, n, (n, K)).astype(np.int32)
    w = rng.uniform(1.0, 100.0, (n, K)).astype(np.float32)
    pad = rng.random((n, K)) < fill
    idx[pad], w[pad] = 0, np.inf
    keep = ~pad
    indptr = np.concatenate([[0], np.cumsum(keep.sum(axis=1))])
    csr = (torch.tensor(indptr.astype(np.int32)), torch.tensor(idx[keep]),
           torch.tensor(w[keep]))
    mid = float(np.median(d[np.isfinite(d)]))
    for hi in (0.0, mid, float("inf")):
        want, wgo = j_ops.bucket_relax_block(
            jnp.asarray(d), jnp.asarray(idx), jnp.asarray(w),
            jnp.float32(hi), interpret=True)
        got, go = t_ops.bucket_relax_block(
            torch.tensor(d), *csr, torch.tensor(hi, dtype=torch.float32))
        assert got.numpy().tobytes() == np.asarray(want).tobytes()
        assert go.dtype == torch.bool and bool(go) == bool(wgo)


def test_bucket_relax_wrapper_cpu_uses_plain_version_and_checks_inputs():
    rng = np.random.default_rng(4)
    ip = torch.arange(0, 41 * 8, 8, dtype=torch.int32)       # 40 rows of 8
    idx = torch.tensor(rng.integers(0, 40, 320).astype(np.int32))
    w = torch.tensor(rng.uniform(1, 9, 320).astype(np.float32))
    d = torch.tensor(rng.uniform(0, 50, 40).astype(np.float32))
    hi = torch.tensor(25.0)
    before = t_kernel.bucket_relax.launches
    got = t_kernel.bucket_relax(d, ip, idx, w, hi)
    assert t_kernel.bucket_relax.launches == before
    want = bucket_relax_csr_ref(d, ip, idx, w, hi)
    assert torch.equal(got[0], want[0]) and bool(got[1]) == bool(want[1])
    ell = bucket_relax_ref(d, idx.view(40, 8), w.view(40, 8), hi)
    assert torch.equal(got[0], ell[0]) and bool(got[1]) == bool(ell[1])
    with pytest.raises(TypeError):
        t_kernel.bucket_relax(d, ip, idx, w, hi.double())
    with pytest.raises(ValueError):
        t_kernel.bucket_relax(d, ip, idx, w, hi.view(1))
    with pytest.raises(ValueError):
        t_kernel.bucket_relax(d, ip[:-1], idx, w, hi)


# every corpus at auto-Δ and Δ = 40; the small ones also at a narrow and an
# all-light width
ENGINE_CASES = [(c, d) for c in CORPORA for d in (None, 7.5, 40.0, 1e9)
                if not (c.endswith("_10k") and d in (7.5, 1e9))]


@pytest.mark.parametrize("corpus,delta", ENGINE_CASES)
def test_delta_engines_bitwise_vs_jax(corpus, delta):
    """Both port engines against the JAX engine (its kernel twin is bitwise
    equal to it by the JAX package's own tests); None is auto-Δ."""
    cg = CORPORA[corpus]()
    kw = {} if delta is None else {"delta": delta}
    want = j_sp(cg, 0, engine="delta_stepping", **kw)
    for eng in ("delta_stepping", "delta_stepping_kernel"):
        same_result(T.shortest_paths(carry(cg), 0, engine=eng, device="cpu",
                                     **kw), want)


@pytest.mark.parametrize("corpus,delta", [("road", None), ("hub", 30.0)])
def test_delta_kernel_bitwise_vs_jax_kernel_engine(corpus, delta):
    cg = CORPORA[corpus]()
    kw = {} if delta is None else {"delta": delta}
    want = j_sp(cg, 3, engine="delta_stepping_kernel", **kw)
    same_result(T.shortest_paths(carry(cg), 3, engine="delta_stepping_kernel",
                                 device="cpu", **kw), want)


@pytest.mark.parametrize("cap", [0, 1, 2])
def test_delta_max_sweeps_parity(cap):
    cg = CORPORA["hub"]()
    want = j_sp(cg, 0, engine="delta_stepping", delta=20.0, max_sweeps=cap)
    for eng in ("delta_stepping", "delta_stepping_kernel"):
        got = T.shortest_paths(carry(cg), 0, engine=eng, device="cpu",
                               delta=20.0, max_sweeps=cap)
        same_result(got, want)
        assert got.converged is False


def test_edges_relaxed_is_int64_and_exact():
    """The port counts edges in Python ints (int64 on the device): the
    light-pass charge j * m_light is not reduced mod 2**32."""
    cg = TC.road_like_csr_graph(2500, seed=0)
    res = T.shortest_paths(cg, 0, engine="delta_stepping", device="cpu")
    assert isinstance(res.edges_relaxed, int)
    assert res.edges_relaxed % cg.nnz == 0       # all-light: passes * nnz
