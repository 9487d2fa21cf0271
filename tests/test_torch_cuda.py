"""The CUDA kernels on the card: each against its plain PyTorch version,
bitwise, and the kernel engines on the GPU against the CPU path.  The
dense kernels run at n in {1, 37, 255, 4097} and S in {1, 3, 8, 9}, so
ragged tails, u-split boundaries and ragged source tiles are covered.

Marked ``cuda``; every test skips without a CUDA GPU.  On a machine with
one:  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import csr as TC
from repro_torch.core import frontier as TF
from repro_torch.core import graph as TG
from repro_torch.core.api import shortest_paths
from repro_torch.kernels.bucket_relax.kernel import bucket_relax
from repro_torch.kernels.bucket_relax.ref import bucket_relax_ref
from repro_torch.kernels.csr_relax.kernel import ell_relax
from repro_torch.kernels.csr_relax.ref import ell_relax_ref
from repro_torch.kernels.frontier_relax.kernel import frontier_relax
from repro_torch.kernels.frontier_relax.ref import frontier_relax_ref
from repro_torch.kernels.sssp_relax.kernel import (relax_matmul, relax_matvec,
                                                   relax_matvec_frontier)
from repro_torch.kernels.sssp_relax.ref import (relax_sweep_frontier_ref,
                                                relax_sweep_multi_ref,
                                                relax_sweep_ref)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _dist(n, seed, device):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0, 1000, n).astype(np.float32)
    d[rng.random(n) < 0.3] = np.inf
    return torch.tensor(d, device=device)


@pytest.mark.parametrize("n", [20, 255, 100_001])
def test_ell_and_bucket_kernels_bitwise_vs_plain(cuda, n):
    cg = TC.skewed_hub_csr_graph(n, seed=n)
    idx, w = (torch.tensor(a, device=cuda) for a in cg.ell())
    d = _dist(cg.n, n, cuda)
    before = ell_relax.launches
    assert _bits(ell_relax(d, idx, w), ell_relax_ref(d, idx, w))
    assert ell_relax.launches == before + 1
    for hi in (0.0, 500.0, float("inf")):
        h = torch.tensor(hi, device=cuda)
        (a, ga), (b, gb) = bucket_relax(d, idx, w, h), bucket_relax_ref(
            d, idx, w, h)
        assert _bits(a, b) and bool(ga) == bool(gb)


def test_frontier_kernel_bitwise_vs_plain(cuda):
    cg = TC.skewed_hub_csr_graph(50_000, seed=3)
    ops = TF.frontier_operands(cg, device=cuda)
    d = _dist(cg.n, 3, cuda)
    for frac in (0.0, 0.01, 0.5):
        on = torch.tensor(np.random.default_rng(1).random(cg.n) < frac,
                          device=cuda)
        fids = torch.cat([torch.nonzero(on).flatten(),
                          torch.full((3,), cg.n, device=cuda)])
        args = (d, fids, ops["out_indptr"], ops["out_dst"], ops["out_w"])
        assert _bits(frontier_relax(*args), frontier_relax_ref(*args))


@pytest.mark.parametrize("corpus", ["sparse", "road", "hub"])
def test_kernel_engines_on_gpu_match_cpu(cuda, corpus):
    make = {"sparse": TC.sparse_csr_graph, "road": TC.road_like_csr_graph,
            "hub": TC.skewed_hub_csr_graph}[corpus]
    cg = make(40_000, seed=5)
    for eng in ("bellman_csr_kernel", "frontier_kernel",
                "delta_stepping_kernel"):
        g = shortest_paths(cg, 0, engine=eng, device=cuda)
        c = shortest_paths(cg, 0, engine=eng, device="cpu")
        assert g.dist.tobytes() == c.dist.tobytes()
        assert np.array_equal(g.pred, c.pred)
        assert (g.sweeps, g.edges_relaxed) == (c.sweeps, c.edges_relaxed)


@pytest.mark.parametrize("n", [1, 37, 255, 4097])
def test_dense_kernels_bitwise_vs_plain(cuda, n):
    adj = torch.tensor(TG.random_graph(n, 4 * n, seed=n).adj, device=cuda)
    d = _dist(n, n, cuda)
    before = relax_matvec.launches
    assert _bits(relax_matvec(d, adj), relax_sweep_ref(d, adj))
    assert relax_matvec.launches == before + 1
    on = torch.tensor(np.random.default_rng(n).random(n) < 0.5, device=cuda)
    got = relax_matvec_frontier(d, on, adj)
    assert _bits(got, relax_sweep_frontier_ref(d, on, adj))
    masked = torch.where(on, d, torch.inf)
    assert _bits(got, torch.minimum(d, relax_matvec(masked, adj)))
    for S in (1, 3, 8, 9):
        D = torch.stack([_dist(n, n + s, cuda) for s in range(S)])
        assert _bits(relax_matmul(D, adj), relax_sweep_multi_ref(D, adj))


@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_dense_engines_on_gpu_match_cpu(cuda, kind):
    g = (TG.sparse_graph(3000, seed=2) if kind == "sparse"
         else TG.dense_graph(500, seed=2))
    for eng in ("bellman_kernel", "bellman"):
        a = shortest_paths(g, 0, engine=eng, device=cuda)
        c = shortest_paths(g, 0, engine=eng, device="cpu")
        assert a.dist.tobytes() == c.dist.tobytes()
        assert np.array_equal(a.pred, c.pred) and a.sweeps == c.sweeps
    srcs = np.array([0, 5, 17])
    a = shortest_paths(g, srcs, engine="multisource", device=cuda)
    c = shortest_paths(g, srcs, engine="multisource", device="cpu")
    assert a.dist.tobytes() == c.dist.tobytes() and a.sweeps == c.sweeps
