"""The Kronecker generator and the program's input built from it."""
import numpy as np
import torch

from sssp_bench import loader
from sssp_bench.graphs import kronecker
from sssp_bench.inputs import EdgeList, incoming_csr


def test_incoming_csr_merges_duplicates_and_drops_self_loops():
    edges = EdgeList(4, torch.tensor([0, 1, 0, 2, 3]),
                     torch.tensor([1, 0, 2, 2, 3]),
                     torch.tensor([5.0, 3.0, 1.0, 7.0, 2.0]))
    indptr, indices, weights = incoming_csr(edges)
    np.testing.assert_array_equal(indptr, [0, 2, 3, 4, 4])
    np.testing.assert_array_equal(indices, [1, 2, 0, 0])
    np.testing.assert_array_equal(weights, [3.0, 1.0, 3.0, 1.0])
    np.testing.assert_array_equal(np.diff(indptr), [2, 1, 1, 0])


def test_kronecker_is_deterministic_from_the_seed():
    p = loader.load_config("graph500-s23")["params"] | {"scale": 10}
    a = kronecker.generate(p, 2**33 + 9, "cpu")
    b = kronecker.generate(p, 2**33 + 9, "cpu")
    c = kronecker.generate(p, 2**33 + 10, "cpu")
    assert a.n == 1024 and a.u.numel() == 16 * 1024
    for x, y in ((a.u, b.u), (a.v, b.v), (a.w, b.w)):
        assert torch.equal(x, y)
    assert not torch.equal(a.u, c.u)
    assert float(a.w.min()) >= 0.0 and float(a.w.max()) < 1.0


def test_kronecker_degrees_are_skewed_like_graph500():
    p = loader.load_config("graph500-s23")["params"] | {"scale": 12}
    edges = kronecker.generate(p, 11, "cpu")
    deg = np.diff(incoming_csr(edges)[0])
    mean = deg[deg > 0].mean()
    # hubs far above the mean, and a share of isolated vertices
    assert deg.max() > 20 * mean
    assert 0.05 < (deg == 0).mean() < 0.6
    # the label permutation spreads the hubs over the id space
    top = np.argsort(deg)[-16:]
    assert top.max() - top.min() > edges.n // 4


def test_a_graph_seed_gives_every_run_an_isomorphic_graph():
    p = loader.load_config("graph500-s23")["params"] | {"scale": 9}
    assert "graph_seed" in p
    a = kronecker.generate(p, 2**33 + 1, "cpu")
    b = kronecker.generate(p, 2**33 + 2, "cpu")
    assert not torch.equal(a.u, b.u)
    inv_a = torch.as_tensor(np.argsort(a.labels))
    inv_b = torch.as_tensor(np.argsort(b.labels))
    assert torch.equal(inv_a[a.u], inv_b[b.u])
    assert torch.equal(inv_a[a.v], inv_b[b.v])
    assert torch.equal(a.w, b.w)
    free = {k: v for k, v in p.items() if k != "graph_seed"}
    c = kronecker.generate(free, 2**33 + 1, "cpu")
    assert c.labels is None
