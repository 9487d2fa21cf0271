"""The port's graph containers (repro_torch.core.graph / csr) against the
JAX package's: the same seed must give byte-identical arrays and views."""
import numpy as np
import pytest
import torch

from repro.core import csr as JC
from repro.core import graph as JG
from repro_torch.core import csr as TC
from repro_torch.core import graph as TG


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # small tensors: intra-op threads only add contention under xdist
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


CORPORA = [
    ("sparse", lambda M: M.sparse_csr_graph(257, seed=3)),
    ("sparse_big", lambda M: M.sparse_csr_graph(10_000, seed=0)),
    ("road", lambda M: M.road_like_csr_graph(1000, seed=1)),
    ("hub", lambda M: M.skewed_hub_csr_graph(3000, seed=2)),
    ("directed", lambda M: M.random_csr_graph(300, 900, seed=4,
                                               directed=True)),
    ("disconnected", lambda M: M.random_csr_graph(200, 150, seed=5,
                                                   connected=False)),
    ("single_vertex", lambda M: M.random_csr_graph(1, 0, seed=0)),
    ("edgeless", lambda M: M.random_csr_graph(6, 0, seed=0,
                                              connected=False)),
]


@pytest.mark.parametrize("name,make", CORPORA, ids=[c[0] for c in CORPORA])
def test_generators_and_views_byte_identical(name, make):
    j, t = make(JC), make(TC)
    assert (t.n, t.directed, t.nnz, t.num_edges) == (
        j.n, j.directed, j.nnz, j.num_edges)
    for f in ("indptr", "indices", "weights"):
        assert _same(getattr(t, f), getattr(j, f)), f
    assert _same(t.dst_ids(), j.dst_ids())
    for a, b in zip(t.ell(), j.ell()):
        assert _same(a, b)
    for a, b in zip(t.out_csr(), j.out_csr()):
        assert _same(a, b)
    for a, b in zip(t.out_ell(), j.out_ell()):
        assert _same(a, b)
    w = np.asarray(j.weights)
    for delta in ([50.0, float(np.median(w))] if w.size else [1.0]):
        for a, b in zip(t.light_in_ell(delta), j.light_in_ell(delta)):
            assert _same(a, b)
        for a, b in zip(t.heavy_out_csr(delta), j.heavy_out_csr(delta)):
            assert _same(a, b)
    if t.n <= 1000:
        assert _same(t.to_dense().adj, j.to_dense().adj)


def test_edge_list_generators_identical():
    for a, b in zip(TG.random_edge_list(500, 1500, seed=7),
                    JG.random_edge_list(500, 1500, seed=7)):
        assert _same(a, b)
    for a, b in zip(TG.road_like_edge_list(777, seed=7),
                    JG.road_like_edge_list(777, seed=7)):
        assert _same(a, b)
    for a, b in zip(TG.skewed_hub_edge_list(900, seed=7),
                    JG.skewed_hub_edge_list(900, seed=7)):
        assert _same(a, b)


def test_dense_graph_and_to_csr_identical():
    j = JG.random_graph(120, 400, seed=9, directed=True)
    t = TG.random_graph(120, 400, seed=9, directed=True)
    assert _same(t.adj, j.adj) and t.num_edges == j.num_edges
    jc, tc = j.to_csr(), t.to_csr()
    assert tc is t.to_csr()                         # memoized
    for f in ("indptr", "indices", "weights"):
        assert _same(getattr(tc, f), getattr(jc, f))


@pytest.mark.parametrize("mask_kind", ["empty_rows", "trailing_empty",
                                       "all_false", "no_arcs"])
def test_masked_row_counts_matches_reference(mask_kind):
    rng = np.random.default_rng(0)
    if mask_kind == "no_arcs":
        indptr, mask = np.zeros(5, np.int64), np.zeros(0, bool)
    else:
        deg = rng.integers(0, 4, 40)
        deg[::7] = 0
        if mask_kind == "trailing_empty":
            deg[-3:] = 0
        indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
        mask = rng.random(int(indptr[-1])) < 0.5
        if mask_kind == "all_false":
            mask[:] = False
    n = indptr.shape[0] - 1
    got = TC._masked_row_counts(mask, indptr, n)
    assert _same(got, JC._masked_row_counts(mask, indptr, n))


def test_from_arrays_copies_and_freezes():
    j = JC.sparse_csr_graph(300, seed=1)
    src = [np.array(a) for a in (j.indptr, j.indices, j.weights)]
    t = TC.from_arrays(*src, j.n, j.directed)
    src[2][:] = 0.0                               # caller's buffers stay its own
    assert _same(t.weights, j.weights)
    assert not t.weights.flags.writeable and not t.indptr.flags.writeable
    with pytest.raises(ValueError):
        t.weights[0] = 1.0
    idx, _ = t.ell()
    assert not idx.flags.writeable


@pytest.mark.parametrize("bad", ["indptr_len", "weights_len", "indptr_end",
                                 "falling", "src_range"])
def test_from_arrays_rejects_bad_input(bad):
    j = JC.sparse_csr_graph(50, seed=1)
    ip, ix, w = (np.array(a) for a in (j.indptr, j.indices, j.weights))
    if bad == "indptr_len":
        ip = ip[:-1]
    elif bad == "weights_len":
        w = w[:-1]
    elif bad == "indptr_end":
        ip[-1] += 1
    elif bad == "falling":
        ip[5], ip[6] = ip[6] + 1, ip[5]
    else:
        ix[0] = j.n
    with pytest.raises((ValueError, IndexError)):
        TC.from_arrays(ip, ix, w, j.n)
