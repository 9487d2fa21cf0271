"""The plain reference against a heap Dijkstra in float32 path sums, its
components, and its control in bfloat16."""
import heapq

import numpy as np
import torch

from sssp_bench import loader, reference
from sssp_bench.graphs import kronecker
from sssp_bench.inputs import EdgeList


def heap_dijkstra_f32(edges: EdgeList, root: int) -> np.ndarray:
    adj = [[] for _ in range(edges.n)]
    for a, b, w in zip(edges.u.tolist(), edges.v.tolist(),
                       edges.w.numpy().astype(np.float32)):
        adj[a].append((b, w))
        adj[b].append((a, w))
    dist = np.full(edges.n, np.inf, np.float32)
    dist[root] = 0
    heap = [(np.float32(0), root)]
    done = np.zeros(edges.n, bool)
    while heap:
        d, x = heapq.heappop(heap)
        if done[x]:
            continue
        done[x] = True
        for y, w in adj[x]:
            nd = np.float32(d + w)
            if nd < dist[y]:
                dist[y] = nd
                heapq.heappush(heap, (nd, y))
    return dist


def small_graphs():
    p = loader.load_config("graph500-s23")["params"] | {"scale": 8}
    yield kronecker.generate(p, 4, "cpu")
    # a sparser graph of the spec's generator: long paths, many components
    free = {k: v for k, v in p.items() if k != "graph_seed"}
    yield kronecker.generate(free | {"edgefactor": 2}, 4, "cpu")


def test_reference_is_bitwise_a_float32_heap_dijkstra():
    for edges in small_graphs():
        roots = [0, 7, edges.n - 1]
        ref = reference.distances(edges, roots, chunk=2)
        for row, r in zip(ref, roots):
            want = heap_dijkstra_f32(edges, r)
            np.testing.assert_array_equal(row.view(np.uint32),
                                          want.view(np.uint32))


def test_components_join_exactly_the_connected_vertices():
    edges = EdgeList(7, torch.tensor([0, 1, 4, 5]), torch.tensor([1, 2, 5, 4]),
                     torch.ones(4))
    lab = reference.components(edges).numpy()
    assert lab[0] == lab[1] == lab[2]
    assert lab[4] == lab[5]
    assert len({lab[0], lab[3], lab[4], lab[6]}) == 4
    p = loader.load_config("graph500-s23")["params"] | {"scale": 9}
    edges = kronecker.generate(p, 3, "cpu")
    lab = reference.components(edges)
    row = reference.distances(edges, [int(edges.u[0])])[0]
    reached = np.isfinite(row)
    assert np.array_equal(reached, (lab == lab[int(edges.u[0])]).numpy())


def test_control_in_bfloat16_differs_from_the_reference():
    for edges in small_graphs():
        roots = [1, 2, 3]
        ref = reference.distances(edges, roots)
        ctl = reference.distances(edges, roots, dtype=torch.bfloat16)
        assert (ctl.view(np.uint32) != ref.view(np.uint32)).sum() > edges.n
