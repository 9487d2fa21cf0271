"""PyTorch / CUDA port of the SSSP engines in ``repro``.

The JAX package ``repro`` is the reference; this package answers the same
queries with the same results (bitwise distances, the same predecessor
tie-breaks and work counters) on an NVIDIA H100.  It imports ``torch`` and
``numpy`` only: the graph containers it needs are kept as its own copies.

    from repro_torch.core.api import shortest_paths
    from repro_torch.core.csr import sparse_csr_graph
    res = shortest_paths(sparse_csr_graph(100_000), 0, engine="frontier_kernel")

Entry points run on the GPU (``device="cuda"``) unless the caller asks for
the CPU, where every kernel wrapper uses its plain PyTorch version.
"""
