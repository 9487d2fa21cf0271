// Frontier-masked dense min-plus matvec: one relaxation sweep in which
// only the frontier's rows relax.
//
// Replaces the Pallas TPU kernel src/repro/kernels/sssp_relax/kernel.py:
// relax_matvec_frontier (body _relax_matvec_frontier_kernel), with the
// self-distance fold that its ops wrapper applied:
//
//     out[v] = min(dist[v], min_{u : frontier[u]} dist[u] + adj[u, v])
//
// adj is (n, n), row-major; frontier is (n,) bool (one byte a vertex).
// dist, adj and out share one element type, float32, bfloat16 or float16
// (one C entry each), with float32 arithmetic (min_plus_types.cuh).
// ``out`` starts as a copy of the unmasked dist (the wrapper clones it);
// the kernel only reads the snapshot ``dist``.
//
// This is relax_matvec.cu with the mask applied where a tile of rows is
// staged: a row off the frontier is not live, so it is never read.  The
// partial minima of the blocks are combined with an atomic min on the
// bit pattern of out[v], exact for labels and weights that are +0,
// positive or +inf (see relax_matvec.cu), so the result is bitwise equal
// to the plain version.
//
// Bound on the H100: memory bytes.  Each row u on the frontier with a
// finite dist[u] is streamed once (n elements of 4 or 2 bytes), plus dist
// and frontier read and out written (2n elements and n bytes).
//
// Design (min_plus_matvec.cuh): as relax_matvec.cu, the list of live rows
// compacted from the tile's frontier rows with a finite label, so the
// inner loop walks about a third of the rows of a 50% frontier.
#include "min_plus_matvec.cuh"

extern "C" int relax_matvec_frontier_launch(const float* dist,
                                            const unsigned char* frontier,
                                            const float* adj, float* out,
                                            long long n, void* stream) {
  return min_plus_matvec::sweep<true>(dist, frontier, adj, out, n, stream);
}

extern "C" int relax_matvec_frontier_bf16_launch(
    const __nv_bfloat16* dist, const unsigned char* frontier,
    const __nv_bfloat16* adj, __nv_bfloat16* out, long long n, void* stream) {
  return min_plus_matvec::sweep<true>(dist, frontier, adj, out, n, stream);
}

extern "C" int relax_matvec_frontier_f16_launch(
    const __half* dist, const unsigned char* frontier, const __half* adj,
    __half* out, long long n, void* stream) {
  return min_plus_matvec::sweep<true>(dist, frontier, adj, out, n, stream);
}
