// Dense min-plus matvec: the kernel of the bellman_kernel engine (the
// paper's CUDA Alg. 4 as one relaxation sweep over the adjacency matrix).
//
// Replaces the Pallas TPU kernel src/repro/kernels/sssp_relax/kernel.py:
// relax_matvec (body _relax_matvec_kernel), with the self-distance fold
// that its ops wrapper applied:
//
//     out[v] = min(dist[v], min_u dist[u] + adj[u, v])
//
// adj is (n, n), row-major, row u = the arcs out of u; dist, adj and out
// share one element type, float32, bfloat16 or float16 (one C entry
// each), and the arithmetic is float32 (min_plus_types.cuh says why a
// 16-bit sweep rounded once at the end equals the plain version).  ``out``
// starts as a copy of dist (the wrapper clones it); the kernel only reads
// the snapshot ``dist``, so the sweep has Jacobi semantics.
//
// The TPU kernel walked u as a sequential grid axis and accumulated into
// its out block.  Blocks on the H100 run in no order, so each block takes
// a range of row tiles and the partial minima are combined with an
// atomic min on the bit pattern of out[v] (atomicMin on int32 for
// float32, a CAS on the 32-bit word for 16 bits).  For floats >= +0 and
// +inf the order of the bit patterns is the float order; every
// label and every adj entry is +0, positive or +inf, so every candidate
// is too, and min does not depend on the order of the updates: the
// result is bitwise deterministic and equal to the plain version's.
//
// Bound on the H100: memory bytes.  Each row u with a finite dist[u] is
// streamed once (n elements of 4 or 2 bytes), plus dist read and out
// written (2n elements); at most 2 float32 operations per element.  A row
// whose dist[u] is +inf contributes +inf to every column, so it is never
// read — the bytes the function needs are those of the finite rows only.
//
// Design (min_plus_matvec.cuh): 16-byte column loads over a compacted
// list of the finite rows of each tile, a balanced work list of (column
// block, row tile) items with as many blocks as the card holds.
#include "min_plus_matvec.cuh"

extern "C" int relax_matvec_launch(const float* dist, const float* adj,
                                   float* out, long long n, void* stream) {
  return min_plus_matvec::sweep<false>(dist, nullptr, adj, out, n, stream);
}

extern "C" int relax_matvec_bf16_launch(const __nv_bfloat16* dist,
                                        const __nv_bfloat16* adj,
                                        __nv_bfloat16* out, long long n,
                                        void* stream) {
  return min_plus_matvec::sweep<false>(dist, nullptr, adj, out, n, stream);
}

extern "C" int relax_matvec_f16_launch(const __half* dist, const __half* adj,
                                       __half* out, long long n,
                                       void* stream) {
  return min_plus_matvec::sweep<false>(dist, nullptr, adj, out, n, stream);
}
