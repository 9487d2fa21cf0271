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
// its out block.  Blocks on the H100 run in no order, so the u range is
// split across blocks and the partial minima are combined with an
// atomic min on the bit pattern of out[v] (atomicMin on int32 for
// float32, a CAS on the 32-bit word for 16 bits).  For floats >= +0 and
// +inf the order of the bit patterns is the float order; every
// label and every adj entry is +0, positive or +inf, so every candidate
// is too, and min does not depend on the order of the updates: the
// result is bitwise deterministic and equal to the plain version's.
//
// Bound on the H100: memory bytes.  Each row u with a finite dist[u] is
// streamed once (n elements of 4 or 2 bytes), plus dist read and out
// written (2n elements); at most 2 float32 operations per element.  A row whose dist[u]
// is +inf contributes +inf to every column, so a block skips it (the test
// reads shared memory and is uniform across the block: no divergence) —
// the bytes the function needs are those of the finite rows only.
//
// Design: one thread per column v (256 columns a block), so the reads of
// a row slice adj[u, v0 : v0 + 256] are coalesced and dist[u] is a
// broadcast from shared memory.  The grid is (v-blocks, u-splits): at
// n = 40,000 there are only 157 v-blocks for 132 SMs, far too few bytes
// in flight to stream 6.4 GB, so each v-block's u range is cut into
// enough splits to put ~2048 blocks on the card.  Each block stages
// dist[u0 : u0 + 256] in shared memory per tile (widened to float32) and
// walks the tile's rows with the loads unrolled.  A 16-bit element is one
// 2-byte load a thread, so odd n (rows 2-byte aligned) needs no other
// path.  Index arithmetic is 64-bit: u * n + v passes INT_MAX at
// n > 46,340.
#include <cuda_runtime.h>

#include "min_plus_types.cuh"

namespace {

constexpr int kThreads = 256;                 // columns a block = rows a tile
constexpr long long kTargetBlocks = 2048;     // ~16 blocks an SM on 132 SMs

template <typename T>
__global__ void relax_matvec_kernel(const T* __restrict__ dist,
                                    const T* __restrict__ adj, T* out,
                                    long long n, long long rows_per_split) {
  __shared__ float sd[kThreads];
  const long long v = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const long long u_lo = static_cast<long long>(blockIdx.y) * rows_per_split;
  const long long u_hi = u_lo + rows_per_split < n ? u_lo + rows_per_split : n;
  const bool col = v < n;
  const T* a = adj + v;
  const float kInf = __int_as_float(0x7f800000);
  float acc = kInf;
  for (long long u0 = u_lo; u0 < u_hi; u0 += kThreads) {
    const int rows = static_cast<int>(u_hi - u0 < kThreads ? u_hi - u0
                                                            : kThreads);
    __syncthreads();                          // the last tile is consumed
    if (threadIdx.x < rows)
      sd[threadIdx.x] = min_plus::widen(dist[u0 + threadIdx.x]);
    __syncthreads();
    if (!col) continue;
    const T* arow = a + u0 * n;
#pragma unroll 8
    for (int k = 0; k < rows; ++k) {
      const float du = sd[k];
      if (du != kInf) {
        acc = fminf(acc, du + min_plus::load(arow +
                                             static_cast<long long>(k) * n));
      }
    }
  }
  if (col) min_plus::atomic_min(out + v, acc);
}

template <typename T>
int launch(const T* dist, const T* adj, T* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const long long tiles = (n + kThreads - 1) / kThreads;  // = v-blocks
  long long splits = (kTargetBlocks + tiles - 1) / tiles;
  splits = splits > tiles ? tiles : splits;
  const long long rows_per_split =
      ((tiles + splits - 1) / splits) * kThreads;
  splits = (n + rows_per_split - 1) / rows_per_split;
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>(splits));
  relax_matvec_kernel<T><<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      dist, adj, out, n, rows_per_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int relax_matvec_launch(const float* dist, const float* adj,
                                   float* out, long long n, void* stream) {
  return launch(dist, adj, out, n, stream);
}

extern "C" int relax_matvec_bf16_launch(const __nv_bfloat16* dist,
                                        const __nv_bfloat16* adj,
                                        __nv_bfloat16* out, long long n,
                                        void* stream) {
  return launch(dist, adj, out, n, stream);
}

extern "C" int relax_matvec_f16_launch(const __half* dist, const __half* adj,
                                       __half* out, long long n,
                                       void* stream) {
  return launch(dist, adj, out, n, stream);
}
