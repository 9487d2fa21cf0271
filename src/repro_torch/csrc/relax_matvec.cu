// Dense min-plus matvec: the kernel of the bellman_kernel engine (the
// paper's CUDA Alg. 4 as one relaxation sweep over the adjacency matrix).
//
// Replaces the Pallas TPU kernel src/repro/kernels/sssp_relax/kernel.py:
// relax_matvec (body _relax_matvec_kernel), with the self-distance fold
// that its ops wrapper applied:
//
//     out[v] = min(dist[v], min_u dist[u] + adj[u, v])
//
// adj is (n, n) float32, row-major, row u = the arcs out of u.  ``out``
// starts as a copy of dist (the wrapper clones it); the kernel only reads
// the snapshot ``dist``, so the sweep has Jacobi semantics.
//
// The TPU kernel walked u as a sequential grid axis and accumulated into
// its out block.  Blocks on the H100 run in no order, so the u range is
// split across blocks and the partial minima are combined with an
// atomicMin on the int32 bit pattern of out[v].  For floats >= +0 and
// +inf the int32 order of the bit patterns is the float order; every
// label and every adj entry is +0, positive or +inf, so every candidate
// is too, and min does not depend on the order of the updates: the
// result is bitwise deterministic and equal to the plain version's.
//
// Bound on the H100: memory bytes.  Each row u with a finite dist[u] is
// streamed once (4n bytes), plus dist read and out written (8n bytes);
// at most 2 float32 operations per 4-byte element.  A row whose dist[u]
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
// dist[u0 : u0 + 256] in shared memory per tile and walks the tile's rows
// with the loads unrolled.  Index arithmetic is 64-bit: u * n + v passes
// INT_MAX at n > 46,340.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                 // columns a block = rows a tile
constexpr long long kTargetBlocks = 2048;     // ~16 blocks an SM on 132 SMs

__global__ void relax_matvec_kernel(const float* __restrict__ dist,
                                    const float* __restrict__ adj,
                                    float* out, long long n,
                                    long long rows_per_split) {
  __shared__ float sd[kThreads];
  const long long v = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const long long u_lo = static_cast<long long>(blockIdx.y) * rows_per_split;
  const long long u_hi = u_lo + rows_per_split < n ? u_lo + rows_per_split : n;
  const bool col = v < n;
  const float* a = adj + v;
  const float kInf = __int_as_float(0x7f800000);
  float acc = kInf;
  for (long long u0 = u_lo; u0 < u_hi; u0 += kThreads) {
    const int rows = static_cast<int>(u_hi - u0 < kThreads ? u_hi - u0
                                                            : kThreads);
    __syncthreads();                          // the last tile is consumed
    if (threadIdx.x < rows) sd[threadIdx.x] = dist[u0 + threadIdx.x];
    __syncthreads();
    if (!col) continue;
    const float* arow = a + u0 * n;
#pragma unroll 8
    for (int k = 0; k < rows; ++k) {
      const float du = sd[k];
      if (du != kInf) {
        acc = fminf(acc, du + __ldg(arow + static_cast<long long>(k) * n));
      }
    }
  }
  if (col && acc < out[v]) {
    atomicMin(reinterpret_cast<int*>(out) + v, __float_as_int(acc));
  }
}

}  // namespace

extern "C" int relax_matvec_launch(const float* dist, const float* adj,
                                   float* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const long long tiles = (n + kThreads - 1) / kThreads;  // = v-blocks
  long long splits = (kTargetBlocks + tiles - 1) / tiles;
  splits = splits > tiles ? tiles : splits;
  const long long rows_per_split =
      ((tiles + splits - 1) / splits) * kThreads;
  splits = (n + rows_per_split - 1) / rows_per_split;
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>(splits));
  relax_matvec_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      dist, adj, out, n, rows_per_split);
  return static_cast<int>(cudaGetLastError());
}
