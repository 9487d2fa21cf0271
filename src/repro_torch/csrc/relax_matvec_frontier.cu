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
// This is relax_matvec.cu with the mask applied where a tile of dist is
// staged in shared memory: a row off the frontier becomes +inf there, and
// the kernel skips every +inf row.  The partial minima of the u-splits
// are combined with an atomic min on the bit pattern of out[v], exact
// for labels and weights that are +0, positive or +inf (see
// relax_matvec.cu), so the result is bitwise equal to the plain version.
//
// Bound on the H100: memory bytes.  Each row u on the frontier with a
// finite dist[u] is streamed once (n elements of 4 or 2 bytes), plus dist
// and frontier read and out written (2n elements and n bytes).
//
// Design: as relax_matvec.cu — one thread per column, a (v-blocks,
// u-splits) grid of ~2048 blocks, the dist tile in shared memory, 64-bit
// index arithmetic, one 2-byte load a thread for 16-bit elements.
#include <cuda_runtime.h>

#include "min_plus_types.cuh"

namespace {

constexpr int kThreads = 256;                 // columns a block = rows a tile
constexpr long long kTargetBlocks = 2048;     // ~16 blocks an SM on 132 SMs

template <typename T>
__global__ void relax_matvec_frontier_kernel(
    const T* __restrict__ dist, const unsigned char* __restrict__ frontier,
    const T* __restrict__ adj, T* out, long long n,
    long long rows_per_split) {
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
    if (threadIdx.x < rows) {
      const long long u = u0 + threadIdx.x;
      sd[threadIdx.x] = frontier[u] ? min_plus::widen(dist[u]) : kInf;
    }
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
int launch(const T* dist, const unsigned char* frontier, const T* adj,
           T* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const long long tiles = (n + kThreads - 1) / kThreads;  // = v-blocks
  long long splits = (kTargetBlocks + tiles - 1) / tiles;
  splits = splits > tiles ? tiles : splits;
  const long long rows_per_split =
      ((tiles + splits - 1) / splits) * kThreads;
  splits = (n + rows_per_split - 1) / rows_per_split;
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>(splits));
  relax_matvec_frontier_kernel<T><<<grid, kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      dist, frontier, adj, out, n, rows_per_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int relax_matvec_frontier_launch(const float* dist,
                                            const unsigned char* frontier,
                                            const float* adj, float* out,
                                            long long n, void* stream) {
  return launch(dist, frontier, adj, out, n, stream);
}

extern "C" int relax_matvec_frontier_bf16_launch(
    const __nv_bfloat16* dist, const unsigned char* frontier,
    const __nv_bfloat16* adj, __nv_bfloat16* out, long long n, void* stream) {
  return launch(dist, frontier, adj, out, n, stream);
}

extern "C" int relax_matvec_frontier_f16_launch(
    const __half* dist, const unsigned char* frontier, const __half* adj,
    __half* out, long long n, void* stream) {
  return launch(dist, frontier, adj, out, n, stream);
}
