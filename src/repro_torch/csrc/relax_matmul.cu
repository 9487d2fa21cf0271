// Dense min-plus matmul: one batched relaxation sweep for S sources at
// once (the multi-source fixpoint's sweep).
//
// Replaces the Pallas TPU kernel src/repro/kernels/sssp_relax/kernel.py:
// relax_matmul (body _relax_matmul_kernel), with the self-distance fold
// that its ops wrapper applied:
//
//     out[s, v] = min(D[s, v], min_u D[s, u] + adj[u, v])
//
// D and out are (S, n) float32, adj (n, n) float32, all row-major.
// ``out`` starts as a copy of D (the wrapper clones it); the kernel only
// reads the snapshot D.
//
// The TPU kernel walked u as a sequential grid axis.  Here the u range is
// split across blocks and the partial minima are combined with an
// atomicMin on the int32 bit pattern of out[s, v], exact for labels and
// weights that are +0, positive or +inf (see relax_matvec.cu), so the
// result is bitwise equal to the plain version's.
//
// Bound on the H100: memory bytes while S is small.  adj is streamed
// once per tile of 8 sources (4n² bytes at S <= 8), D read and out
// written (8Sn bytes); 2S float32 operations per adj element, so the
// operations bound only passes the bytes bound near S ~ 40.  A row u
// whose D[s, u] is +inf for every source of the tile contributes nothing,
// so a block skips it (a shared-memory flag, uniform across the block).
//
// Design: one thread per column v holding 8 accumulators (one per source
// of the tile) in registers; D[s-tile, u-tile] sits in shared memory, so
// each adj element is loaded once per tile of sources and used 8 times.
// The grid is (v-blocks, source tiles, u-splits) with ~2048 blocks on the
// card.  Ragged S and ragged n are masked, not padded.  Index arithmetic
// is 64-bit.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                 // columns a block = rows a tile
constexpr int kS = 8;                         // sources a tile
constexpr long long kTargetBlocks = 2048;     // ~16 blocks an SM on 132 SMs

__global__ void relax_matmul_kernel(const float* __restrict__ D,
                                    const float* __restrict__ adj,
                                    float* out, long long S, long long n,
                                    long long rows_per_split) {
  __shared__ float sD[kS][kThreads];
  __shared__ int live[kThreads];
  const long long v = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const long long s0 = static_cast<long long>(blockIdx.y) * kS;
  const long long u_lo = static_cast<long long>(blockIdx.z) * rows_per_split;
  const long long u_hi = u_lo + rows_per_split < n ? u_lo + rows_per_split : n;
  const bool col = v < n;
  const float* a = adj + v;
  const float kInf = __int_as_float(0x7f800000);
  float acc[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) acc[s] = kInf;
  for (long long u0 = u_lo; u0 < u_hi; u0 += kThreads) {
    const int rows = static_cast<int>(u_hi - u0 < kThreads ? u_hi - u0
                                                            : kThreads);
    __syncthreads();                          // the last tile is consumed
    if (threadIdx.x < rows) {
      const long long u = u0 + threadIdx.x;
      bool any = false;
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const float d = s0 + s < S ? D[(s0 + s) * n + u] : kInf;
        sD[s][threadIdx.x] = d;
        any |= d != kInf;
      }
      live[threadIdx.x] = any;
    }
    __syncthreads();
    if (!col) continue;
    const float* arow = a + u0 * n;
#pragma unroll 4
    for (int k = 0; k < rows; ++k) {
      if (live[k]) {
        const float w = __ldg(arow + static_cast<long long>(k) * n);
#pragma unroll
        for (int s = 0; s < kS; ++s) acc[s] = fminf(acc[s], sD[s][k] + w);
      }
    }
  }
  if (!col) return;
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    if (s0 + s < S) {
      float* o = out + (s0 + s) * n + v;
      if (acc[s] < *o) {
        atomicMin(reinterpret_cast<int*>(o), __float_as_int(acc[s]));
      }
    }
  }
}

}  // namespace

extern "C" int relax_matmul_launch(const float* D, const float* adj,
                                   float* out, long long S, long long n,
                                   void* stream) {
  if (n <= 0 || S <= 0) return 0;
  const long long tiles = (n + kThreads - 1) / kThreads;  // = v-blocks
  const long long stiles = (S + kS - 1) / kS;
  long long splits = (kTargetBlocks + tiles * stiles - 1) / (tiles * stiles);
  splits = splits > tiles ? tiles : splits;
  const long long rows_per_split =
      ((tiles + splits - 1) / splits) * kThreads;
  splits = (n + rows_per_split - 1) / rows_per_split;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(stiles),
                  static_cast<unsigned>(splits));
  relax_matmul_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      D, adj, out, S, n, rows_per_split);
  return static_cast<int>(cudaGetLastError());
}
