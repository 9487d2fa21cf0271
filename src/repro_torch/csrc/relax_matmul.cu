// Dense min-plus matmul: one batched relaxation sweep for S sources at
// once (the multi-source fixpoint's sweep).
//
// Replaces the Pallas TPU kernel src/repro/kernels/sssp_relax/kernel.py:
// relax_matmul (body _relax_matmul_kernel), with the self-distance fold
// that its ops wrapper applied:
//
//     out[s, v] = min(D[s, v], min_u D[s, u] + adj[u, v])
//
// D and out are (S, n), adj (n, n), all row-major and of one element
// type, float32, bfloat16 or float16 (one C entry each), with float32
// arithmetic (min_plus_types.cuh says why a 16-bit sweep rounded once at
// the end equals the plain version).  ``out`` starts as a copy of D (the
// wrapper clones it); the kernel only reads the snapshot D.
//
// The TPU kernel walked u as a sequential grid axis.  Here the u range is
// split across blocks and the partial minima are combined with an
// atomic min on the bit pattern of out[s, v], exact for labels and
// weights that are +0, positive or +inf (see relax_matvec.cu), so the
// result is bitwise equal to the plain version's.
//
// Bound on the H100: memory bytes while S is small.  adj is streamed
// once per tile of 8 sources (n² elements of 4 or 2 bytes at S <= 8), D
// read and out written (2Sn elements).  Each adj element costs S adds and S mins; at
// S = 8 that is below the byte time at the card's add and min issue rates
// (PERF.md section 6 gives the rate measured by tools/min_plus_rate.py).
// A row u whose D[s, u] is +inf for every source of the tile contributes
// nothing, so it is never read.
//
// Design, for few instructions an adj element (the first design issued
// about 28, one scalar adj load and eight scalar shared loads among them;
// PERF.md section 6 has the times of both):
// - D is staged transposed in shared memory, a tile of 256 u rows at a
//   time: row i holds the tile's 8 source labels of one u, read as two
//   broadcast 16-byte loads (float4).
// - Each thread owns 4 consecutive columns, read as one 16-byte adj load
//   (8 bytes for 16-bit elements, widened in registers), so each D fetch
//   serves 4 elements: 8 × 4 accumulators in registers.  Rows are so
//   aligned only when n % 4 == 0 (all of the paper's sizes); for other n
//   the same kernel reads the 4 columns with 4 scalar loads, the columns
//   past n masked, not padded.
// - The tile's live rows (some source finite) are compacted into a list
//   by a block prefix count (a ballot a warp, the warps' counts in shared
//   memory), so the inner loop has no branch a row.
// - Loads in flight: each thread streams its live rows' 16 bytes through a
//   ring of 4 slots of its own in shared memory with cp.async, so 3 rows
//   are on their way while it folds one, without registers to hold them
//   (tools/relax_matmul_sweep.py times other depths; PERF.md section 6).
//   (The scalar path, the 16-bit elements, and a build with
//   RELAX_MATMUL_STAGES=0, read 4 rows into registers before folding
//   them.)
// - The work is a list of items, (source tile, block of 1024 columns,
//   tile of 256 u rows), cut into equal contiguous ranges, one a block,
//   with as many blocks as the card holds at once.  A block folds its
//   items into one set of accumulators and combines them into out (the
//   atomicMin above) whenever its column block or source tile changes
//   and at its end.  Every block has the same number of items, within
//   one, so no last wave of blocks runs part-full.
// Ragged S is masked.  Index arithmetic is 64-bit.
#include <cuda_runtime.h>

#include <cstdint>

#include "min_plus_types.cuh"

// tools/relax_matmul_sweep.py builds variants with other depths (0: no
// cp.async) to measure what the ring buys
#ifndef RELAX_MATMUL_STAGES
#define RELAX_MATMUL_STAGES 4
#endif

namespace {

constexpr int kThreads = 256;                 // threads a block = rows a tile
constexpr int kWarps = kThreads / 32;
constexpr int kS = 8;                         // sources a tile
constexpr int kC = 4;                         // columns a thread
constexpr int kCols = kThreads * kC;          // columns a block
constexpr int kBatch = 4;                     // adj rows loaded before use
constexpr unsigned kFull = 0xffffffffu;
// adj rows each thread keeps in flight with cp.async (16-byte path); 0
// loads kBatch rows into registers at a time instead
constexpr int kStages = RELAX_MATMUL_STAGES;
constexpr int kRing = kStages > 0 ? kStages : 1;  // the ring's slots

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// adj[row, v0 .. v0 + 3] widened to float32, +inf past column n
template <bool kVec, typename T>
__device__ __forceinline__ float4 load4(const T* __restrict__ p,
                                        long long v0, long long n) {
  if constexpr (kVec && sizeof(T) == 4) {
    return __ldg(reinterpret_cast<const float4*>(p));
  } else if constexpr (kVec) {
    return min_plus::widen4(__ldg(reinterpret_cast<const uint2*>(p)), T{});
  } else {
    const float inf = __int_as_float(0x7f800000);
    return make_float4(v0 < n ? min_plus::load(p) : inf,
                       v0 + 1 < n ? min_plus::load(p + 1) : inf,
                       v0 + 2 < n ? min_plus::load(p + 2) : inf,
                       v0 + 3 < n ? min_plus::load(p + 3) : inf);
  }
}

__device__ __forceinline__ void fold(float (&acc)[kC], float d, float4 w) {
  acc[0] = fminf(acc[0], d + w.x);
  acc[1] = fminf(acc[1], d + w.y);
  acc[2] = fminf(acc[2], d + w.z);
  acc[3] = fminf(acc[3], d + w.w);
}

__device__ __forceinline__ void fold_row(float (&acc)[kS][kC], float4 da,
                                         float4 db, float4 w) {
  fold(acc[0], da.x, w);
  fold(acc[1], da.y, w);
  fold(acc[2], da.z, w);
  fold(acc[3], da.w, w);
  fold(acc[4], db.x, w);
  fold(acc[5], db.y, w);
  fold(acc[6], db.z, w);
  fold(acc[7], db.w, w);
}

// out[s0 + s, v0 + c] = min(out[...], acc[s][c]) for the sources and
// columns in range
template <typename T>
__device__ __forceinline__ void combine(float (&acc)[kS][kC], T* out,
                                        long long s0, long long v0,
                                        long long S, long long n) {
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    if (s0 + s >= S) break;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      if (v0 + c < n) min_plus::atomic_min(out + (s0 + s) * n + v0 + c,
                                           acc[s][c]);
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    relax_matmul_kernel(const T* __restrict__ D, const T* __restrict__ adj,
                        T* out, long long S, long long n, long long vblocks,
                        long long utiles, long long items) {
  // the cp.async ring streams 16-byte float32 rows only
  constexpr bool kAsync = kVec && kStages > 0 && sizeof(T) == 4;
  __shared__ float4 sD[kThreads][2];          // live row i: its 8 labels
  __shared__ int sRow[kThreads];              // live row i: u - u0
  __shared__ int sCount[kWarps];              // live rows a warp
  __shared__ float4 ring[kAsync ? kRing : 1][kThreads];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float kInf = __int_as_float(0x7f800000);
  // items are ordered (source tile, column block, u tile), u tile fastest
  const long long first = items * blockIdx.x / gridDim.x;
  const long long last = items * (blockIdx.x + 1) / gridDim.x;
  long long held = -1;                        // the accumulators' tile pair
  long long s0 = 0, v0 = 0;
  float acc[kS][kC];

  for (long long it = first; it < last; ++it) {
    const long long pair = it / utiles;       // source tile * vblocks + cols
    const long long u0 = (it - pair * utiles) * kThreads;
    if (pair != held) {
      if (held >= 0) combine(acc, out, s0, v0, S, n);
      held = pair;
      s0 = pair / vblocks * kS;
      v0 = (pair % vblocks) * kCols + static_cast<long long>(threadIdx.x) * kC;
#pragma unroll
      for (int s = 0; s < kS; ++s)
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[s][c] = kInf;
    }
    // stage: thread t reads the 8 labels of row u0 + t, and the live rows
    // are packed in order at the front of sD / sRow
    float d[kS];
    bool live = false;
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const long long u = u0 + threadIdx.x;
      d[s] = u < n && s0 + s < S ? min_plus::widen(D[(s0 + s) * n + u])
                                 : kInf;
      live |= d[s] != kInf;
    }
    const unsigned ballot = __ballot_sync(kFull, live);
    __syncthreads();                          // the last tile is consumed
    if (lane == 0) sCount[warp] = __popc(ballot);
    __syncthreads();
    int base = 0, count = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const int c = sCount[k];
      base += k < warp ? c : 0;
      count += c;
    }
    if (live) {
      const int i = base + __popc(ballot & ((1u << lane) - 1u));
      sD[i][0] = make_float4(d[0], d[1], d[2], d[3]);
      sD[i][1] = make_float4(d[4], d[5], d[6], d[7]);
      sRow[i] = threadIdx.x;
    }
    __syncthreads();
    if (v0 >= n) continue;

    const T* a = adj + u0 * n + v0;
    if constexpr (kAsync) {
      // this thread's ring of kStages adj rows in flight: slot k of it is
      // mine[k * kThreads]; only this thread writes and reads it
      float4* mine = &ring[0][threadIdx.x];
#pragma unroll
      for (int q = 0; q < kStages - 1; ++q) {
        if (q < count)
          cp_async16(mine + q * kThreads,
                     a + static_cast<long long>(sRow[q]) * n);
        cp_async_commit();
      }
      for (int i = 0; i < count; ++i) {
        // refill the slot that row i - 1 used
        const int next = i + kStages - 1;
        if (next < count)
          cp_async16(mine + (next % kRing) * kThreads,
                     a + static_cast<long long>(sRow[next]) * n);
        cp_async_commit();
        cp_async_wait<kStages - 1>();         // row i has landed
        fold_row(acc, sD[i][0], sD[i][1], mine[(i % kRing) * kThreads]);
      }
    } else {
      int i = 0;
      for (; i + kBatch <= count; i += kBatch) {
        float4 w[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
          w[q] = load4<kVec>(a + static_cast<long long>(sRow[i + q]) * n, v0,
                             n);
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
          fold_row(acc, sD[i + q][0], sD[i + q][1], w[q]);
      }
      for (; i < count; ++i)
        fold_row(acc, sD[i][0], sD[i][1],
                 load4<kVec>(a + static_cast<long long>(sRow[i]) * n, v0, n));
    }
  }
  if (held >= 0) combine(acc, out, s0, v0, S, n);
}

// How many blocks of kThreads running ``kernel`` the card holds at once.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, long long* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  *out = static_cast<long long>(sms) * per_sm;
  return e;
}

template <typename T, bool kVec>
int launch(const T* D, const T* adj, T* out, long long S, long long n,
           cudaStream_t stream) {
  static long long resident = 0;              // queried once, then kept
  if (resident == 0) {
    const cudaError_t e = resident_blocks(relax_matmul_kernel<T, kVec>,
                                          &resident);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long vblocks = (n + kCols - 1) / kCols;
  const long long utiles = (n + kThreads - 1) / kThreads;
  const long long items = (S + kS - 1) / kS * vblocks * utiles;
  const long long blocks = items < resident ? items : resident;
  relax_matmul_kernel<T, kVec><<<static_cast<unsigned>(blocks), kThreads,
                                 0, stream>>>(D, adj, out, S, n, vblocks,
                                              utiles, items);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* D, const T* adj, T* out, long long S, long long n,
             void* stream) {
  if (n <= 0 || S <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  // the kC-column adj loads need every row aligned to kC elements
  if (n % kC == 0 && reinterpret_cast<std::uintptr_t>(adj) %
                         (kC * sizeof(T)) == 0)
    return launch<T, true>(D, adj, out, S, n, s);
  return launch<T, false>(D, adj, out, S, n, s);
}

}  // namespace

extern "C" int relax_matmul_launch(const float* D, const float* adj,
                                   float* out, long long S, long long n,
                                   void* stream) {
  return dispatch(D, adj, out, S, n, stream);
}

extern "C" int relax_matmul_bf16_launch(const __nv_bfloat16* D,
                                        const __nv_bfloat16* adj,
                                        __nv_bfloat16* out, long long S,
                                        long long n, void* stream) {
  return dispatch(D, adj, out, S, n, stream);
}

extern "C" int relax_matmul_f16_launch(const __half* D, const __half* adj,
                                       __half* out, long long S, long long n,
                                       void* stream) {
  return dispatch(D, adj, out, S, n, stream);
}
