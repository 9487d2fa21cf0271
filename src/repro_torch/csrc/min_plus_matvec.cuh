// The dense min-plus matvec sweep of relax_matvec.cu (every row relaxes)
// and relax_matvec_frontier.cu (only the frontier's rows relax):
//
//     out[v] = min(out[v], min_{u live} dist[u] + adj[u, v])
//
// where a live row has a finite dist[u] and, masked, is on the frontier.
// A row whose dist[u] is +inf contributes +inf to every column, so it is
// never read: the bytes the function needs are those of the live rows.
//
// Design, for the card's byte rate (relax_matmul.cu's, cut to one
// source):
// - 16-byte column loads.  Each thread owns 16 bytes of columns (8 of a
//   16-bit type, 4 of float32) and reads them as one 16-byte load a live
//   row, widened in registers.  That needs every row 16-byte aligned: n a
//   multiple of 8 (4 for float32) and a 16-byte aligned adj, both tested
//   here, since a contiguous view may start at an offset.  Every other
//   input reads the same columns with scalar loads in the same kernel;
//   columns past n are masked, not padded.
// - A compacted list of live rows.  A tile of rows is staged by the
//   block: thread t reads dist[u0 + t] (and frontier[u0 + t]), and the
//   live rows are packed in order into shared memory (a ballot a warp,
//   the warps' counts in shared memory), each with its label widened to
//   float32.  The inner loop walks only that list, with no branch a row.
// - Loads in flight.  A thread issues the loads of kBatch live rows into
//   registers before folding any of them (the tail of the list re-reads
//   its last row and folds it with +inf).  A cp.async ring of 2, 4 or 8
//   rows a thread in shared memory measured no faster (PERF.md section 6).
// - A balanced work list.  Items are (column block, row tile), row tile
//   fastest, cut into equal contiguous ranges, one a block, with as many
//   blocks as the card holds at once.  A tile is 256 rows, or fewer (down
//   to kMinRows) where n is so small that 256-row tiles would give fewer
//   items than the card holds blocks (dense-2000 has 1 column block of
//   16-bit elements).  A block folds its items into one set of
//   accumulators and combines them into out whenever its column block
//   changes and at its end: an atomicMin a float32 column, and for 16
//   bits one CAS a pair of adjacent columns (atomic_min2; a column block
//   starts at a multiple of 8, and out must be 4-byte aligned).
// Index arithmetic is 64-bit: u * n + v passes INT_MAX at n > 46,340.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "min_plus_types.cuh"

namespace min_plus_matvec {

constexpr int kThreads = 256;                 // threads a block, tallest tile
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;                     // rows loaded before folding
// the shortest row tile: shorter tiles fill the card at small n but lose
// to the blocks' contending combines (PERF.md section 6 has the floors
// measured)
constexpr int kMinRows = 32;
constexpr unsigned kFull = 0xffffffffu;
// columns a thread: 16 bytes of elements
template <typename T>
constexpr int kCols = 16 / static_cast<int>(sizeof(T));

// the bits of +inf in T
template <typename T>
constexpr unsigned kInfBits = sizeof(T) == 4 ? 0x7f800000u
                              : std::is_same_v<T, __half> ? 0x7c00u
                                                          : 0x7f80u;

// the 16 bytes of adj[row, v0 ...] as they lie in memory, +inf past
// column n
template <bool kVec, typename T>
__device__ __forceinline__ uint4 load_row(const T* __restrict__ p,
                                          long long v0, long long n) {
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else if constexpr (sizeof(T) == 4) {
    const unsigned* q = reinterpret_cast<const unsigned*>(p);
    unsigned e[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      e[c] = v0 + c < n ? __ldg(q + c) : kInfBits<T>;
    return make_uint4(e[0], e[1], e[2], e[3]);
  } else {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    unsigned e[8];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      e[c] = v0 + c < n ? __ldg(q + c) : kInfBits<T>;
    return make_uint4(e[0] | e[1] << 16, e[2] | e[3] << 16,
                      e[4] | e[5] << 16, e[6] | e[7] << 16);
  }
}

// acc[c] = min(acc[c], d + w[c]) for the columns of one row's 16 bytes
template <typename T>
__device__ __forceinline__ void fold(float (&acc)[kCols<T>], float d,
                                     uint4 raw) {
  float w[kCols<T>];
  if constexpr (sizeof(T) == 4) {
    w[0] = __uint_as_float(raw.x);
    w[1] = __uint_as_float(raw.y);
    w[2] = __uint_as_float(raw.z);
    w[3] = __uint_as_float(raw.w);
  } else {
    min_plus::widen8(raw, T{}, w);
  }
#pragma unroll
  for (int c = 0; c < kCols<T>; ++c) acc[c] = fminf(acc[c], d + w[c]);
}

// out[v0 + c] = min(out[v0 + c], acc[c]) for the columns below n
template <typename T>
__device__ __forceinline__ void combine(const float (&acc)[kCols<T>], T* out,
                                        long long v0, long long n) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int c = 0; c < kCols<T>; ++c)
      if (v0 + c < n) min_plus::atomic_min(out + v0 + c, acc[c]);
  } else {
#pragma unroll
    for (int c = 0; c < kCols<T>; c += 2) {
      if (v0 + c + 1 < n)
        min_plus::atomic_min2(out + v0 + c, acc[c], acc[c + 1]);
      else if (v0 + c < n)
        min_plus::atomic_min(out + v0 + c, acc[c]);
    }
  }
}

template <typename T, bool kVec, bool kMasked>
__global__ void __launch_bounds__(kThreads)
    matvec_kernel(const T* __restrict__ dist,
                  const unsigned char* __restrict__ frontier,
                  const T* __restrict__ adj, T* out, long long n,
                  int rows, long long utiles, long long items) {
  constexpr int kC = kCols<T>;
  __shared__ float sD[kThreads];              // live row i: its label
  __shared__ int sRow[kThreads];              // live row i: u - u0
  __shared__ int sCount[kWarps];              // live rows a warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float kInf = __int_as_float(0x7f800000);
  // items are ordered (column block, row tile), row tile fastest
  const long long first = items * blockIdx.x / gridDim.x;
  const long long last = items * (blockIdx.x + 1) / gridDim.x;
  long long held = -1;                        // the accumulators' block
  long long v0 = 0;
  float acc[kC];

  for (long long it = first; it < last; ++it) {
    const long long cb = it / utiles;
    const long long u0 = (it - cb * utiles) * rows;
    if (cb != held) {
      if (held >= 0 && v0 < n) combine<T>(acc, out, v0, n);
      held = cb;
      v0 = (cb * kThreads + threadIdx.x) * kC;
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[c] = kInf;
    }
    // stage: thread t < rows reads row u0 + t's label; the live rows are
    // packed in order at the front of sD / sRow
    const long long u = u0 + threadIdx.x;
    float d = kInf;
    if (threadIdx.x < rows && u < n && (!kMasked || frontier[u]))
      d = min_plus::widen(dist[u]);
    const bool live = d != kInf;
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
      sD[i] = d;
      sRow[i] = threadIdx.x;
    }
    __syncthreads();
    if (v0 >= n) continue;

    const T* a = adj + u0 * n + v0;
    for (int i = 0; i < count; i += kBatch) {
      uint4 w[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int k = i + q < count ? i + q : count - 1;
        w[q] = load_row<kVec>(a + static_cast<long long>(sRow[k]) * n, v0,
                              n);
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q)
        fold<T>(acc, i + q < count ? sD[i + q] : kInf, w[q]);
    }
  }
  if (held >= 0 && v0 < n) combine<T>(acc, out, v0, n);
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

template <typename T, bool kVec, bool kMasked>
int launch(const T* dist, const unsigned char* frontier, const T* adj,
           T* out, long long n, cudaStream_t stream) {
  static long long resident = 0;              // queried once, then kept
  if (resident == 0) {
    const cudaError_t e =
        resident_blocks(matvec_kernel<T, kVec, kMasked>, &resident);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long cols = static_cast<long long>(kThreads) * kCols<T>;
  const long long vblocks = (n + cols - 1) / cols;
  int rows = kThreads;                        // rows a tile
  while (rows > kMinRows && vblocks * ((n + rows - 1) / rows) < resident)
    rows /= 2;
  const long long utiles = (n + rows - 1) / rows;
  const long long items = vblocks * utiles;
  const long long blocks = items < resident ? items : resident;
  matvec_kernel<T, kVec, kMasked><<<static_cast<unsigned>(blocks), kThreads,
                                    0, stream>>>(dist, frontier, adj, out, n,
                                                 rows, utiles, items);
  return static_cast<int>(cudaGetLastError());
}

// One sweep into ``out`` (a copy of dist); ``frontier`` is read only when
// kMasked.
template <bool kMasked, typename T>
int sweep(const T* dist, const unsigned char* frontier, const T* adj, T* out,
          long long n, void* stream) {
  if (n <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  // a 16-bit column pair is lowered by one CAS on its 32-bit word
  if (sizeof(T) != 4 && reinterpret_cast<std::uintptr_t>(out) % 4 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  // the 16-byte loads need every row 16-byte aligned
  if (n % kCols<T> == 0 && reinterpret_cast<std::uintptr_t>(adj) % 16 == 0)
    return launch<T, true, kMasked>(dist, frontier, adj, out, n, s);
  return launch<T, false, kMasked>(dist, frontier, adj, out, n, s);
}

}  // namespace min_plus_matvec
