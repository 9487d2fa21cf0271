// The row walk shared by the CSR kernels: the two incoming-CSR pulls,
// ell_relax.cu and bucket_relax.cu, and the outgoing-CSR push,
// frontier_relax.cu (their sources say what bounds them and why the design
// is so).
//
// Lanes form groups of G (a power of two <= 32); group g of a warp owns
// one row.  Lane j of the group reads arcs indptr[v] + j, + G, ... .  A row
// of more than kLongRow arcs is skipped by its group and taken, once the
// groups are done, by the whole warp: all 32 lanes, one long row at a time
// (a ballot over the warp, for_long_rows).  Every lane of the warp must
// call pull_row and for_long_rows together.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

// tools/csr_pull_sweep.py builds a variant with the whole-warp path off
// (-DCSR_PULL_LONG_ROW=0xffffffffu) to measure what the path buys
#ifndef CSR_PULL_LONG_ROW
#define CSR_PULL_LONG_ROW 32
#endif

namespace csr_pull {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr unsigned kLongRow = CSR_PULL_LONG_ROW;

// min of the candidates dist[src[e]] + w[e] of arcs first, first + stride,
// ... below end
__device__ __forceinline__ float arc_min(const float* __restrict__ dist,
                                         const int* __restrict__ src,
                                         const float* __restrict__ w,
                                         unsigned first, unsigned end,
                                         unsigned stride) {
  float best = CUDART_INF_F;
  for (unsigned e = first; e < end; e += stride)
    best = fminf(best, __ldg(dist + __ldg(src + e)) + __ldg(w + e));
  return best;
}

// The whole-warp path for long rows: for each lane of the warp whose
// ``lead_is_long`` is set (the first lane of a group holding a row of more
// than kLongRow arcs [beg, end)), calls visit(lead, first, last) on every
// lane of the warp, with first = that row's beg + lane and last its end, so
// the 32 lanes stride the row together.
template <typename Visit>
__device__ __forceinline__ void for_long_rows(bool lead_is_long, unsigned beg,
                                              unsigned end, Visit visit) {
  const unsigned lane = threadIdx.x & 31;
  for (unsigned longs = __ballot_sync(kFull, lead_is_long); longs;
       longs &= longs - 1) {
    const int lead = __ffs(longs) - 1;
    visit(lead, __shfl_sync(kFull, beg, lead) + lane,
          __shfl_sync(kFull, end, lead));
  }
}

// The min of row v's candidates (+inf for no arcs), exact in the group's
// first lane (j == 0).  ``row`` is false for lanes past the last row.
template <int G>
__device__ __forceinline__ float pull_row(const float* __restrict__ dist,
                                          const int* __restrict__ indptr,
                                          const int* __restrict__ src,
                                          const float* __restrict__ w,
                                          long long v, bool row) {
  const unsigned j = threadIdx.x & (G - 1);
  const unsigned lane = threadIdx.x & 31;
  unsigned beg = 0, end = 0;
  if (row) {
    beg = __ldg(indptr + v);
    end = __ldg(indptr + v + 1);
  }
  const bool is_long = end - beg > kLongRow;
  float best = is_long ? CUDART_INF_F : arc_min(dist, src, w, beg + j, end, G);
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    best = fminf(best, __shfl_xor_sync(kFull, best, off));
  for_long_rows(is_long && j == 0, beg, end,
                [&](int lead, unsigned first, unsigned last) {
                  float b = arc_min(dist, src, w, first, last, 32);
#pragma unroll
                  for (int off = 16; off > 0; off >>= 1)
                    b = fminf(b, __shfl_xor_sync(kFull, b, off));
                  if (lane == static_cast<unsigned>(lead)) best = b;
                });
  return best;
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

// Launch ``Kernel``, a kernel over n rows of G lanes that strides over
// them, as one block per kThreads lanes but at most as many blocks as the
// card holds at once (queried on the first launch and kept): every block
// stays resident, and any count gives the same result.
template <auto Kernel, int G, typename... Args>
int launch(long long n, cudaStream_t stream, Args... args) {
  static long long resident = 0;
  if (resident == 0) {
    const cudaError_t e = resident_blocks(Kernel, &resident);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long need = (n * G + kThreads - 1) / kThreads;
  Kernel<<<static_cast<unsigned>(need < resident ? need : resident),
           kThreads, 0, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// f(std::integral_constant<int, G>{}) for the lane-group width ``group``
// (a power of two <= 32); cudaErrorInvalidValue for any other.
template <typename F>
int with_group(int group, F f) {
  switch (group) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace csr_pull
