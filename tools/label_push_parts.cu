// Where the explicit-label frontier push spends its time: the walk of
// frontier_push_labels_kernel (src/repro_torch/csrc/frontier_relax.cu)
// cut after each of its stages, and variants of its reads and writes.
// tools/label_push_parts.py builds, checks and times it.  Stages 1-7 read
// through the read-only path (__ldg); the kernel streams its reads, as
// stage 8 does.
//
//   kStage 0  launch: the grid of the full kernel, no work
//          1  rows: ids, labels and window bounds read, the warp scan
//          2  arcs: + dst and w of every arc
//          3  targets: + the target's label, compared
//          4  full: + the atomicMin and the flag
//          5  targets + the atomicMin alone
//          6  targets + the flag alone (labels left as they were)
//          7  full, with the flag set from the atomicMin's old value (a
//             round trip a lane) instead of from the label read
//          8  full, with the ids, labels, window bounds and arcs read as
//             streaming data (ld.global.cs: evicted first from L1 and L2)
//   kAos      the arcs as one int2 array of (dst, bit pattern of w)
//
// Stages 1-3 write nothing unless a value no input makes turns up, so the
// compiler keeps their loads.  Stages 5 and 6 time one half of stage 4's
// writes each; their outputs are not the push's.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "../src/repro_torch/csrc/csr_pull.cuh"

namespace {

// a read through the read-only path, or as streaming data (stage 8)
template <int kStage, typename T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (kStage == 8) return __ldcs(p);
  else return __ldg(p);
}

template <int kStage, bool kAos>
__global__ void parts_kernel(const long long* __restrict__ fids,
                             const float* __restrict__ flabels, long long F,
                             long long rows, const int* __restrict__ indptr,
                             const int* __restrict__ dst,
                             const float* __restrict__ w,
                             const int2* __restrict__ arcs, float* dist,
                             unsigned char* fell, int* sink) {
  if constexpr (kStage == 0) return;
  const unsigned lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * blockDim.x / 32;
  for (long long t = (static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x) / 32;
       t * 32 < F; t += warps) {
    const long long f = t * 32 + lane;
    float d = CUDART_INF_F;
    long long deg = 0, off = 0;
    if (f < F) {
      const long long u = load<kStage>(fids + f);
      d = load<kStage>(flabels + f);
      if (u >= 0 && u < rows && d != CUDART_INF_F) {
        off = load<kStage>(indptr + u);
        deg = load<kStage>(indptr + u + 1) - off;
      }
    }
    long long incl = deg;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const long long below = __shfl_up_sync(csr_pull::kFull, incl, s);
      if (lane >= static_cast<unsigned>(s)) incl += below;
    }
    off -= incl - deg;
    const long long total = __shfl_sync(csr_pull::kFull, incl, 31);
    if constexpr (kStage == 1) {
      if (total == -1) *sink = 1;
    } else {
      for (long long base = 0; base < total; base += 32) {
        const long long k = base + lane;
        int r = 0;
#pragma unroll
        for (int step = 16; step > 0; step >>= 1)
          if (__shfl_sync(csr_pull::kFull, incl, r + step - 1) <= k)
            r += step;
        const long long e = __shfl_sync(csr_pull::kFull, off, r) + k;
        const float du = __shfl_sync(csr_pull::kFull, d, r);
        if (k >= total) continue;
        float c;
        int v;
        if (kAos) {
          const int2 a = __ldg(arcs + e);
          c = du + __int_as_float(a.y);
          v = a.x;
        } else {
          c = du + load<kStage>(w + e);
          v = load<kStage>(dst + e);
        }
        if (kStage == 2) {
          if (c == -1.0f) *sink = v;
        } else if (kStage == 3) {
          if (c < dist[v] && c == -1.0f) *sink = v;
        } else if (kStage == 5) {
          if (c < dist[v])
            atomicMin(reinterpret_cast<int*>(dist) + v, __float_as_int(c));
        } else if (kStage == 6) {
          if (c < dist[v]) fell[v] = 1;
        } else if (kStage == 7) {
          if (c < dist[v] &&
              atomicMin(reinterpret_cast<int*>(dist) + v, __float_as_int(c)) >
                  __float_as_int(c))
            fell[v] = 1;
        } else if (c < dist[v]) {
          atomicMin(reinterpret_cast<int*>(dist) + v, __float_as_int(c));
          fell[v] = 1;
        }
      }
    }
  }
}

template <int kStage, bool kAos>
int run(cudaStream_t s, const long long* fids, const float* fl, long long F,
        long long rows, const int* ip, const int* dst, const float* w,
        const int2* arcs, float* dist, unsigned char* fell, int* sink) {
  static long long resident = 0;
  if (resident == 0) {
    const cudaError_t e =
        csr_pull::resident_blocks(parts_kernel<kStage, kAos>, &resident);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long need = (F + csr_pull::kThreads - 1) / csr_pull::kThreads;
  parts_kernel<kStage, kAos>
      <<<static_cast<unsigned>(need < resident ? need : resident),
         csr_pull::kThreads, 0, s>>>(fids, fl, F, rows, ip, dst, w, arcs, dist,
                                     fell, sink);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// stage 0-8 as above, aos 0 or 1 (stage 4 only)
extern "C" int label_push_parts_launch(int stage, int aos, float* dist,
                                       const long long* fids,
                                       const float* flabels, long long F,
                                       long long rows, const int* indptr,
                                       const int* dst, const float* w,
                                       const int2* arcs, unsigned char* fell,
                                       int* sink, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto stage_c, auto aos_c) {
    return run<decltype(stage_c)::value, decltype(aos_c)::value>(
        s, fids, flabels, F, rows, indptr, dst, w, arcs, dist, fell, sink);
  };
  using std::integral_constant;
  if (aos) {
    if (stage != 4) return static_cast<int>(cudaErrorInvalidValue);
    return go(integral_constant<int, 4>{}, integral_constant<bool, true>{});
  }
  switch (stage) {
    case 0: return go(integral_constant<int, 0>{}, std::false_type{});
    case 1: return go(integral_constant<int, 1>{}, std::false_type{});
    case 2: return go(integral_constant<int, 2>{}, std::false_type{});
    case 3: return go(integral_constant<int, 3>{}, std::false_type{});
    case 4: return go(integral_constant<int, 4>{}, std::false_type{});
    case 5: return go(integral_constant<int, 5>{}, std::false_type{});
    case 6: return go(integral_constant<int, 6>{}, std::false_type{});
    case 7: return go(integral_constant<int, 7>{}, std::false_type{});
    case 8: return go(integral_constant<int, 8>{}, std::false_type{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
