// Fused Δ-stepping light-bucket pull: the kernel of the
// delta_stepping_kernel engine.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bucket_relax/kernel.py:
// bucket_relax (body _bucket_relax_kernel).  One pass computes
//
//     out[v] = min(dist[v], min_{e in row v} dist[src[e]] + w[e])
//     *flag  = 1 if any v has out[v] < dist[v] and out[v] < *hi
//
// with row v the arcs [indptr[v], indptr[v+1]) of the light incoming CSR
// (arcs of weight <= Δ).  The TPU kernel read a padded light ELL; this one
// reads the CSR, the same candidates without the padding slots, so the
// result is bitwise the plain version's (fminf of non-NaN values, a min
// that does not depend on order).  The TPU kernel wrote one flag per
// v-block and its ops wrapper OR-reduced them; the comparisons are exact,
// so one global flag that the wrapper zeroes and any block with an
// improving row sets to 1 is the same OR.  Concurrent writers all store 1,
// so no atomic is needed.  ``hi`` is read from device memory: the inner
// loop never copies it to the host.
//
// Bound on the H100: memory bytes.  A launch reads each light arc once
// (int32 source + f32 weight, 8 bytes), the row offsets (4 bytes a row)
// and dist[v], and writes out[v] (8 bytes a row), plus hi and the flag;
// the gathers dist[src] are served from L2.  At road-4M (n = 4M, 16.0M
// light arcs) that is 176 MB, 0.053 ms at 3.35 TB/s (the padded ELL of
// width 8 there was 288 MB).
//
// Design: as ell_relax.cu — a group of G lanes a row (G the largest power
// of two below the mean light degree, picked by the wrapper), lane j
// reading arcs indptr[v] + j, + G, ... so a warp load covers consecutive
// arcs, the group's min by __shfl_xor_sync, its first lane folding in
// dist[v]; rows of more than csr_pull::kLongRow arcs taken by the whole
// warp after its groups; blocks striding over the rows, as many as the
// card holds at once; a separate output buffer so every lane reads the
// snapshot; no shared memory.  The flag is stored at most once a block
// (__syncthreads_or), and the strided blocks are few: stores from every
// improving warp, all to the one address, would queue on it.
#include <cuda_runtime.h>

#include "csr_pull.cuh"

namespace {

template <int G>
__global__ void bucket_relax_kernel(const float* __restrict__ dist,
                                    const int* __restrict__ indptr,
                                    const int* __restrict__ src,
                                    const float* __restrict__ w,
                                    const float* __restrict__ hi,
                                    float* __restrict__ out,
                                    int* __restrict__ flag, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const float h = __ldg(hi);
  bool improved = false;
  // the loop bound is uniform across the block, so every lane of a warp
  // calls pull_row together
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x;
       t < n * G; t += stride) {
    const long long v = (t + threadIdx.x) / G;
    const bool row = v < n;
    const float best = csr_pull::pull_row<G>(dist, indptr, src, w, v, row);
    if (row && (threadIdx.x & (G - 1)) == 0) {
      const float old = __ldg(dist + v);
      const float nv = fminf(old, best);
      out[v] = nv;
      improved |= nv < old && nv < h;
    }
  }
  // one store a block at most: every store goes to the same address
  if (__syncthreads_or(improved) && threadIdx.x == 0) *flag = 1;
}

}  // namespace

extern "C" int bucket_relax_launch(const float* dist, const int* indptr,
                                   const int* src, const float* w,
                                   const float* hi, float* out, int* flag,
                                   long long n, int group, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return csr_pull::with_group(group, [&](auto g) {
    constexpr int G = decltype(g)::value;
    return csr_pull::launch<bucket_relax_kernel<G>, G>(
        n, s, dist, indptr, src, w, hi, out, flag, n);
  });
}
