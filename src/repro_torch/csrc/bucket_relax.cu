// Fused Δ-stepping light-bucket pull: the kernel of the
// delta_stepping_kernel engine.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bucket_relax/kernel.py:
// bucket_relax (body _bucket_relax_kernel).  One pass computes
//
//     out[v] = min(dist[v], min_k dist[idx[v, k]] + w[v, k])
//     *flag  = 1 if any v has out[v] < dist[v] and out[v] < *hi
//
// over the padded light in-ELL.  The TPU kernel wrote one flag per v-block
// and its ops wrapper OR-reduced them; the comparisons are exact, so one
// global flag that the wrapper zeroes and any improving row sets to 1 is
// the same OR.  Concurrent writers all store 1, so no atomic is needed.
// ``hi`` is read from device memory: the inner loop never copies it to the
// host.
//
// Bound on the H100: memory bytes.  A launch streams the (n, K) light ELL
// once (8 bytes a slot) and reads dist[v] and writes out[v] (8 bytes a
// row); the gathers dist[idx] are served from L2.  At road-4M (n = 4M,
// K = 8) that is ~290 MB, 0.09 ms at 3.35 TB/s.
//
// Design: as ell_relax.cu — one thread per row, 16-byte vector loads along
// the row (K % 4 == 0, rows 16-byte aligned), a separate output buffer so
// every thread reads the snapshot, no shared memory.
#include <cuda_runtime.h>

namespace {

__global__ void bucket_relax_kernel(const float* __restrict__ dist,
                                    const int4* __restrict__ idx,
                                    const float4* __restrict__ w,
                                    const float* __restrict__ hi,
                                    float* __restrict__ out,
                                    int* __restrict__ flag,
                                    long long n, int k4) {
  long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= n) return;
  const int4* irow = idx + v * k4;
  const float4* wrow = w + v * k4;
  const float old = dist[v];
  float best = old;
  for (int q = 0; q < k4; ++q) {
    int4 i = __ldg(irow + q);
    float4 c = __ldg(wrow + q);
    best = fminf(best, __ldg(dist + i.x) + c.x);
    best = fminf(best, __ldg(dist + i.y) + c.y);
    best = fminf(best, __ldg(dist + i.z) + c.z);
    best = fminf(best, __ldg(dist + i.w) + c.w);
  }
  out[v] = best;
  if (best < old && best < __ldg(hi)) *flag = 1;
}

}  // namespace

extern "C" int bucket_relax_launch(const float* dist, const int* idx,
                                   const float* w, const float* hi,
                                   float* out, int* flag, long long n, int K,
                                   void* stream) {
  constexpr int kThreads = 256;
  const long long blocks = (n + kThreads - 1) / kThreads;
  bucket_relax_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      dist, reinterpret_cast<const int4*>(idx),
      reinterpret_cast<const float4*>(w), hi, out, flag, n, K / 4);
  return static_cast<int>(cudaGetLastError());
}
