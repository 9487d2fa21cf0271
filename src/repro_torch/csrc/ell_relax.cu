// Padded-ELL relaxation sweep: the kernel of the bellman_csr_kernel engine.
//
// Replaces the Pallas TPU kernel src/repro/kernels/csr_relax/kernel.py:
// ell_relax (body _ell_relax_kernel) and the self-distance fold its ops
// wrapper applied after it:
//
//     out[v] = min(dist[v], min_k dist[idx[v, k]] + w[v, k])
//
// Padding slots are (0, +inf) and never win.  Distances are >= 0 or +inf,
// so fminf and IEEE float adds give exactly the plain version's values.
//
// Bound on the H100: memory bytes.  A launch streams the (n, K) ELL once
// (8 bytes a slot: int32 index + f32 weight) and reads dist[v] and writes
// out[v] (8 bytes a row).  The n*K gathers dist[idx] are served from L2,
// which holds the whole dist vector up to n ~ 12M (50 MB).  At sparse-4M
// (n = 4M, K = 24) that is ~800 MB, 0.24 ms at 3.35 TB/s; the arithmetic
// (one add and one min a slot) is far below the f32 peak.
//
// Design: one thread per row.  The TPU kernel kept dist resident in VMEM
// and walked K in sequential grid steps; here blocks run in parallel, with
// no order, and each thread walks its own row in 16-byte vector loads (the
// wrapper guarantees K % 4 == 0 and 16-byte aligned rows), so the ELL is
// read in full sectors through L1 over the row loop.  The output is a
// separate buffer: every thread reads the snapshot (Jacobi sweep).  No
// atomics, no shared memory.
#include <cuda_runtime.h>

namespace {

__global__ void ell_relax_kernel(const float* __restrict__ dist,
                                 const int4* __restrict__ idx,
                                 const float4* __restrict__ w,
                                 float* __restrict__ out,
                                 long long n, int k4) {
  long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= n) return;
  const int4* irow = idx + v * k4;
  const float4* wrow = w + v * k4;
  float best = dist[v];
  for (int q = 0; q < k4; ++q) {
    int4 i = __ldg(irow + q);
    float4 c = __ldg(wrow + q);
    best = fminf(best, __ldg(dist + i.x) + c.x);
    best = fminf(best, __ldg(dist + i.y) + c.y);
    best = fminf(best, __ldg(dist + i.z) + c.z);
    best = fminf(best, __ldg(dist + i.w) + c.w);
  }
  out[v] = best;
}

}  // namespace

extern "C" int ell_relax_launch(const float* dist, const int* idx,
                                const float* w, float* out, long long n,
                                int K, void* stream) {
  constexpr int kThreads = 256;
  const long long blocks = (n + kThreads - 1) / kThreads;
  ell_relax_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      dist, reinterpret_cast<const int4*>(idx),
      reinterpret_cast<const float4*>(w), out, n, K / 4);
  return static_cast<int>(cudaGetLastError());
}
