// Fused frontier push: the kernel of the frontier_kernel engine.
//
// Replaces the Pallas TPU kernel src/repro/kernels/frontier_relax/kernel.py:
// frontier_cand (body _frontier_cand_kernel) together with the scatter-min
// that its ops wrapper left to XLA (TPU Pallas has no scatter).  For every
// compacted frontier row f with u = fids[f] < n and every out-arc (u, v, w)
// in u's window of the outgoing CSR:
//
//     nd[v] = min(nd[v], dist[u] + w)
//
// ``dist`` is the sweep's snapshot and is only read; ``nd`` is the running
// copy (the wrapper clones dist into it), so the sweep has Jacobi semantics.
// Rows with u >= n are the compaction sentinel and are skipped.
//
// The scatter-min is an atomicMin on the int32 bit pattern of nd[v].  For
// floats >= +0 and +inf the int32 order of the bit patterns is the float
// order, every label and every candidate here is one of those (weights are
// nonnegative), and min does not depend on the order of the updates — so
// the result is bitwise deterministic and equal to the plain version's.  A
// candidate that does not beat the value already read (INF candidates
// included) is dropped without an atomic: labels only decrease, so a stale
// read can only let a useless atomic through, never skip a needed one.
//
// Bound on the H100: memory bytes.  A launch reads each frontier row's id,
// label and window bounds (20 bytes a row) and its E out-arcs (8 bytes an
// arc), and the wrapper's copy of dist into nd moves 8 bytes a vertex.
//
// Design: one warp per frontier row, its lanes striding the row's window of
// the flat outgoing CSR.  The TPU kernel read fixed-width out-ELL rows; the
// flat windows need no (n, max out-degree) array — on the hub corpus the
// out-ELL would be ~4 GB for 1M vertices — and a warp per row keeps hub
// rows (hundreds of arcs) from serialising on one thread.
#include <cuda_runtime.h>

namespace {

__global__ void frontier_relax_kernel(const float* __restrict__ dist,
                                      const long long* __restrict__ fids,
                                      long long F, long long n,
                                      const int* __restrict__ indptr,
                                      const int* __restrict__ out_dst,
                                      const float* __restrict__ out_w,
                                      float* nd) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (row >= F) return;
  const long long u = fids[row];
  if (u < 0 || u >= n) return;                  // compaction sentinel
  const float du = dist[u];
  const int end = indptr[u + 1];
  for (int e = indptr[u] + lane; e < end; e += 32) {
    const float c = du + __ldg(out_w + e);
    const int v = __ldg(out_dst + e);
    if (c < nd[v]) {
      atomicMin(reinterpret_cast<int*>(nd) + v, __float_as_int(c));
    }
  }
}

}  // namespace

extern "C" int frontier_relax_launch(const float* dist, const long long* fids,
                                     long long F, long long n,
                                     const int* indptr, const int* out_dst,
                                     const float* out_w, float* nd,
                                     void* stream) {
  constexpr int kThreads = 256;                 // 8 rows a block
  const long long blocks = (F * 32 + kThreads - 1) / kThreads;
  frontier_relax_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      dist, fids, F, n, indptr, out_dst, out_w, nd);
  return static_cast<int>(cudaGetLastError());
}
