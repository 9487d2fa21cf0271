// Incoming-CSR relaxation sweep: the kernel of the bellman_csr_kernel engine.
//
// Replaces the Pallas TPU kernel src/repro/kernels/csr_relax/kernel.py:
// ell_relax (body _ell_relax_kernel) and the self-distance fold its ops
// wrapper applied after it:
//
//     out[v] = min(dist[v], min_{e in row v} dist[src[e]] + w[e])
//
// with row v the arcs [indptr[v], indptr[v+1]) of the incoming CSR.  A
// row base b makes the rows a block of a longer label vector: out has the
// CSR's rows and row v folds in dist[b + v] (the sharded pull of
// bellman_csr_sharded: rows are the owner's block, sources the gathered
// vector); the single-device sweep passes b = 0.  The
// TPU kernel read a padded ELL, fixed-width rows for its (8, 128) tiles;
// this kernel reads the CSR itself, the same candidates without the
// padding slots.  Distances are >= 0 or +inf, so no candidate is NaN,
// fminf is exact and the min does not depend on order: the result is
// bitwise the plain version's.
//
// Bound on the H100: memory bytes.  A launch reads each arc once (int32
// source + f32 weight, 8 bytes), the row offsets (4 bytes a row) and
// dist[v], and writes out[v] (8 bytes a row).  The gathers dist[src] are
// served from L2, which holds the whole dist vector up to n ~ 12M (50 MB).
// At sparse-4M (n = 4M, 24.0M arcs) that is 240 MB, 0.072 ms at
// 3.35 TB/s; the padded ELL there (K = 24 for a mean in-degree of 6) was
// 800 MB.  One add and one min an arc are far below the f32 peak.
//
// Design: a group of G lanes a row, G a power of two <= 32 that the
// wrapper picks from the mean degree (the largest power of two below it:
// 2 on the road grid, 4 on sparse-4M and hub-1M).  Lane j of the group
// reads arcs indptr[v] + j, + G, ...; consecutive rows' arcs are adjacent
// in the CSR, so one warp load covers consecutive arcs in full sectors.
// The group's min is taken with __shfl_xor_sync, and its first lane folds
// in dist[v] and writes out[v].  The blocks stride over the rows, as many
// blocks as the card holds at once.  The output is a separate buffer:
// every lane reads the snapshot (Jacobi sweep).  No atomics, no shared
// memory.
//
// Long rows: a row of more than csr_pull::kLongRow (32) arcs (the 16 hubs
// of hub-1M have ~520 in-arcs, against a mean of 6) would hold its whole
// warp for deg / G steps.  Its group skips it instead, and once the groups
// are done the warp takes its long rows one at a time with all 32 lanes (a
// ballot over the warp), deg / 32 steps each.  No second launch and no row
// list is needed.
//
// tools/csr_pull_sweep.py times this kernel at every G and without the
// long-row path; PERF.md section 6 gives what it measured on the H100 at
// the timed shapes, with the run it came from.
#include <cuda_runtime.h>

#include "csr_pull.cuh"

namespace {

template <int G>
__global__ void ell_relax_kernel(const float* __restrict__ dist,
                                 const int* __restrict__ indptr,
                                 const int* __restrict__ src,
                                 const float* __restrict__ w,
                                 float* __restrict__ out, long long n,
                                 long long row_base) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // the loop bound is uniform across the block, so every lane of a warp
  // calls pull_row together
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x;
       t < n * G; t += stride) {
    const long long v = (t + threadIdx.x) / G;
    const bool row = v < n;
    const float best = csr_pull::pull_row<G>(dist, indptr, src, w, v, row);
    if (row && (threadIdx.x & (G - 1)) == 0)
      out[v] = fminf(__ldg(dist + row_base + v), best);
  }
}

}  // namespace

extern "C" int ell_relax_launch(const float* dist, const int* indptr,
                                const int* src, const float* w, float* out,
                                long long n, long long row_base, int group,
                                void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return csr_pull::with_group(group, [&](auto g) {
    constexpr int G = decltype(g)::value;
    return csr_pull::launch<ell_relax_kernel<G>, G>(n, s, dist, indptr, src,
                                                    w, out, n, row_base);
  });
}
