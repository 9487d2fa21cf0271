// In-place frontier push: the kernel of the frontier_kernel engine.
//
// Replaces the Pallas TPU kernel src/repro/kernels/frontier_relax/kernel.py:
// frontier_cand (body _frontier_cand_kernel) together with the scatter-min
// that its ops wrapper left to XLA (TPU Pallas has no scatter).  For every
// compacted frontier row f with u = fids[f] < n and every out-arc (u, v, w)
// in u's window of the outgoing CSR:
//
//     dist[v] = min(dist[v], du[f] + w),   du[f] = dist[u] before the call
//
// in place, and fell[v] = 1 for every label that fell.  Rows with u >= n
// are the compaction sentinel and are skipped.
//
// Explicit labels (the local push of frontier_sharded): the caller gives
// each row's label du[f] = flabels[f] (the exchanged frontier pairs), the
// ids are global sources bounded by the rows of the out-CSR (the owner's
// CSR over all sources; its last row is empty and absorbs the exchange's
// sentinel id), and dist, dst and fell are the owner's block.  Only the
// gather differs: it copies the given label instead of reading dist[u].
//
// Jacobi snapshot over F rows, not n: a first small launch gathers each
// frontier row's label and out-window (empty for a sentinel or an INF
// label) into F-row scratch; the push reads its sources only from there.
// Only frontier labels are ever read as sources, so the result is bitwise
// what a cloned snapshot of all n labels gave.  The gather is a launch of
// its own because blocks run in no order: inside the push, a row's label
// may already have been lowered by another block.  It also takes the
// fids -> indptr loads off the push's chain of dependent loads.
//
// The scatter-min is an atomicMin on the int32 bit pattern of dist[v].  For
// floats >= +0 and +inf the int32 order of the bit patterns is the float
// order, every label and every candidate here is one of those (weights are
// nonnegative), and min does not depend on the order of the updates — so
// the result is bitwise deterministic and equal to the plain version's.  A
// candidate that does not beat the value already read (INF candidates
// included) is dropped without an atomic: labels only decrease, so a stale
// read can only let a useless atomic through, never skip a needed one.
// The atomic's old value is not used, so it is a fire-and-forget
// reduction: no lane waits for its round trip.
//
// Fallen labels, flagged from the same filter: a lane whose candidate c is
// below the label it read sets fell[v].  That is exact.  Every read is at
// or below the snapshot, so c < read means the label falls to c or lower.
// Conversely, the final label f < snapshot was first written by an atomic
// whose lane read a label above f (it passed the filter), and that lane set
// the flag.  So fell marks exactly the labels with new < snapshot, and the
// caller needs no O(n) compare.  The mask is ORed into (set, never
// cleared), so it may be the caller's own pending set.
//
// Bound on the H100: memory bytes.  A call reads each frontier row's id,
// label and window bounds (20 bytes a row) and its E out-arcs (8 bytes an
// arc), reads the label of each distinct target and writes each label that
// fell with its flag.  Nothing here grows with n.
//
// Design: as the incoming-CSR pulls (csr_pull.cuh), a group of G lanes a
// frontier row, G a power of two <= 32 that the wrapper picks from the
// mean degree; lane j of the group pushes arcs beg + j, + G, ... .  A row
// of more than csr_pull::kLongRow arcs (the hubs of hub-1M) is left by its
// group and pushed by the whole warp once the groups are done.  The blocks
// stride over the rows, as many blocks as the card holds at once.
//
// tools/csr_pull_sweep.py times this kernel at every G and without the
// long-row path; PERF.md section 6 gives what it measured on the H100.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "csr_pull.cuh"

namespace {

// per frontier row f: its label (flabels[f] where given, else dist[u])
// and its out-window [beg, end), empty for an id outside [0, bound) or an
// INF label (which pushes nothing)
__global__ void frontier_gather_kernel(const float* __restrict__ dist,
                                       const long long* __restrict__ fids,
                                       const float* __restrict__ flabels,
                                       long long F, long long bound,
                                       const int* __restrict__ indptr,
                                       float* __restrict__ du,
                                       int2* __restrict__ win) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long f = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       f < F; f += stride) {
    const long long u = fids[f];
    const float d = u < 0 || u >= bound ? CUDART_INF_F
                    : flabels != nullptr ? flabels[f]
                                         : dist[u];
    du[f] = d;
    win[f] = d != CUDART_INF_F ? make_int2(indptr[u], indptr[u + 1])
                               : make_int2(0, 0);
  }
}

// scatter-min d + w[e] into dist[dst[e]] for arcs first, first + stride,
// ... below end, flagging each label that falls
__device__ __forceinline__ void push_arcs(float d, unsigned first,
                                          unsigned end, unsigned stride,
                                          const int* __restrict__ dst,
                                          const float* __restrict__ w,
                                          float* dist, unsigned char* fell) {
  for (unsigned e = first; e < end; e += stride) {
    const float c = d + __ldg(w + e);
    const int v = __ldg(dst + e);
    if (c < dist[v]) {
      atomicMin(reinterpret_cast<int*>(dist) + v, __float_as_int(c));
      fell[v] = 1;
    }
  }
}

template <int G>
__global__ void frontier_push_kernel(const float* __restrict__ du,
                                     const int2* __restrict__ win,
                                     long long F,
                                     const int* __restrict__ dst,
                                     const float* __restrict__ w, float* dist,
                                     unsigned char* fell) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const unsigned j = threadIdx.x & (G - 1);
  // the loop bound is uniform across the block, so every lane of a warp
  // reaches for_long_rows together
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x;
       t < F * G; t += stride) {
    const long long f = (t + threadIdx.x) / G;
    float d = CUDART_INF_F;
    unsigned beg = 0, end = 0;
    if (f < F) {
      const int2 r = win[f];
      beg = r.x;
      end = r.y;
      d = du[f];
    }
    const bool is_long = end - beg > csr_pull::kLongRow;
    if (!is_long) push_arcs(d, beg + j, end, G, dst, w, dist, fell);
    csr_pull::for_long_rows(
        is_long && j == 0, beg, end,
        [&](int lead, unsigned first, unsigned last) {
          push_arcs(__shfl_sync(csr_pull::kFull, d, lead), first, last, 32,
                    dst, w, dist, fell);
        });
  }
}

}  // namespace

// scratch: 3F int32 of the caller's, the rows' windows (int2) then labels;
// flabels null for the labels of dist itself; ids at or past ``bound``
// (n, or the out-CSR's rows with flabels) are skipped
extern "C" int frontier_relax_launch(float* dist, const long long* fids,
                                     const float* flabels, int* scratch,
                                     long long F, long long bound,
                                     const int* indptr, const int* dst,
                                     const float* w, unsigned char* fell,
                                     int group, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (F <= 0) return 0;
  auto* win = reinterpret_cast<int2*>(scratch);
  auto* du = reinterpret_cast<float*>(scratch + 2 * F);
  constexpr long long kGatherBlocks = 1024;
  const long long need = (F + csr_pull::kThreads - 1) / csr_pull::kThreads;
  frontier_gather_kernel<<<static_cast<unsigned>(
                               need < kGatherBlocks ? need : kGatherBlocks),
                           csr_pull::kThreads, 0, s>>>(dist, fids, flabels,
                                                       F, bound, indptr, du,
                                                       win);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return csr_pull::with_group(group, [&](auto g) {
    constexpr int G = decltype(g)::value;
    return csr_pull::launch<frontier_push_kernel<G>, G>(F, s, du, win, F,
                                                        dst, w, dist, fell);
  });
}
