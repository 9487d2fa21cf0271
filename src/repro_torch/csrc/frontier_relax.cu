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
// sentinel id), and dist, dst and fell are the owner's block.  This mode
// has a kernel of its own; see "The explicit-label mode" below.
//
// Jacobi snapshot over F rows, not n (the dist-label mode): a first small
// launch gathers each frontier row's label and out-window (empty for a
// sentinel or an INF label) into F-row scratch; the push reads its sources
// only from there.  Only frontier labels are ever read as sources, so the
// result is bitwise what a cloned snapshot of all n labels gave.  The
// gather is a launch of its own because blocks run in no order: inside the
// push, a row's label may already have been lowered by another block.  It
// also takes the fids -> indptr loads off the push's chain of dependent
// loads.
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
// Design of the dist-label mode: as the incoming-CSR pulls (csr_pull.cuh),
// a group of G lanes a frontier row, G a power of two <= 32 that the
// wrapper picks from the mean degree; lane j of the group pushes arcs
// beg + j, + G, ... .  A row of more than csr_pull::kLongRow arcs (the hubs
// of hub-1M) is left by its group and pushed by the whole warp once the
// groups are done.  The blocks stride over the rows, as many blocks as the
// card holds at once.
//
// tools/csr_pull_sweep.py times this kernel at every G and without the
// long-row path; PERF.md section 6 gives what it measured on the H100.
//
// The explicit-label mode.  It stands for the local push of the JAX
// package's vertex-partitioned frontier engine (relax in
// repro/core/sharded_csr.py's sssp_frontier_sharded: a cumsum of the
// exchanged rows' window lengths, then core/frontier.relax_edge_slots
// walking the concatenated arcs in slot order), whose single-device form
// is the Pallas frontier_cand with the scatter-min after it.  It needs no
// snapshot: no label is read from dist, and flabels, the snapshot, is
// written by nothing.  So it is one launch with no scratch, and the group
// width of the wrapper is not read.
//
// Its bound on the H100, at block 2 of sparse-4M / 4 (F = 400,035 global
// ids, E = 600,138 arcs, a 1M-target block): the ideal bytes are 20 a row
// (id, label, window bounds), 8 an arc, 4 a distinct target read and 5 a
// fallen label written, about 16 MB or 0.005 ms at 3.35 TB/s.  What the
// operands' layout makes it read is more: a 10% frontier of ascending
// ids has a row every ~40 bytes of indptr and a window of ~1.5 arcs every
// ~60 bytes of dst and of w, so nearly every 64-byte DRAM access of the
// 16 MB indptr and the 48 MB of arcs is needed, about 69 MB with the ids
// and labels, or 0.021 ms; the block's labels (4 MB) and flags (1 MB),
// which the atomics and flag stores hit at random, fit in the 50 MB L2
// only if those streams do not push them out.  PERF.md section 6 gives
// the measured split (tools/label_push_parts.py).  A lane a row instead
// (the dist-label design at G = 1) leaves a warp waiting on its longest
// row, and the gather launch writes and reads back 12 bytes a row.
//
// Design: a warp-balanced walk over the arcs.  The blocks are persistent
// (as many as the card holds, csr_pull::launch) and each warp strides over
// tiles of 32 consecutive frontier rows.  Lane i of a tile reads row i's
// id, label and window bounds: coalesced reads of fids and flabels, and
// near-neighbour reads of indptr since the exchange's ids ascend within
// each owner's segment.  A row outside [0, rows) (the sentinel n_pad, an
// id past the rows) or with an INF label gets degree 0.  An inclusive scan
// of the degrees over the warp (__shfl_up_sync, 5 steps) numbers the
// tile's arcs 0 .. total - 1 in row order; the warp then takes them 32 at
// a time, lane j arc k = base + j, whose row it finds by a 5-step search
// of the scan (shuffles).  So every lane has an arc whatever the degrees,
// a long row (the hubs of hub-1M) only takes its warp more steps, and the
// loads of dst and w for a tile's arcs are as contiguous as its rows'
// windows.  Each arc goes through the same filter and fire-and-forget
// atomicMin as the dist-label mode, so the proofs above hold as they
// stand: the result is bitwise the plain version's in any order, an id
// listed twice pushes the smaller of its labels (float addition is
// monotone, so min(a + w, b + w) = min(a, b) + w), and fell marks exactly
// the labels with new < snapshot.  The scan and the arc numbers are 64-bit:
// a tile of 32 rows may list one long row many times.  The ids, labels,
// window bounds and arcs are read as streaming data (ld.global.cs,
// evicted first), so the block's labels and flags stay in L2.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "csr_pull.cuh"

namespace {

// per frontier row f: its label dist[u] and its out-window [beg, end),
// empty for an id outside [0, bound) or an INF label (which pushes
// nothing)
__global__ void frontier_gather_kernel(const float* __restrict__ dist,
                                       const long long* __restrict__ fids,
                                       long long F, long long bound,
                                       const int* __restrict__ indptr,
                                       float* __restrict__ du,
                                       int2* __restrict__ win) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long f = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       f < F; f += stride) {
    const long long u = fids[f];
    const float d = u < 0 || u >= bound ? CUDART_INF_F : dist[u];
    du[f] = d;
    win[f] = d != CUDART_INF_F ? make_int2(indptr[u], indptr[u + 1])
                               : make_int2(0, 0);
  }
}

// dist[v] = min(dist[v], c) where c beats the label read, flagging it
__device__ __forceinline__ void lower(float c, int v, float* dist,
                                      unsigned char* fell) {
  if (c < dist[v]) {
    atomicMin(reinterpret_cast<int*>(dist) + v, __float_as_int(c));
    fell[v] = 1;
  }
}

// scatter-min d + w[e] into dist[dst[e]] for arcs first, first + stride,
// ... below end, flagging each label that falls
__device__ __forceinline__ void push_arcs(float d, unsigned first,
                                          unsigned end, unsigned stride,
                                          const int* __restrict__ dst,
                                          const float* __restrict__ w,
                                          float* dist, unsigned char* fell) {
  for (unsigned e = first; e < end; e += stride)
    lower(d + __ldg(w + e), __ldg(dst + e), dist, fell);
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

// The explicit-label push: each warp strides over tiles of 32 frontier
// rows and walks their concatenated arcs 32 at a time (see the note above);
// every read but the targets' labels is streaming data (__ldcs)
__global__ void frontier_push_labels_kernel(
    const long long* __restrict__ fids, const float* __restrict__ flabels,
    long long F, long long rows, const int* __restrict__ indptr,
    const int* __restrict__ dst, const float* __restrict__ w, float* dist,
    unsigned char* fell) {
  const unsigned lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * blockDim.x / 32;
  // the loop bound is uniform across the warp, so all 32 lanes shuffle
  for (long long t = (static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x) / 32;
       t * 32 < F; t += warps) {
    const long long f = t * 32 + lane;
    float d = CUDART_INF_F;
    long long deg = 0, off = 0;
    if (f < F) {
      const long long u = __ldcs(fids + f);
      d = __ldcs(flabels + f);
      if (u >= 0 && u < rows && d != CUDART_INF_F) {
        off = __ldcs(indptr + u);
        deg = __ldcs(indptr + u + 1) - off;
      }
    }
    long long incl = deg;  // arcs of rows 0 .. lane of the tile
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const long long below = __shfl_up_sync(csr_pull::kFull, incl, s);
      if (lane >= static_cast<unsigned>(s)) incl += below;
    }
    off -= incl - deg;  // arc k of the tile in this row is arc off + k
    const long long total = __shfl_sync(csr_pull::kFull, incl, 31);
    for (long long base = 0; base < total; base += 32) {
      const long long k = base + lane;
      // the row of arc k: the count of rows whose arcs all come before k
      int r = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1)
        if (__shfl_sync(csr_pull::kFull, incl, r + step - 1) <= k) r += step;
      const long long e = __shfl_sync(csr_pull::kFull, off, r) + k;
      const float du = __shfl_sync(csr_pull::kFull, d, r);
      if (k < total) lower(du + __ldcs(w + e), __ldcs(dst + e), dist, fell);
    }
  }
}

}  // namespace

// flabels null: the labels of dist itself, gathered into scratch, 3F int32
// of the caller's (the rows' windows (int2) then labels), and pushed by
// lane groups of ``group``; ids at or past ``bound`` (n) are skipped.
// flabels given: one launch of the explicit-label push, ids at or past
// ``bound`` (the out-CSR's rows) skipped; scratch and group are not read.
extern "C" int frontier_relax_launch(float* dist, const long long* fids,
                                     const float* flabels, int* scratch,
                                     long long F, long long bound,
                                     const int* indptr, const int* dst,
                                     const float* w, unsigned char* fell,
                                     int group, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (F <= 0) return 0;
  if (flabels != nullptr)
    return csr_pull::launch<frontier_push_labels_kernel, 1>(
        F, s, fids, flabels, F, bound, indptr, dst, w, dist, fell);
  auto* win = reinterpret_cast<int2*>(scratch);
  auto* du = reinterpret_cast<float*>(scratch + 2 * F);
  constexpr long long kGatherBlocks = 1024;
  const long long need = (F + csr_pull::kThreads - 1) / csr_pull::kThreads;
  frontier_gather_kernel<<<static_cast<unsigned>(
                               need < kGatherBlocks ? need : kGatherBlocks),
                           csr_pull::kThreads, 0, s>>>(dist, fids, F, bound,
                                                       indptr, du, win);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return csr_pull::with_group(group, [&](auto g) {
    constexpr int G = decltype(g)::value;
    return csr_pull::launch<frontier_push_kernel<G>, G>(F, s, du, win, F,
                                                        dst, w, dist, fell);
  });
}
