// Issue-rate probe for the float32 instructions of a min-plus product:
// FADD alone, FMNMX alone, and the pair acc = fminf(acc, d + w) that the
// dense and CSR relaxation kernels execute once for each element.
//
// Each thread runs 16 independent chains, so the latency of one
// instruction is hidden and the issue rate is the limit; the one operand
// that changes each iteration (w += 1) keeps the compiler from hoisting or
// folding any of the 16 operations.  tools/min_plus_rate.py times it and
// counts 16 instructions an iteration: that extra add makes each rate an
// underestimate by at most 1/16.
#include <cuda_runtime.h>

namespace {

constexpr int kChains = 16;

template <int kMode>  // 0: adds, 1: mins, 2: add + min pairs
__global__ void probe_kernel(float* out, float seed, int iters) {
  float acc[kChains], d[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j) {
    acc[j] = seed * static_cast<float>(j + 1) + 1e30f;
    d[j] = seed + static_cast<float>(threadIdx.x + j);
  }
  float w = seed;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) {
      if constexpr (kMode == 0) acc[j] = acc[j] + w;
      if constexpr (kMode == 1) acc[j] = fminf(acc[j], w);
      if constexpr (kMode == 2) acc[j] = fminf(acc[j], d[j] + w);
    }
    w += 1.0f;
  }
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < kChains; ++j) sum += acc[j];
  out[static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x] = sum;
}

}  // namespace

// out must hold blocks * threads floats
extern "C" int min_plus_probe_launch(float* out, int mode, int iters,
                                     int blocks, int threads, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      probe_kernel<0><<<blocks, threads, 0, s>>>(out, 0.5f, iters);
      break;
    case 1:
      probe_kernel<1><<<blocks, threads, 0, s>>>(out, 0.5f, iters);
      break;
    case 2:
      probe_kernel<2><<<blocks, threads, 0, s>>>(out, 0.5f, iters);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
