// The element types of the dense min-plus kernels (relax_matvec.cu,
// relax_matvec_frontier.cu, relax_matmul.cu): float32, bfloat16 and
// float16 labels and matrices, with float32 arithmetic inside.
//
// A 16-bit sweep widens every label and weight to float32 (exact), adds
// and takes the minimum in float32, and rounds the minimum once to the
// element type with round-to-nearest-even.  That equals the plain
// version, which rounds every sum to 16 bits before the min:
// - float32 holds p = 24 bits, at least 2 * 11 + 2 for float16's 11 and
//   bfloat16's 8, so rounding a sum to float32 and then to 16 bits gives
//   the sum correctly rounded to 16 bits (double rounding is innocuous);
// - rounding is monotone, so the rounded minimum is the minimum of the
//   rounded sums.
// A float16 sum from 65520 up rounds to +inf, as a float16 add does.
//
// The partial minima of the blocks (each over a range of rows) meet in
// ``out`` through an atomic min on bit patterns.  For labels and weights
// that are +0, positive or +inf the unsigned order of the bit patterns
// is the float order in all three types.  CUDA has no 16-bit atomicMin, so a 16-bit label is
// lowered with a compare-and-swap on the aligned 32-bit word that holds
// it: the other half of the word is written back as it was read, and a
// CAS that finds the word changed (by either half) reads it again.  Two
// adjacent labels that share an aligned word are lowered by one CAS that
// takes the min of each half (atomic_min2).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace min_plus {

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

// a read-only element of global memory, widened
template <typename T>
__device__ __forceinline__ float load(const T* p) {
  return widen(__ldg(p));
}

// four consecutive 16-bit elements held in one 8-byte word, widened
__device__ __forceinline__ float4 widen4(uint2 w, __nv_bfloat16) {
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}
__device__ __forceinline__ float4 widen4(uint2 w, __half) {
  return make_float4(
      __half2float(__ushort_as_half(static_cast<unsigned short>(w.x))),
      __half2float(__ushort_as_half(static_cast<unsigned short>(w.x >> 16))),
      __half2float(__ushort_as_half(static_cast<unsigned short>(w.y))),
      __half2float(__ushort_as_half(static_cast<unsigned short>(w.y >> 16))));
}

// eight consecutive 16-bit elements held in one 16-byte word, widened
template <typename T>
__device__ __forceinline__ void widen8(uint4 w, T, float (&f)[8]) {
  const float4 a = widen4(make_uint2(w.x, w.y), T{});
  const float4 b = widen4(make_uint2(w.z, w.w), T{});
  f[0] = a.x;
  f[1] = a.y;
  f[2] = a.z;
  f[3] = a.w;
  f[4] = b.x;
  f[5] = b.y;
  f[6] = b.z;
  f[7] = b.w;
}

// the bits of x rounded to nearest even in the 16-bit type
__device__ __forceinline__ unsigned short round_bits(float x, __nv_bfloat16) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ unsigned short round_bits(float x, __half) {
  return __half_as_ushort(__float2half_rn(x));
}

// *o = min(*o, x) for a label that is +0, positive or +inf
__device__ __forceinline__ void atomic_min(float* o, float x) {
  if (x < *o) atomicMin(reinterpret_cast<int*>(o), __float_as_int(x));
}

template <typename T>
__device__ __forceinline__ void atomic_min(T* o, float x) {
  const unsigned want = round_bits(x, T{});
  const std::uintptr_t a = reinterpret_cast<std::uintptr_t>(o);
  unsigned* word = reinterpret_cast<unsigned*>(a & ~std::uintptr_t{3});
  const unsigned shift = (a & 2u) ? 16u : 0u;   // little-endian halves
  const unsigned mask = 0xffffu << shift;
  unsigned old = *reinterpret_cast<volatile unsigned*>(word);
  while (((old & mask) >> shift) > want) {
    const unsigned seen =
        atomicCAS(word, old, (old & ~mask) | (want << shift));
    if (seen == old) break;
    old = seen;
  }
}

// o[0] = min(o[0], lo) and o[1] = min(o[1], hi) for two 16-bit labels
// that are +0, positive or +inf and fill one aligned 32-bit word
template <typename T>
__device__ __forceinline__ void atomic_min2(T* o, float lo, float hi) {
  const unsigned want_lo = round_bits(lo, T{});
  const unsigned want_hi = round_bits(hi, T{});
  unsigned* word = reinterpret_cast<unsigned*>(o);
  unsigned old = *reinterpret_cast<volatile unsigned*>(word);
  for (;;) {
    const unsigned l = min(old & 0xffffu, want_lo);  // little-endian: o[0]
    const unsigned h = min(old >> 16, want_hi);
    const unsigned want = l | (h << 16);
    if (want == old) break;
    const unsigned seen = atomicCAS(word, old, want);
    if (seen == old) break;
    old = seen;
  }
}

}  // namespace min_plus
