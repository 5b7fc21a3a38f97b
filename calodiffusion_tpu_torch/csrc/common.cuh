// Helpers shared by every kernel of csrc/: the compute dtype of the build,
// dtype conversions, 16-byte row loads and stores, and a block-wide sum.
//
// Each source builds once per variant; -DCALO_BF16=0|1 picks the compute
// dtype (bf16 or f32), so the variants compile in parallel and each
// library holds one instantiation of its kernel.
#pragma once

#if !defined(CALO_BF16)
#error "build one variant: -DCALO_BF16=0|1"
#endif

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace calo {

#if CALO_BF16
using VariantT = __nv_bfloat16;
#else
using VariantT = float;
#endif

// whether a call's dtype is the variant this library was built for
inline bool is_dtype_variant(int is_bf16) { return (is_bf16 != 0) == (CALO_BF16 != 0); }

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's cast
}

// v rounded to the compute dtype, held in f32 (the Pallas `.astype(cdt)`)
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

// 16 bytes of a row <-> floats: 8 bf16 (bit operations, little-endian
// halves) or 4 f32 values
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* r) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r[2 * i] = __uint_as_float(w[i] << 16);
    r[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load16(const float* p, float* r) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* r) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(r[2 * i]))) |
           (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(r[2 * i + 1]))) << 16);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store16(float* p, const float* r) {
  *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
}

// one row of C elements, 16-byte vector accesses (the wrappers check alignment)
template <typename T, int C>
__device__ __forceinline__ void load_row(const T* __restrict__ p, float (&r)[C]) {
  constexpr int PER = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < C / PER; ++i) load16(p + i * PER, r + i * PER);
}

template <typename T, int C>
__device__ __forceinline__ void store_row(T* __restrict__ p, const float (&r)[C]) {
  constexpr int PER = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < C / PER; ++i) store16(p + i * PER, r + i * PER);
}

// 8 consecutive elements of a row (one bf16 or two f32 vector loads)
template <typename T>
__device__ __forceinline__ void load8(const T* __restrict__ p, float* r) {
  constexpr int PER = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < 8 / PER; ++i) load16(p + i * PER, r + i * PER);
}

// sum over a block of THREADS threads; every thread gets the total
template <int THREADS>
__device__ float block_sum(float v, float* red) {
  constexpr int WARPS = THREADS / 32;
  static_assert(WARPS <= 32, "one reduction slot per warp, read by one warp");
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < WARPS ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  return t;
}

}  // namespace calo
