// Helpers shared by every kernel of csrc/: the compute dtype of the build,
// dtype conversions, 16-byte row loads and stores, the tensor-core,
// ldmatrix and cp.async primitives, and a block-wide sum.  Hopper's TMA,
// mbarriers and wgmma are in hopper.cuh.
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

// ---------------------------------------------------------------------------
// Tensor-core, shared-memory-matrix and asynchronous-copy primitives
// (sm_90a), one PTX instruction each.  The kernels reach mma.sync, ldmatrix
// and cp.async only through these, so the tests' CPU emulation
// (CALO_EMULATION) can supply counterparts that follow the PTX ISA's
// fragment layouts lane by lane.  m16n8k16 with bf16 inputs, f32 sums;
// groupID g = lane >> 2, threadID_in_group t = lane & 3:
//   A (16 x 16, row): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B (16 x 8, col):  b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)
//   C (16 x 8, f32):  c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
// Two bf16 share a 32-bit register, the lower index in the low half.
// m16n8k32 with s8 inputs and s32 sums keeps the same byte positions: a
// register holds 4 int8 of a row (A) or of a column (B), the lowest k in
// the low byte; A a0 (g, 4t..4t+3), a1 (g+8, 4t..), a2 (g, 4t+16..), a3
// (g+8, 4t+16..); B b0 (k 4t..4t+3, n g), b1 (k 4t+16.., n g); C as above.
// ---------------------------------------------------------------------------

// two floats rounded to bf16, packed (lo in the low half)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}
__device__ __forceinline__ float bf16_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

#if defined(CALO_EMULATION)
// the emulation header defines emu_smem_addr, emu_ldmatrix, emu_mma_bf16, emu_mma_s8,
// emu_cp_async16, emu_cp_async_commit, emu_cp_async_wait
__device__ __forceinline__ unsigned smem_addr(const void* p) { return emu_smem_addr(p); }
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  emu_ldmatrix(r, p, false);
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  emu_ldmatrix(r, p, true);
}
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                               unsigned b1) {
  emu_mma_bf16(d, a, b0, b1);
}
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                             unsigned b1) {
  emu_mma_s8(d, a, b0, b1);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  emu_cp_async16(dst, src, full);
}
__device__ __forceinline__ void cp_async_commit() { emu_cp_async_commit(); }
template <int N> __device__ __forceinline__ void cp_async_wait() { emu_cp_async_wait(N); }
__device__ __forceinline__ float exp2_approx(float x) { return exp2f(x); }
#else
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// four 8x8 b16 matrices; lane l gives the address of row l & 7 of matrix
// l >> 3 (16 bytes), and receives (row l >> 2, columns 2(l & 3)..+1) of each
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// the same, each matrix transposed: lane l receives (rows 2(l & 3)..+1, column l >> 2)
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// d += a b, m16n8k16, bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                               unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a b, m16n8k32, s8 inputs, s32 accumulators
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                             unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// 16 bytes global -> shared, asynchronously; zeros when !full (src not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most N of this thread's committed groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// 2^x on the special-function unit (relative error ~2^-22; 0 at -inf)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
#endif

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
