// The one (dtype, C) variant a build of the linear-attention kernels (K1,
// K2, K3) compiles, and the linear-attention core of K3 (K1 ran it until its
// cluster design, linear_attention_block.cu).
//
// Each source builds once per variant, -DCALO_BF16=0|1 -DCALO_C=32|64 (the
// compute dtype and the channel count), so the variants compile in
// parallel and each library holds one instantiation of its kernel.
//
// The core runs one block of ATT_THREADS threads per sample,
// heads = 1, dim_head D = 32:
//   context_pass  k/v projections of 256-position tiles into shared memory;
//                 online softmax over N (running max, rescaled sum, tail
//                 masked to -inf before the max and to 0 after the exp);
//                 ctx(d, e) = sum_n k'(d, n) v(e, n), 4 entries per thread
//   attend        for one position: q projection, softmax over d in
//                 registers, ctx^T q d^-1/2, W_o^T, bias
// Values are rounded to the compute dtype T where the Pallas kernels cast:
// k softmax numerators and v before the context product, ctx, the scaled q
// softmax, and the attention output before W_o.
#pragma once

#if !defined(CALO_C)
#error "build one variant: -DCALO_BF16=0|1 -DCALO_C=32|64"
#endif

#include "common.cuh"

namespace calo {

constexpr int D = 32;  // dim_head

// whether a call's (is_bf16, C) is the variant this library was built for
inline bool is_variant(int is_bf16, int C) { return is_dtype_variant(is_bf16) && C == CALO_C; }

constexpr int ATT_THREADS = 256;      // one position per thread per tile
constexpr int ATT_TILE = ATT_THREADS;
constexpr int ATT_LD = ATT_TILE + 1;  // padded row stride of the (D, TILE) tiles
constexpr int ATT_WARPS = ATT_THREADS / 32;
static_assert(ATT_THREADS == 8 * D, "ctx accumulation maps 8 threads per row");

// The core's shared memory, carved from the front of the kernel's dynamic
// shared memory; every array starts on a 16-byte boundary for C in {32, 64}.
template <int C>
struct AttnSmem {
  static constexpr int FLOATS = 3 * C * D      // w_q, w_k, w_v  (C, D) each
                                + D * C        // w_o            (D, C)
                                + C            // b_o
                                + 2 * D * ATT_LD  // k' and v tiles (D, TILE)
                                + D * D        // ctx
                                + 3 * D;       // running max, sum, rescale of the k softmax
  float *wq, *wk, *wv, *wo, *bo, *k, *v, *ctx, *m, *s, *resc;
  __device__ explicit AttnSmem(float* p)
      : wq(p), wk(wq + C * D), wv(wk + C * D), wo(wv + C * D), bo(wo + D * C),
        k(bo + C), v(k + D * ATT_LD), ctx(v + D * ATT_LD), m(ctx + D * D), s(m + D),
        resc(s + D) {}
};

// w_qkv (C, 3D) row-major -> w_q, w_k, w_v (C, D); w_out (D, C); b_out (C);
// the k softmax's running max and sum; ends in a barrier
template <typename T, int C>
__device__ void load_attention_weights(const AttnSmem<C>& sm, const T* __restrict__ w_qkv,
                                       const T* __restrict__ w_out,
                                       const float* __restrict__ b_out) {
  const int tid = threadIdx.x;
  for (int i = tid; i < C * D; i += ATT_THREADS) {
    const int c = i / D, d = i % D;
    sm.wq[i] = to_f<T>(w_qkv[c * 3 * D + d]);
    sm.wk[i] = to_f<T>(w_qkv[c * 3 * D + D + d]);
    sm.wv[i] = to_f<T>(w_qkv[c * 3 * D + 2 * D + d]);
    sm.wo[i] = to_f<T>(w_out[i]);  // (D, C) row-major, same flat size
  }
  if (tid < C) sm.bo[tid] = b_out[tid];
  if (tid < D) {
    sm.m[tid] = -INFINITY;
    sm.s[tid] = 0.f;
  }
  __syncthreads();
}

// ctx = softmax_N(W_k^T xn) (W_v^T xn)^T into sm.ctx, rounded to T.
// row(n, r) fills r[C] with the projections' input at position n (f32
// holding compute-dtype values).  Ends in a barrier.
template <typename T, int C, class Row>
__device__ __forceinline__ void context_pass(const AttnSmem<C>& sm, int N, Row row) {
  const int tid = threadIdx.x;
  const int cd = tid >> 3;         // ctx row owned by this thread
  const int ce = tid & 7;          // ctx columns ce, ce+8, ce+16, ce+24
  float cacc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int t0 = 0; t0 < N; t0 += ATT_TILE) {
    const int n = t0 + tid;
    if (n < N) {
      float xn[C];
      row(n, xn);
      float k[D], v[D];
#pragma unroll
      for (int d = 0; d < D; ++d) k[d] = v[d] = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4* wk4 = reinterpret_cast<const float4*>(sm.wk + c * D);
        const float4* wv4 = reinterpret_cast<const float4*>(sm.wv + c * D);
#pragma unroll
        for (int j = 0; j < D / 4; ++j) {
          const float4 a = wk4[j], b = wv4[j];
          k[4 * j] += xn[c] * a.x; k[4 * j + 1] += xn[c] * a.y;
          k[4 * j + 2] += xn[c] * a.z; k[4 * j + 3] += xn[c] * a.w;
          v[4 * j] += xn[c] * b.x; v[4 * j + 1] += xn[c] * b.y;
          v[4 * j + 2] += xn[c] * b.z; v[4 * j + 3] += xn[c] * b.w;
        }
      }
#pragma unroll
      for (int d = 0; d < D; ++d) {
        sm.k[d * ATT_LD + tid] = k[d];
        sm.v[d * ATT_LD + tid] = rnd<T>(v[d]);
      }
    } else {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        sm.k[d * ATT_LD + tid] = -INFINITY;
        sm.v[d * ATT_LD + tid] = 0.f;
      }
    }
    __syncthreads();

    // one warp per k row: tile max, rescale, exp, row sum
    const int warp = tid >> 5, lane = tid & 31;
    for (int d = warp; d < D; d += ATT_WARPS) {
      float* krow = sm.k + d * ATT_LD;
      float bm = -INFINITY;
      for (int j = lane; j < ATT_TILE; j += 32) bm = fmaxf(bm, krow[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, o));
      const float m_old = sm.m[d];
      const float m_new = fmaxf(m_old, bm);
      float sum = 0.f;
      for (int j = lane; j < ATT_TILE; j += 32) {
        const float w = (t0 + j < N) ? expf(krow[j] - m_new) : 0.f;
        sum += w;
        krow[j] = rnd<T>(w);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float rs = expf(m_old - m_new);
        sm.resc[d] = rs;
        sm.s[d] = sm.s[d] * rs + sum;
        sm.m[d] = m_new;
      }
    }
    __syncthreads();

    const int nv = min(ATT_TILE, N - t0);
    const float* krow = sm.k + cd * ATT_LD;
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < nv; ++j) {
      const float w = krow[j];
#pragma unroll
      for (int i = 0; i < 4; ++i) part[i] += w * sm.v[(ce + 8 * i) * ATT_LD + j];
    }
    const float rs = sm.resc[cd];
#pragma unroll
    for (int i = 0; i < 4; ++i) cacc[i] = cacc[i] * rs + part[i];
    __syncthreads();  // the next tile overwrites sm.k / sm.v
  }
  const float sden = fmaxf(sm.s[cd], 1e-30f);
#pragma unroll
  for (int i = 0; i < 4; ++i) sm.ctx[cd * D + ce + 8 * i] = rnd<T>(cacc[i] / sden);
  __syncthreads();
}

// y = W_o^T (ctx^T softmax_d(W_q^T xn) d^-1/2) + b_o at one position, in f32
template <typename T, int C>
__device__ __forceinline__ void attend(const AttnSmem<C>& sm, const float (&xn)[C],
                                       float (&y)[C]) {
  const float qscale = 0.17677669529663687f;  // 32 ** -0.5
  float q[D];
#pragma unroll
  for (int d = 0; d < D; ++d) q[d] = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float4* wq4 = reinterpret_cast<const float4*>(sm.wq + c * D);
#pragma unroll
    for (int j = 0; j < D / 4; ++j) {
      const float4 a = wq4[j];
      q[4 * j] += xn[c] * a.x; q[4 * j + 1] += xn[c] * a.y;
      q[4 * j + 2] += xn[c] * a.z; q[4 * j + 3] += xn[c] * a.w;
    }
  }
  float mx = q[0];
#pragma unroll
  for (int d = 1; d < D; ++d) mx = fmaxf(mx, q[d]);
  float qs = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] = expf(q[d] - mx);
    qs += q[d];
  }
#pragma unroll
  for (int d = 0; d < D; ++d) q[d] = rnd<T>(q[d] / qs * qscale);
  float o[D];
#pragma unroll
  for (int e = 0; e < D; ++e) o[e] = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float4* c4 = reinterpret_cast<const float4*>(sm.ctx + d * D);
#pragma unroll
    for (int j = 0; j < D / 4; ++j) {
      const float4 a = c4[j];
      o[4 * j] += q[d] * a.x; o[4 * j + 1] += q[d] * a.y;
      o[4 * j + 2] += q[d] * a.z; o[4 * j + 3] += q[d] * a.w;
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) y[c] = 0.f;
#pragma unroll
  for (int e = 0; e < D; ++e) {
    const float oe = rnd<T>(o[e]);
    const float4* w4 = reinterpret_cast<const float4*>(sm.wo + e * C);
#pragma unroll
    for (int j = 0; j < C / 4; ++j) {
      const float4 a = w4[j];
      y[4 * j] += oe * a.x; y[4 * j + 1] += oe * a.y;
      y[4 * j + 2] += oe * a.z; y[4 * j + 3] += oe * a.w;
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) y[c] += sm.bo[c];
}

}  // namespace calo
