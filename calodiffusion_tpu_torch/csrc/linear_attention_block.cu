// Fused PreNormResidual(LinearAttention) block, forward, for Hopper (sm_90a).
//
//   out = x + GN1_post(W_o^T (ctx^T softmax_d(q) d^-1/2) + b_o),
//   xn = GN1_pre(x), q/k/v = W_{q,k,v}^T xn, ctx = softmax_N(k) v^T
//
// per sample, heads = 1, dim_head D = 32, x laid out (B, N, C) with
// C in {32, 64}.  Replaces the Pallas kernel
// calodiffusion_tpu/ops/pallas_linear_attention.py::_block_kernel.
//
// Design.  The TPU kernel keeps a sample's whole (C, N) slab and an f32
// copy of the attention output in fast memory; a Hopper block has at most
// 227 KB of shared memory, less than one ds2 slab.  So one block of 256
// threads takes one sample and streams it from device memory (L2) once per
// pass, one position per thread:
//   pass 0   GroupNorm statistics of x, two-pass centered, in f32
//   pass A   k/v projections of 256-position tiles into shared memory;
//            online softmax over N (running max, rescaled sum, tail
//            masked to -inf before the max and to 0 after the exp);
//            ctx(d, e) += sum_n k'(d, n) v(e, n), 4 entries per thread
//   pass B   q projection, softmax over d in registers, ctx^T q, W_o^T,
//            bias; the result y goes to an f32 scratch in device memory
//   pass B2  centered variance of y
//   pass C   out = x + GN1_post(y)
// Each thread reads back only the rows of y it wrote itself.
//
// Bound.  The card's memory: the function must read x once and write out
// once (2 * B * N * C elements); its matrix products are ~6 * 1024 * N
// FLOPs a sample, well below the tensor cores' rate per byte.  This kernel
// reads x five times and y three times, mostly from L2, and does its
// products on the CUDA cores: simple and right first, fast later.
//
// Numerics follow the Pallas kernel: statistics, softmaxes and products
// accumulate in f32; values are rounded to the compute dtype T where the
// Pallas kernel casts (pre-GN output, k softmax numerators and v before the
// context product, ctx, the scaled q softmax, the attention output before
// W_o, the post-GN output before the residual add).
//
// C entry: calo_attention_block_forward; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 32;          // dim_head
constexpr int THREADS = 256;   // one position per thread per tile
constexpr int TILE = THREADS;
constexpr int LD = TILE + 1;   // padded row stride of the (D, TILE) tiles
constexpr int WARPS = THREADS / 32;
static_assert(THREADS == 8 * D, "ctx accumulation maps 8 threads per row");

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

// one row of C elements, 16-byte vector accesses (the wrapper checks alignment)
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

// sum over the block; every thread gets the total
__device__ float block_sum(float v, float* red) {
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

template <int C>
constexpr int smem_floats() {
  return 3 * C * D      // w_q, w_k, w_v  (C, D) each
         + D * C        // w_o            (D, C)
         + 5 * C        // folded pre-GN scale/shift, b_o, post-GN scale/shift
         + 2 * D * LD   // k' and v tiles (D, TILE)
         + D * D        // ctx
         + 3 * D        // running max, sum, rescale factor of the k softmax
         + WARPS;       // block reductions
}

template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
attention_block_kernel(const T* __restrict__ x, const float* __restrict__ gn_pre_scale,
                       const float* __restrict__ gn_pre_bias, const T* __restrict__ w_qkv,
                       const T* __restrict__ w_out, const float* __restrict__ b_out,
                       const float* __restrict__ gn_post_scale,
                       const float* __restrict__ gn_post_bias, float* __restrict__ y_scr,
                       T* __restrict__ out, int N, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* s_wq = smem;
  float* s_wk = s_wq + C * D;
  float* s_wv = s_wk + C * D;
  float* s_wo = s_wv + C * D;
  float* s_pre_sc = s_wo + D * C;
  float* s_pre_sh = s_pre_sc + C;
  float* s_bo = s_pre_sh + C;
  float* s_post_sc = s_bo + C;
  float* s_post_sh = s_post_sc + C;
  float* s_k = s_post_sh + C;
  float* s_v = s_k + D * LD;
  float* s_ctx = s_v + D * LD;
  float* s_m = s_ctx + D * D;
  float* s_s = s_m + D;
  float* s_resc = s_s + D;
  float* s_red = s_resc + D;

  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * N * C;
  const T* xb = x + base;
  float* yb = y_scr + base;
  T* ob = out + base;
  const float denom = static_cast<float>(C) * static_cast<float>(N);

  for (int i = tid; i < C * D; i += THREADS) {
    const int c = i / D, d = i % D;
    s_wq[i] = to_f<T>(w_qkv[c * 3 * D + d]);
    s_wk[i] = to_f<T>(w_qkv[c * 3 * D + D + d]);
    s_wv[i] = to_f<T>(w_qkv[c * 3 * D + 2 * D + d]);
    s_wo[i] = to_f<T>(w_out[i]);  // (D, C) row-major, same flat size
  }
  if (tid < C) s_bo[tid] = b_out[tid];
  if (tid < D) {
    s_m[tid] = -INFINITY;
    s_s[tid] = 0.f;
  }

  // ---- pass 0: pre-GN statistics (two-pass, centered) -------------------
  float acc = 0.f;
  for (int n = tid; n < N; n += THREADS) {
    float r[C];
    load_row<T, C>(xb + static_cast<size_t>(n) * C, r);
#pragma unroll
    for (int c = 0; c < C; ++c) acc += r[c];
  }
  const float mu = block_sum(acc, s_red) / denom;
  acc = 0.f;
  for (int n = tid; n < N; n += THREADS) {
    float r[C];
    load_row<T, C>(xb + static_cast<size_t>(n) * C, r);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float d = r[c] - mu;
      acc += d * d;
    }
  }
  const float inv = rsqrtf(block_sum(acc, s_red) / denom + eps);
  if (tid < C) {
    const float sc = gn_pre_scale[tid] * inv;
    s_pre_sc[tid] = sc;
    s_pre_sh[tid] = gn_pre_bias[tid] - sc * mu;
  }
  __syncthreads();

  // ---- pass A: online softmax of k over N, ctx = sum_n k'(d,n) v(e,n) ---
  const int cd = tid >> 3;         // ctx row owned by this thread
  const int ce = tid & 7;          // ctx columns ce, ce+8, ce+16, ce+24
  float cacc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int t0 = 0; t0 < N; t0 += TILE) {
    const int n = t0 + tid;
    if (n < N) {
      float xn[C];
      load_row<T, C>(xb + static_cast<size_t>(n) * C, xn);
#pragma unroll
      for (int c = 0; c < C; ++c) xn[c] = rnd<T>(xn[c] * s_pre_sc[c] + s_pre_sh[c]);
      float k[D], v[D];
#pragma unroll
      for (int d = 0; d < D; ++d) k[d] = v[d] = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4* wk4 = reinterpret_cast<const float4*>(s_wk + c * D);
        const float4* wv4 = reinterpret_cast<const float4*>(s_wv + c * D);
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
        s_k[d * LD + tid] = k[d];
        s_v[d * LD + tid] = rnd<T>(v[d]);
      }
    } else {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s_k[d * LD + tid] = -INFINITY;
        s_v[d * LD + tid] = 0.f;
      }
    }
    __syncthreads();

    // one warp per k row: tile max, rescale, exp, row sum
    const int warp = tid >> 5, lane = tid & 31;
    for (int d = warp; d < D; d += WARPS) {
      float* row = s_k + d * LD;
      float bm = -INFINITY;
      for (int j = lane; j < TILE; j += 32) bm = fmaxf(bm, row[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, o));
      const float m_old = s_m[d];
      const float m_new = fmaxf(m_old, bm);
      float sum = 0.f;
      for (int j = lane; j < TILE; j += 32) {
        const float w = (t0 + j < N) ? expf(row[j] - m_new) : 0.f;
        sum += w;
        row[j] = rnd<T>(w);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float rs = expf(m_old - m_new);
        s_resc[d] = rs;
        s_s[d] = s_s[d] * rs + sum;
        s_m[d] = m_new;
      }
    }
    __syncthreads();

    const int nv = min(TILE, N - t0);
    const float* krow = s_k + cd * LD;
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < nv; ++j) {
      const float w = krow[j];
#pragma unroll
      for (int i = 0; i < 4; ++i) part[i] += w * s_v[(ce + 8 * i) * LD + j];
    }
    const float rs = s_resc[cd];
#pragma unroll
    for (int i = 0; i < 4; ++i) cacc[i] = cacc[i] * rs + part[i];
    __syncthreads();  // the next tile overwrites s_k / s_v
  }
  {
    const float sden = fmaxf(s_s[cd], 1e-30f);
#pragma unroll
    for (int i = 0; i < 4; ++i) s_ctx[cd * D + ce + 8 * i] = rnd<T>(cacc[i] / sden);
  }
  __syncthreads();

  // ---- pass B: y = W_o^T (ctx^T softmax_d(q) d^-1/2) + b_o ---------------
  const float qscale = 0.17677669529663687f;  // 32 ** -0.5
  acc = 0.f;
  for (int n = tid; n < N; n += THREADS) {
    float q[D];
    {
      float xn[C];
      load_row<T, C>(xb + static_cast<size_t>(n) * C, xn);
#pragma unroll
      for (int c = 0; c < C; ++c) xn[c] = rnd<T>(xn[c] * s_pre_sc[c] + s_pre_sh[c]);
#pragma unroll
      for (int d = 0; d < D; ++d) q[d] = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4* wq4 = reinterpret_cast<const float4*>(s_wq + c * D);
#pragma unroll
        for (int j = 0; j < D / 4; ++j) {
          const float4 a = wq4[j];
          q[4 * j] += xn[c] * a.x; q[4 * j + 1] += xn[c] * a.y;
          q[4 * j + 2] += xn[c] * a.z; q[4 * j + 3] += xn[c] * a.w;
        }
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
      const float4* c4 = reinterpret_cast<const float4*>(s_ctx + d * D);
#pragma unroll
      for (int j = 0; j < D / 4; ++j) {
        const float4 a = c4[j];
        o[4 * j] += q[d] * a.x; o[4 * j + 1] += q[d] * a.y;
        o[4 * j + 2] += q[d] * a.z; o[4 * j + 3] += q[d] * a.w;
      }
    }
    float y[C];
#pragma unroll
    for (int c = 0; c < C; ++c) y[c] = 0.f;
#pragma unroll
    for (int e = 0; e < D; ++e) {
      const float oe = rnd<T>(o[e]);
      const float4* w4 = reinterpret_cast<const float4*>(s_wo + e * C);
#pragma unroll
      for (int j = 0; j < C / 4; ++j) {
        const float4 a = w4[j];
        y[4 * j] += oe * a.x; y[4 * j + 1] += oe * a.y;
        y[4 * j + 2] += oe * a.z; y[4 * j + 3] += oe * a.w;
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      y[c] += s_bo[c];
      acc += y[c];
    }
    store_row<float, C>(yb + static_cast<size_t>(n) * C, y);
  }
  const float mu_y = block_sum(acc, s_red) / denom;

  // ---- pass B2: post-GN variance (centered) ------------------------------
  acc = 0.f;
  for (int n = tid; n < N; n += THREADS) {
    float y[C];
    load_row<float, C>(yb + static_cast<size_t>(n) * C, y);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float d = y[c] - mu_y;
      acc += d * d;
    }
  }
  const float inv_y = rsqrtf(block_sum(acc, s_red) / denom + eps);
  if (tid < C) {
    const float sc = gn_post_scale[tid] * inv_y;
    s_post_sc[tid] = sc;
    s_post_sh[tid] = gn_post_bias[tid] - sc * mu_y;
  }
  __syncthreads();

  // ---- pass C: out = x + GN1_post(y) -------------------------------------
  for (int n = tid; n < N; n += THREADS) {
    float r[C], y[C];
    load_row<T, C>(xb + static_cast<size_t>(n) * C, r);
    load_row<float, C>(yb + static_cast<size_t>(n) * C, y);
#pragma unroll
    for (int c = 0; c < C; ++c) r[c] += rnd<T>(y[c] * s_post_sc[c] + s_post_sh[c]);
    store_row<T, C>(ob + static_cast<size_t>(n) * C, r);
  }
}

template <typename T, int C>
int launch(const void* x, const void* gps, const void* gpb, const void* w_qkv,
           const void* w_out, const void* b_out, const void* gos, const void* gob,
           void* y_scr, void* out, int B, int N, float eps, cudaStream_t stream) {
  const size_t smem = smem_floats<C>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attention_block_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_block_kernel<T, C><<<B, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gps),
      static_cast<const float*>(gpb), static_cast<const T*>(w_qkv),
      static_cast<const T*>(w_out), static_cast<const float*>(b_out),
      static_cast<const float*>(gos), static_cast<const float*>(gob),
      static_cast<float*>(y_scr), static_cast<T*>(out), N, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int calo_attention_block_forward(const void* x, const void* gn_pre_scale,
                                            const void* gn_pre_bias, const void* w_qkv,
                                            const void* w_out, const void* b_out,
                                            const void* gn_post_scale,
                                            const void* gn_post_bias, void* y_scr,
                                            void* out, int B, int N, int C, int is_bf16,
                                            float eps, void* stream) {
  if (B < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
#define CALO_LAUNCH(T, CC)                                                              \
  return launch<T, CC>(x, gn_pre_scale, gn_pre_bias, w_qkv, w_out, b_out, gn_post_scale, \
                       gn_post_bias, y_scr, out, B, N, eps, s)
  if (is_bf16) {
    if (C == 32) CALO_LAUNCH(__nv_bfloat16, 32);
    if (C == 64) CALO_LAUNCH(__nv_bfloat16, 64);
  } else {
    if (C == 32) CALO_LAUNCH(float, 32);
    if (C == 64) CALO_LAUNCH(float, 64);
  }
#undef CALO_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
