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
// pass, one position per thread; passes A and B are the linear-attention
// core of attention_common.cuh, shared with K3:
//   pass 0   GroupNorm statistics of x, two-pass centered, in f32
//   pass A   context_pass on the pre-GN output: k/v projections, online
//            softmax over N with a masked tail, ctx = sum_n k'(d, n) v(e, n)
//   pass B   attend: q projection, softmax over d, ctx^T q, W_o^T, bias;
//            the result y goes to an f32 scratch in device memory
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
// C entry: calo_attention_block_forward, for the one (dtype, C) variant
// of the build (attention_common.cuh); returns cudaGetLastError().

#include "attention_common.cuh"

namespace {

using namespace calo;

constexpr int THREADS = ATT_THREADS;

template <int C>
constexpr int smem_floats() {
  return AttnSmem<C>::FLOATS  // weights, tiles, ctx, k-softmax state
         + 4 * C              // folded pre-GN and post-GN scale/shift
         + ATT_WARPS;         // block reductions
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
  const AttnSmem<C> sm(smem);
  float* s_pre_sc = smem + AttnSmem<C>::FLOATS;
  float* s_pre_sh = s_pre_sc + C;
  float* s_post_sc = s_pre_sh + C;
  float* s_post_sh = s_post_sc + C;
  float* s_red = s_post_sh + C;

  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * N * C;
  const T* xb = x + base;
  float* yb = y_scr + base;
  T* ob = out + base;
  const float denom = static_cast<float>(C) * static_cast<float>(N);

  load_attention_weights<T, C>(sm, w_qkv, w_out, b_out);

  // ---- pass 0: pre-GN statistics (two-pass, centered) -------------------
  float acc = 0.f;
  for (int n = tid; n < N; n += THREADS) {
    float r[C];
    load_row<T, C>(xb + static_cast<size_t>(n) * C, r);
#pragma unroll
    for (int c = 0; c < C; ++c) acc += r[c];
  }
  const float mu = block_sum<THREADS>(acc, s_red) / denom;
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
  const float inv = rsqrtf(block_sum<THREADS>(acc, s_red) / denom + eps);
  if (tid < C) {
    const float sc = gn_pre_scale[tid] * inv;
    s_pre_sc[tid] = sc;
    s_pre_sh[tid] = gn_pre_bias[tid] - sc * mu;
  }
  __syncthreads();

  // the pre-GN output at position n, rounded to T
  auto normed_row = [&](int n, float (&xn)[C]) {
    load_row<T, C>(xb + static_cast<size_t>(n) * C, xn);
#pragma unroll
    for (int c = 0; c < C; ++c) xn[c] = rnd<T>(xn[c] * s_pre_sc[c] + s_pre_sh[c]);
  };

  // ---- pass A: online softmax of k over N, ctx = sum_n k'(d,n) v(e,n) ---
  context_pass<T, C>(sm, N, normed_row);

  // ---- pass B: y = W_o^T (ctx^T softmax_d(q) d^-1/2) + b_o ---------------
  acc = 0.f;
  for (int n = tid; n < N; n += THREADS) {
    float xn[C], y[C];
    normed_row(n, xn);
    attend<T, C>(sm, xn, y);
#pragma unroll
    for (int c = 0; c < C; ++c) acc += y[c];
    store_row<float, C>(yb + static_cast<size_t>(n) * C, y);
  }
  const float mu_y = block_sum<THREADS>(acc, s_red) / denom;

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
  const float inv_y = rsqrtf(block_sum<THREADS>(acc, s_red) / denom + eps);
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
  if (B < 1 || N < 1 || !is_variant(is_bf16, C)) return static_cast<int>(cudaErrorInvalidValue);
  return launch<VariantT, CALO_C>(x, gn_pre_scale, gn_pre_bias, w_qkv, w_out, b_out,
                                  gn_post_scale, gn_post_bias, y_scr, out, B, N, eps,
                                  static_cast<cudaStream_t>(stream));
}
