// LinearAttention (heads = 1) with its 1x1 convolutions fused in, forward,
// for Hopper (sm_90a).
//
//   y = W_o^T (ctx^T softmax_d(q) d^-1/2) + b_o,
//   q/k/v = W_{q,k,v}^T x, ctx = softmax_N(k) v^T
//
// per sample, dim_head D = 32, x laid out (B, N, C) with C in {32, 64}; y
// in x's dtype.  Replaces the Pallas kernel
// calodiffusion_tpu/ops/pallas_linear_attention.py::_kernel (entry
// fused_linear_attention).  Its backward is autograd of the plain version
// (ops/linear_attention.py), as the JAX custom VJP is.
//
// Design.  K1 without the two GroupNorms and the residual: one block of 256
// threads per sample streams it from device memory (L2) twice, through the
// linear-attention core of attention_common.cuh:
//   pass A   context_pass on x: k/v projections of 256-position tiles,
//            online softmax over N with a masked tail, ctx in shared memory
//   pass B   attend at each position (q projection, softmax over d, ctx^T q,
//            W_o^T, bias), rounded to the compute dtype and stored
//
// Bound.  The card's memory: x read once and y written once (2 * B * N * C
// elements) against ~2 * (128 C + 2048) FLOPs and 64 exponentials a
// position.  The products run on the CUDA cores: simple and right first.
//
// Numerics follow the Pallas kernel: softmaxes and products accumulate in
// f32, with the casts to the compute dtype listed in attention_common.cuh.
//
// C entry: calo_linear_attention_forward, for the one (dtype, C) variant
// of the build; returns cudaGetLastError().

#include "attention_common.cuh"

namespace {

using namespace calo;

constexpr int THREADS = ATT_THREADS;

template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
linear_attention_kernel(const T* __restrict__ x, const T* __restrict__ w_qkv,
                        const T* __restrict__ w_out, const float* __restrict__ b_out,
                        T* __restrict__ out, int N) {
  extern __shared__ __align__(16) float smem[];
  const AttnSmem<C> sm(smem);
  const size_t base = static_cast<size_t>(blockIdx.x) * N * C;
  const T* xb = x + base;
  T* ob = out + base;

  load_attention_weights<T, C>(sm, w_qkv, w_out, b_out);

  auto x_row = [&](int n, float (&r)[C]) { load_row<T, C>(xb + static_cast<size_t>(n) * C, r); };

  // ---- pass A: online softmax of k over N, ctx = sum_n k'(d,n) v(e,n) ---
  context_pass<T, C>(sm, N, x_row);

  // ---- pass B: y = W_o^T (ctx^T softmax_d(q) d^-1/2) + b_o -> T ----------
  for (int n = threadIdx.x; n < N; n += THREADS) {
    float xr[C], y[C];
    x_row(n, xr);
    attend<T, C>(sm, xr, y);
    store_row<T, C>(ob + static_cast<size_t>(n) * C, y);
  }
}

template <typename T, int C>
int launch(const void* x, const void* w_qkv, const void* w_out, const void* b_out, void* out,
           int B, int N, cudaStream_t stream) {
  const size_t smem = AttnSmem<C>::FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(linear_attention_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  linear_attention_kernel<T, C><<<B, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_qkv), static_cast<const T*>(w_out),
      static_cast<const float*>(b_out), static_cast<T*>(out), N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int calo_linear_attention_forward(const void* x, const void* w_qkv,
                                             const void* w_out, const void* b_out, void* out,
                                             int B, int N, int C, int is_bf16, void* stream) {
  if (B < 1 || N < 1 || !is_variant(is_bf16, C)) return static_cast<int>(cudaErrorInvalidValue);
  return launch<VariantT, CALO_C>(x, w_qkv, w_out, b_out, out, B, N,
                                  static_cast<cudaStream_t>(stream));
}
