// GroupNorm(G) with its per-channel affine and an optional SiLU, forward,
// for Hopper (sm_90a).
//
//   y = (x - mean_g) rsqrt(var_g + eps) scale_c + bias_c,  out = y sigmoid(y)
//
// over channels-last x (B, S, C): the statistics of group g are taken per
// sample over its S positions and C/G channels.  C and G at run time, C at
// most 384 and divisible by G.  Replaces the Pallas kernel
// calodiffusion_tpu/ops/pallas_groupnorm.py::_gn_silu_kernel (entry
// groupnorm_silu).  Forward only, as in the JAX package.
//
// Design.  The TPU kernel holds a sample's (S, C) slab in VMEM and takes
// its variance in one pass, E[x^2] - mean^2.  A Hopper block cannot hold a
// ds3 sample (40,500 x 32 values), so one block of 384 threads takes one
// sample and streams it three times: the group means, the centered
// variance (two-pass, so no cancellation over ~10^5 terms a group), and
// the output.  Thread t keeps one channel, c = t mod C, and walks the rows
// t / C, t / C + 384 / C, ...: a warp reads consecutive addresses, and each
// thread's statistics and affine stay in registers.  Per-thread partial
// sums meet in shared memory, where G threads sum their group's.
//
// Bound.  The card's memory: x read once and out written once (2 B S C
// elements), against ~10 FLOPs and one exponential an element.  This kernel
// reads x three times, from L2 where a sample fits.
//
// Numerics: statistics, affine and SiLU in f32, one rounding to the input
// dtype at the store (the plain version's casts).
//
// C entry: calo_groupnorm_silu_forward, for the one dtype variant of the
// build; returns cudaGetLastError().

#include "common.cuh"

namespace {

using namespace calo;

constexpr int THREADS = 384;  // a multiple of 32, 64 and 96 channels

template <typename T>
__global__ void __launch_bounds__(THREADS)
groupnorm_silu_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ out, int S, int C,
                      int G, float eps, int apply_silu) {
  extern __shared__ __align__(16) float smem[];
  float* s_part = smem;              // (THREADS) per-thread partial sums
  float* s_mean = smem + THREADS;    // (G)
  float* s_inv = s_mean + THREADS;   // (G)

  const int tid = threadIdx.x;
  const int rows_per_step = THREADS / C;       // rows a step of the block covers
  const int active = rows_per_step * C;        // threads that own a channel
  const bool owns = tid < active;
  const int c = tid % C, cg = C / G, g = c / cg;
  const size_t base = static_cast<size_t>(blockIdx.x) * S * C;
  const T* xb = x + base;
  T* ob = out + base;
  const float denom = static_cast<float>(S) * static_cast<float>(cg);

  // the sum over the block's partials of group g, for thread g < G
  auto group_sum = [&](int grp) {
    float t = 0.f;
    for (int r = 0; r < rows_per_step; ++r)
      for (int j = 0; j < cg; ++j) t += s_part[r * C + grp * cg + j];
    return t;
  };

  // ---- pass 1: group means ----------------------------------------------
  float acc = 0.f;
  if (owns) {
#pragma unroll 4
    for (int r = tid / C; r < S; r += rows_per_step)
      acc += to_f<T>(xb[static_cast<size_t>(r) * C + c]);
  }
  s_part[tid] = acc;
  __syncthreads();
  if (tid < G) s_mean[tid] = group_sum(tid) / denom;
  __syncthreads();
  const float mu = s_mean[g];

  // ---- pass 2: centered group variances -----------------------------------
  acc = 0.f;
  if (owns) {
#pragma unroll 4
    for (int r = tid / C; r < S; r += rows_per_step) {
      const float d = to_f<T>(xb[static_cast<size_t>(r) * C + c]) - mu;
      acc += d * d;
    }
  }
  __syncthreads();  // every thread has read s_mean; s_part is free again
  s_part[tid] = acc;
  __syncthreads();
  if (tid < G) s_inv[tid] = rsqrtf(group_sum(tid) / denom + eps);
  __syncthreads();

  // ---- pass 3: normalise, affine, SiLU ------------------------------------
  if (!owns) return;
  const float sc = s_inv[g] * scale[c], b = bias[c];
#pragma unroll 4
  for (int r = tid / C; r < S; r += rows_per_step) {
    const size_t i = static_cast<size_t>(r) * C + c;
    float y = (to_f<T>(xb[i]) - mu) * sc + b;
    if (apply_silu) y = y / (1.f + expf(-y));
    ob[i] = from_f<T>(y);
  }
}

template <typename T>
int launch(const void* x, const void* scale, const void* bias, void* out, int B, int S, int C,
           int G, float eps, int apply_silu, cudaStream_t stream) {
  const size_t smem = 3 * THREADS * sizeof(float);
  groupnorm_silu_kernel<T><<<B, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(out), S, C, G, eps, apply_silu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int calo_groupnorm_silu_forward(const void* x, const void* scale, const void* bias,
                                           void* out, int B, int S, int C, int G, int is_bf16,
                                           float eps, int apply_silu, void* stream) {
  if (B < 1 || S < 1 || C < 1 || C > THREADS || G < 1 || C % G || !is_dtype_variant(is_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<VariantT>(x, scale, bias, out, B, S, C, G, eps, apply_silu,
                          static_cast<cudaStream_t>(stream));
}
