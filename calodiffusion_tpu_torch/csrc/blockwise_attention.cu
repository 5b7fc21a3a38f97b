// Softmax attention over the flattened voxel grid with streaming (online)
// normalisation, forward, for Hopper (sm_90a).
//
//   out = softmax(q k^T D^-1/2) v     over (B*H, N, D), D = 32
//
// Replaces the Pallas kernel
// calodiffusion_tpu/ops/pallas_attention.py::_attention_kernel (entry
// blockwise_attention).  Forward only, as in the JAX package.
//
// Design.  The TPU kernel walks a sequential (B*H, q block, kv block) grid
// and carries the running max, denominator and numerator of a 512-row
// query block in VMEM scratch.  Here the carried state lives in registers:
// one block of 128 threads takes 128 query rows of one (b, h), one row per
// thread (its scaled q, running max m, denominator l and numerator acc[D],
// all f32), and walks the keys in tiles of 64 rows that the block stages
// in shared memory as f32.  Each thread scores 16 keys at a time against
// its row (the tile's keys are read by every thread at once: a broadcast),
// rescales its state once for the 16 and accumulates p * v.  Keys past N
// are masked by bounds (no padded copy of the tensors): they are never
// scored, where the Pallas kernel pads N to 512 and masks to -1e30.
// Queries past N compute nothing and store nothing.  Blocks are
// independent, so B*H*ceil(N/128) of them fill the card.
//
// Bound.  One exponential per score against 4 D = 128 FLOPs of the two
// products: at D = 32 the special-function units (16 exponentials per SM
// per clock) bound the bf16 work before the tensor cores do, and the f32
// products on the CUDA cores bound the f32 work.  This kernel does its
// products on the CUDA cores in both dtypes: simple and right first.
//
// Numerics follow the Pallas kernel: q, k, v widened to f32, q scaled by
// D^-1/2 before the product, scores, exponentials and sums in f32, out =
// acc / l rounded to the input dtype.
//
// C entry: calo_blockwise_attention_forward, for the one dtype variant of
// the build; returns cudaGetLastError().

#include "common.cuh"

namespace {

using namespace calo;

constexpr int D = 32;         // head dim
constexpr int THREADS = 128;  // one query row per thread
constexpr int BQ = THREADS;   // query rows per block
constexpr int BK = 64;        // keys per shared-memory tile
constexpr int CH = 16;        // keys scored between two rescales
static_assert(BK % CH == 0, "a tile holds whole chunks");

template <typename T>
__global__ void __launch_bounds__(THREADS)
blockwise_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out, int N,
                           int n_qtiles, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* s_k = smem;           // (BK, D)
  float* s_v = smem + BK * D;  // (BK, D)
  constexpr int PER = 16 / sizeof(T);

  const int bh = blockIdx.x / n_qtiles;
  const int row = (blockIdx.x % n_qtiles) * BQ + threadIdx.x;
  const bool has_row = row < N;
  const size_t base = static_cast<size_t>(bh) * N * D;

  float qr[D], acc[D];
  if (has_row) {
    load_row<T, D>(q + base + static_cast<size_t>(row) * D, qr);
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] *= scale;
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < N; k0 += BK) {
    const int nk = min(BK, N - k0);
    __syncthreads();  // the previous tile is consumed
    const size_t off = base + static_cast<size_t>(k0) * D;
    for (int i = threadIdx.x; i < nk * D / PER; i += THREADS) {
      load16(k + off + i * PER, s_k + i * PER);
      load16(v + off + i * PER, s_v + i * PER);
    }
    __syncthreads();

    for (int j0 = 0; j0 < nk; j0 += CH) {
      float s[CH];
      float bm = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        float dot = -INFINITY;
        if (j0 + jj < nk) {
          const float4* k4 = reinterpret_cast<const float4*>(s_k + (j0 + jj) * D);
          dot = 0.f;
#pragma unroll
          for (int i = 0; i < D / 4; ++i) {
            const float4 a = k4[i];
            dot += qr[4 * i] * a.x + qr[4 * i + 1] * a.y + qr[4 * i + 2] * a.z +
                   qr[4 * i + 3] * a.w;
          }
        }
        s[jj] = dot;
        bm = fmaxf(bm, dot);
      }
      const float m_new = fmaxf(m, bm);  // finite: the chunk holds a key
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        if (j0 + jj < nk) {
          const float p = expf(s[jj] - m_new);
          l += p;
          const float4* v4 = reinterpret_cast<const float4*>(s_v + (j0 + jj) * D);
#pragma unroll
          for (int i = 0; i < D / 4; ++i) {
            const float4 b = v4[i];
            acc[4 * i] += p * b.x; acc[4 * i + 1] += p * b.y;
            acc[4 * i + 2] += p * b.z; acc[4 * i + 3] += p * b.w;
          }
        }
      }
      m = m_new;
    }
  }
  if (has_row) {
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = acc[d] / l;
    store_row<T, D>(out + base + static_cast<size_t>(row) * D, acc);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int N, float scale,
           cudaStream_t stream) {
  const int n_qtiles = (N + BQ - 1) / BQ;
  const size_t smem = 2 * BK * D * sizeof(float);
  blockwise_attention_kernel<T><<<BH * n_qtiles, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), N, n_qtiles, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int calo_blockwise_attention_forward(const void* q, const void* k, const void* v,
                                                void* out, int BH, int N, int head_dim,
                                                int is_bf16, float scale, void* stream) {
  const long long blocks = static_cast<long long>(BH) * ((N + BQ - 1) / BQ);
  if (BH < 1 || N < 1 || head_dim != D || blocks > 0x7fffffffLL || !is_dtype_variant(is_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<VariantT>(q, k, v, out, BH, N, scale, static_cast<cudaStream_t>(stream));
}
