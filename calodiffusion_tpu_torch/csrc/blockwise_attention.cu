// Softmax attention over the flattened voxel grid with streaming (online)
// normalisation, forward, for Hopper (sm_90a).
//
//   out = softmax(q k^T D^-1/2) v     over (B*H, N, D), D = 32
//
// Replaces the Pallas kernel
// calodiffusion_tpu/ops/pallas_attention.py::_attention_kernel (entry
// blockwise_attention).  Where the caller asks for it (a non-null lse), each
// query row's log-sum-exp of the scaled scores, lse = log(sum_j exp(S_j c)),
// c = D^-1/2, natural log, f32 (B*H, N): what the backward
// (blockwise_attention_bwd.cu) recomputes the probabilities from.
//
// Bound.  At D = 32 each score costs 4 D = 128 FLOPs of the two products
// and one exponential: the special-function units (16 exponentials per SM
// per clock) bound the work long before the tensor cores do, so the
// products belong on the tensor cores and the path from score to
// probability has to be short.  The TPU kernel walks a sequential
// (B*H, q block, kv block) grid and carries a 512-row query block's max,
// denominator and numerator in VMEM scratch; here blocks run in no order
// and the carried state lives in registers.
//
// bf16 design (FlashAttention-2's shape, mma.sync).  One block of 4 warps
// takes 64 query rows of one (b, h), 16 rows a warp.  K and V stream in
// tiles of 64 keys, kept bf16 in shared memory (rows padded to 80 bytes so
// ldmatrix reads are free of bank conflicts), double-buffered with
// cp.async.  Per tile and warp:
//   S = Q K^T     m16n8k16 mma (bf16 in, f32 sums: the products of bf16
//                 inputs are exact, as in the Pallas kernel's f32 dot),
//                 Q and K fragments by ldmatrix;
//   P = 2^(S c - m), c = D^-1/2 log2(e): one FFMA and one ex2 a score;
//                 the running max m and the rescale alpha once a tile;
//                 the row sum l in f32 from the f32 P;
//   O += P V      on the tensor cores with P split into bf16 hi + lo parts
//                 (two mmas, ~16 bits of P: one bf16 rounding of P costs up
//                 to 2^-9 relative a term, beyond K4_TOL where a few keys
//                 carry the weight); V is exact in bf16, fragments by
//                 ldmatrix.trans.
// Keys past N are masked by bounds in the last tile (the zero-filled rows of
// cp.async score -inf before the max and weigh 0 after the exponential): no
// padded copy of the tensors.  Queries past N store nothing.
//
// f32 design: the CUDA-core body of the first port, kept.  TF32 has 10
// mantissa bits on scores of order 5, beyond K4_TOL[f32] = 1e-4, and 3xTF32
// would triple the tensor-core work for a variant no shipped model runs.
// One block of 128 threads takes 128 query rows, one row a thread (its
// scaled q, m, l and acc[D] in f32), keys staged in shared memory as f32,
// one rescale per 16 keys.
//
// Numerics follow the Pallas kernel: scores, exponentials and sums in f32,
// out = acc / l rounded to the input dtype.
//
// Measured on one NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py,
// scripts/torch_kernel_variants.py): bf16 20.8 ms at (B*H, N) = (16, 40,500)
// against 15.9 ms for PyTorch's SDPA and a 6.3 ms exponential bound; the
// split of P costs about a fifth of it, warps and tile sizes change it by
// at most 21 %: the instructions issued a score are the limit.
//
// C entry: calo_blockwise_attention_forward (lse may be null), for the one
// dtype variant of the build; returns cudaGetLastError().

#include "common.cuh"

namespace {

using namespace calo;

constexpr int D = 32;  // head dim
constexpr float LN2 = 0.6931471805599453f;

#if CALO_BF16

using bf16 = __nv_bfloat16;
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;  // query rows per block, 16 a warp
constexpr int BK = 64;          // keys per shared-memory tile
constexpr int NT = BK / 8;      // key tiles of 8 in a tile
constexpr int LD = D + 8;       // padded row of a tile, 80 bytes
constexpr size_t SMEM_BYTES = (BQ + 4 * BK) * LD * sizeof(bf16);  // q, k[2], v[2]

// ROWS rows of D from src into a padded tile; rows past `valid` are zeros
template <int ROWS>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, int valid) {
  for (int i = threadIdx.x; i < ROWS * (D / 8); i += THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * LD + c, src + (ok ? r : 0) * D + c, ok);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
blockwise_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           float* __restrict__ lse, int N, int n_qtiles, float scale) {
  extern __shared__ __align__(16) float smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_k = s_q + BQ * LD;      // 2 buffers
  bf16* s_v = s_k + 2 * BK * LD;  // 2 buffers

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * BQ;
  const size_t base = static_cast<size_t>(bh) * N * D;
  const int n_tiles = (N + BK - 1) / BK;
  const float c = scale * 1.4426950408889634f;  // D^-1/2 log2(e)

  stage_tile<BQ>(s_q, q + base + static_cast<size_t>(q0) * D, N - q0);
  stage_tile<BK>(s_k, k + base, N);
  stage_tile<BK>(s_v, v + base, N);
  cp_async_commit();

  // rows g (r = 0) and g + 8 (r = 1) of this warp's 16
  unsigned qa[2][4];                    // Q fragments, d 0-15 and 16-31
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l[2] = {0.f, 0.f};              // this thread's part of the row sums
  float o[4][4];                        // O, d tiles of 8
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      const size_t off = base + static_cast<size_t>(j + 1) * BK * D;
      const int valid = N - (j + 1) * BK;
      stage_tile<BK>(s_k + (buf ^ 1) * BK * LD, k + off, valid);
      stage_tile<BK>(s_v + (buf ^ 1) * BK * LD, v + off, valid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and q) have landed
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        ldmatrix_x4(qa[kk], s_q + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                kk * 16 + (lane >> 4) * 8);
    }
    const bf16* kt = s_k + buf * BK * LD;
    const bf16* vt = s_v + buf * BK * LD;

    // S = Q K^T, key tiles of 8
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
      unsigned b[4];
      ldmatrix_x4(b, kt + (nt * 8 + (lane & 7)) * LD + (lane >> 3) * 8);
      mma_bf16_16816(s[nt], qa[0], b[0], b[1]);
      mma_bf16_16816(s[nt], qa[1], b[2], b[3]);
    }
    const int nk = N - j * BK;  // keys of this tile
    if (nk < BK) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (nt * 8 + 2 * t + (i & 1) >= nk) s[nt][i] = -INFINITY;
    }

    // online softmax, one rescale a tile
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx * c);  // finite: the tile holds a key
      const float alpha = exp2_approx(m[r] - m_new);
      m[r] = m_new;
#pragma unroll
      for (int dt = 0; dt < 4; ++dt) {
        o[dt][2 * r] *= alpha;
        o[dt][2 * r + 1] *= alpha;
      }
      float p_sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 2 * r; i < 2 * r + 2; ++i) {
          s[nt][i] = exp2_approx(fmaf(s[nt][i], c, -m_new));
          p_sum += s[nt][i];
        }
      l[r] = l[r] * alpha + p_sum;
    }

    // O += P V over key steps of 16; P = hi + lo, both bf16
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* p = &s[2 * kk + (i >> 1)][2 * (i & 1)];  // a0..a3 of the C layout
        hi[i] = pack_bf16(p[0], p[1]);
        lo[i] = pack_bf16(p[0] - bf16_lo(hi[i]), p[1] - bf16_hi(hi[i]));
      }
#pragma unroll
      for (int dp = 0; dp < 2; ++dp) {
        unsigned b[4];
        ldmatrix_x4_trans(b, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                 (dp * 2 + (lane >> 4)) * 8);
        mma_bf16_16816(o[2 * dp], hi, b[0], b[1]);
        mma_bf16_16816(o[2 * dp], lo, b[0], b[1]);
        mma_bf16_16816(o[2 * dp + 1], hi, b[2], b[3]);
        mma_bf16_16816(o[2 * dp + 1], lo, b[2], b[3]);
      }
    }
    __syncthreads();  // this buffer is refilled at iteration j + 1
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row < N) {
      const float inv = 1.f / l[r];
      unsigned* dst = reinterpret_cast<unsigned*>(out + base + static_cast<size_t>(row) * D);
#pragma unroll
      for (int dt = 0; dt < 4; ++dt)
        dst[dt * 4 + t] = pack_bf16(o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
      // m and log2(l) are in log2 units of S c: lse in natural units
      if (lse != nullptr && t == 0)
        lse[static_cast<size_t>(bh) * N + row] = (m[r] + log2f(l[r])) * LN2;
    }
  }
}

#else  // f32: one query row a thread, products on the CUDA cores

constexpr int THREADS = 128;  // one query row per thread
constexpr int BQ = THREADS;   // query rows per block
constexpr int BK = 64;        // keys per shared-memory tile
constexpr int CH = 16;        // keys scored between two rescales
static_assert(BK % CH == 0, "a tile holds whole chunks");
constexpr size_t SMEM_BYTES = 2 * BK * D * sizeof(float);

template <typename T>
__global__ void __launch_bounds__(THREADS)
blockwise_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           float* __restrict__ lse, int N, int n_qtiles, float scale) {
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
    if (lse != nullptr) lse[static_cast<size_t>(bh) * N + row] = m + logf(l);
  }
}

#endif

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int BH, int N,
           float scale, cudaStream_t stream) {
  const int n_qtiles = (N + BQ - 1) / BQ;
  blockwise_attention_kernel<T><<<BH * n_qtiles, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, N, n_qtiles, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int calo_blockwise_attention_forward(const void* q, const void* k, const void* v,
                                                void* out, void* lse, int BH, int N,
                                                int head_dim, int is_bf16, float scale,
                                                void* stream) {
  const long long blocks = static_cast<long long>(BH) * ((N + BQ - 1) / BQ);
  if (BH < 1 || N < 1 || head_dim != D || blocks > 0x7fffffffLL || !is_dtype_variant(is_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<VariantT>(q, k, v, out, static_cast<float*>(lse), BH, N, scale,
                          static_cast<cudaStream_t>(stream));
}
