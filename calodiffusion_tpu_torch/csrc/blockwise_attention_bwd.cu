// Softmax attention's backward over the flattened voxel grid, for Hopper
// (sm_90a): FlashAttention-2's backward, the probabilities recomputed from
// q, k and the forward's per-row log-sum-exp (blockwise_attention.cu).
//
//   S = q k^T, c = D^-1/2, P = exp(S c - lse)       (B*H, N, N), never stored
//   Drow = rowsum(dO o out)
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - Drow),  dK = c dS^T Q,  dQ = c dS K
//
// over (B*H, N, D), D = 32.  The JAX package has no Pallas backward:
// calodiffusion_tpu/ops/pallas_attention.py::_attention_kernel (:35) is
// forward only, and jax.grad differentiates _dense_attention (:70-77), the
// XLA formulation its entry takes on the CPU and below N = 2048.  This
// kernel computes that gradient.
//
// Layout: two launches, no atomics; every gradient element is written once
// by one thread after sums in a fixed order, so the result is the same bit
// for bit from call to call.
//   1. dq pass, one block a (b*h, query tile): Drow from dO and out, the
//      rows' lse in the kernel's exponent units and Drow written to a scratch
//      (2, B*H, Npad) (Npad = N rounded up to NPAD; rows past N as lse = +inf,
//      Drow = 0, so they weigh nothing below), then dQ over all key tiles.
//   2. dk/dv pass, one block a (b*h, key tile): dK and dV over all query
//      tiles, the rows' lse and Drow read from the scratch.
// Each pass recomputes S and P: two exponentials a score against the one of
// FlashAttention-2's single pass (whose dQ sums across key blocks with
// atomics), and 14 D FLOPs of products a score against the 10 D the
// gradient needs (S, dP, dV, dK, dQ).
//
// Bound.  At D = 32, 10 D = 320 FLOPs and one exponential a score: on the
// tensor cores (989 TFLOP/s bf16) the products bound the work, ahead of the
// special-function units' exponentials; in f32 the CUDA cores (67 TFLOP/s).
// Simple and right first: mma.sync tiles, not wgmma/TMA.
//
// bf16 design: K4's forward's tiles.  4 warps a block, 16 rows a warp, the
// streamed tiles 64 rows of D kept bf16 in shared memory (80-byte rows,
// ldmatrix free of bank conflicts), double-buffered with cp.async.  All five
// products are m16n8k16 mma.sync (bf16 in, f32 sums): S (and S^T) and dP
// (dP^T) from ldmatrix operands; dV, dK and dQ take P^T, dS^T and dS from
// the f32 accumulators rounded once to bf16 as their A operand, and Q, dO
// and K by ldmatrix.trans.  P = 2^(S c log2(e) - lse log2(e)), one FFMA and
// one ex2 a score.  No hi/lo split of P or dS: simulated at N = 512 and
// 2048, q x 1 and x 8 (scripts/torch_attention_backward_rounding.py), the
// gradients lie at most 7.4e-3 from the plain version with one rounding
// each, within K4B_TOL = 2e-2 (the plain gradient is itself 2-3e-3 from
// float64); splitting both leaves the largest at 7.4e-3, since Drow taken
// from the bf16 output then dominates (2.0e-3 only with an exact Drow too).
//
// f32 design: the CUDA cores, as K4's f32 forward.  dq pass: a thread a
// query row (its q, dO and dQ in registers), K and V tiles of 64 keys in
// shared memory; dk/dv pass: a thread a key (k, v, dK, dV in registers),
// Q and dO tiles of 32 rows with their lse and Drow in shared memory.
//
// Keys and queries past N are masked by bounds (zero-filled rows, P = 0 at
// keys past N and at rows past N): no padded copies of the tensors.
//
// C entry: calo_blockwise_attention_backward, for the one dtype variant of
// the build; returns cudaGetLastError().

#include "common.cuh"

namespace {

using namespace calo;

constexpr int D = 32;      // head dim
constexpr int NPAD = 128;  // the scratch's rows: N rounded up to a multiple of this
constexpr float LOG2E = 1.4426950408889634f;

#if CALO_BF16

using bf16 = __nv_bfloat16;
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BR = 16 * WARPS;  // rows a block owns (queries, or keys), 16 a warp
constexpr int BT = 64;          // rows of a streamed tile
constexpr int NT = BT / 8;      // n-tiles of 8 in a streamed tile
constexpr int LD = D + 8;       // padded row of a tile, 80 bytes
constexpr int QTILE = BR;       // query rows a dq block takes
constexpr int KTILE = BR;       // keys a dk/dv block takes
constexpr size_t DQ_SMEM = (2 * BR + 4 * BT) * LD * sizeof(bf16);  // q, dO; k[2], v[2]
constexpr size_t DKV_SMEM = (2 * BR + 4 * BT) * LD * sizeof(bf16) +
                            4 * BT * sizeof(float);  // k, v; q[2], dO[2]; lse[2], Drow[2]

// ROWS rows of D from src into a padded tile; rows past `valid` are zeros
template <int ROWS>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, int valid) {
  for (int i = threadIdx.x; i < ROWS * (D / 8); i += THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * LD + c, src + (ok ? r : 0) * D + c, ok);
  }
}

// BT consecutive f32 of a scratch row (16-byte aligned: Npad is a multiple of 128)
__device__ __forceinline__ void stage_stats(float* dst, const float* src) {
  for (int i = threadIdx.x; i < BT / 4; i += THREADS) cp_async16(dst + 4 * i, src + 4 * i, true);
}

// A operand (16 rows x 16 of a k-step kk) from C fragments of 8-wide n-tiles, rounded to bf16
__device__ __forceinline__ void a_from_c(unsigned (&a)[4], const float (&c)[NT][4], int kk) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* p = &c[2 * kk + (i >> 1)][2 * (i & 1)];
    a[i] = pack_bf16(p[0], p[1]);
  }
}

// A fragments (16 rows x D) of a warp's rows of a padded tile
__device__ __forceinline__ void load_a(unsigned (&a)[2][4], const bf16* tile, int warp, int lane) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    ldmatrix_x4(a[kk], tile + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + kk * 16 +
                           (lane >> 4) * 8);
}

// acc[nt] += A (16 x D) B^T, B the rows nt*8.. of a padded tile (n-tiles of 8)
__device__ __forceinline__ void product_bt(float (&acc)[NT][4], const unsigned (&a)[2][4],
                                           const bf16* tile, int lane) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
    unsigned b[4];
    ldmatrix_x4(b, tile + (nt * 8 + (lane & 7)) * LD + (lane >> 3) * 8);
    mma_bf16_16816(acc[nt], a[0], b[0], b[1]);
    mma_bf16_16816(acc[nt], a[1], b[2], b[3]);
  }
}

// out (16 x D, d tiles of 8) += A B over the BT rows of a padded tile B (BT x D)
__device__ __forceinline__ void product_ab(float (&out)[4][4], const float (&a_c)[NT][4],
                                           const bf16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    unsigned a[4];
    a_from_c(a, a_c, kk);
#pragma unroll
    for (int dp = 0; dp < 2; ++dp) {
      unsigned b[4];
      ldmatrix_x4_trans(b, tile + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                               (dp * 2 + (lane >> 4)) * 8);
      mma_bf16_16816(out[2 * dp], a, b[0], b[1]);
      mma_bf16_16816(out[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// rows g (r = 0) and g + 8 (r = 1) of a warp's 16 from its C fragments, times `mul`
__device__ __forceinline__ void store_rows(bf16* dst, const float (&o)[4][4], int row0, int N,
                                           float mul, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= N) continue;
    unsigned* p = reinterpret_cast<unsigned*>(dst + static_cast<size_t>(row) * D);
#pragma unroll
    for (int dt = 0; dt < 4; ++dt)
      p[dt * 4 + t] = pack_bf16(o[dt][2 * r] * mul, o[dt][2 * r + 1] * mul);
  }
}

__global__ void __launch_bounds__(THREADS)
attention_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ out,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    bf16* __restrict__ dq, float* __restrict__ st_lse,
                    float* __restrict__ st_drow, int N, int npad, int n_qtiles, float scale) {
  extern __shared__ __align__(16) float smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_do = s_q + BR * LD;
  bf16* s_k = s_do + BR * LD;     // 2 buffers
  bf16* s_v = s_k + 2 * BT * LD;  // 2 buffers

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * BR;
  const size_t base = static_cast<size_t>(bh) * N * D;
  const int n_tiles = (N + BT - 1) / BT;
  const float c = scale * LOG2E;

  stage_tile<BR>(s_q, q + base + static_cast<size_t>(q0) * D, N - q0);
  stage_tile<BR>(s_do, dout + base + static_cast<size_t>(q0) * D, N - q0);
  stage_tile<BT>(s_k, k + base, N);
  stage_tile<BT>(s_v, v + base, N);
  cp_async_commit();

  // rows g and g + 8: lse in log2 units, Drow = rowsum(dO o out) in f32
  float lse2[2], drow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    float d = 0.f;
    if (row < N) {
      float a[8], b[8];
      load8(out + base + static_cast<size_t>(row) * D + 8 * t, a);
      load8(dout + base + static_cast<size_t>(row) * D + 8 * t, b);
#pragma unroll
      for (int i = 0; i < 8; ++i) d += a[i] * b[i];
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    drow[r] = d;
    lse2[r] = row < N ? lse[static_cast<size_t>(bh) * N + row] * LOG2E : INFINITY;
    if (t == 0) {
      st_lse[static_cast<size_t>(bh) * npad + row] = lse2[r];
      st_drow[static_cast<size_t>(bh) * npad + row] = d;
    }
  }

  unsigned qa[2][4], da[2][4];
  float acc[4][4];  // dQ / c, d tiles of 8
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      const size_t off = base + static_cast<size_t>(j + 1) * BT * D;
      const int valid = N - (j + 1) * BT;
      stage_tile<BT>(s_k + (buf ^ 1) * BT * LD, k + off, valid);
      stage_tile<BT>(s_v + (buf ^ 1) * BT * LD, v + off, valid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and q, dO) have landed
    __syncthreads();
    if (j == 0) {
      load_a(qa, s_q, warp, lane);
      load_a(da, s_do, warp, lane);
    }
    const bf16* kt = s_k + buf * BT * LD;
    const bf16* vt = s_v + buf * BT * LD;

    float s[NT][4], dp[NT][4];
    product_bt(s, qa, kt, lane);   // S = Q K^T
    product_bt(dp, da, vt, lane);  // dP = dO V^T
    const int nk = N - j * BT;     // keys of this tile
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const float p = nt * 8 + 2 * t + (i & 1) < nk
                            ? exp2_approx(fmaf(s[nt][i], c, -lse2[r])) : 0.f;
        s[nt][i] = p * (dp[nt][i] - drow[r]);  // dS
      }
    product_ab(acc, s, kt, lane);  // dQ / c += dS K
    __syncthreads();               // this buffer is refilled at iteration j + 1
  }
  store_rows(dq + base, acc, q0 + warp * 16, N, scale, g, t);
}

__global__ void __launch_bounds__(THREADS)
attention_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ st_lse, const float* __restrict__ st_drow,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int N, int npad,
                      int n_ktiles, float scale) {
  extern __shared__ __align__(16) float smem[];
  bf16* s_k = reinterpret_cast<bf16*>(smem);
  bf16* s_v = s_k + BR * LD;
  bf16* s_q = s_v + BR * LD;       // 2 buffers
  bf16* s_do = s_q + 2 * BT * LD;  // 2 buffers
  float* s_l = reinterpret_cast<float*>(s_do + 2 * BT * LD);  // 2 buffers of BT
  float* s_dr = s_l + 2 * BT;                                 // 2 buffers of BT

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / n_ktiles;
  const int k0 = (blockIdx.x % n_ktiles) * BR;
  const size_t base = static_cast<size_t>(bh) * N * D;
  const float* lb = st_lse + static_cast<size_t>(bh) * npad;
  const float* db = st_drow + static_cast<size_t>(bh) * npad;
  const int n_tiles = (N + BT - 1) / BT;
  const float c = scale * LOG2E;

  stage_tile<BR>(s_k, k + base + static_cast<size_t>(k0) * D, N - k0);
  stage_tile<BR>(s_v, v + base + static_cast<size_t>(k0) * D, N - k0);
  stage_tile<BT>(s_q, q + base, N);
  stage_tile<BT>(s_do, dout + base, N);
  stage_stats(s_l, lb);
  stage_stats(s_dr, db);
  cp_async_commit();

  unsigned ka[2][4], va[2][4];
  float ddk[4][4], ddv[4][4];  // dK / c and dV, d tiles of 8
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ddk[i][j] = ddv[i][j] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      const size_t off = base + static_cast<size_t>(j + 1) * BT * D;
      const int valid = N - (j + 1) * BT;
      stage_tile<BT>(s_q + (buf ^ 1) * BT * LD, q + off, valid);
      stage_tile<BT>(s_do + (buf ^ 1) * BT * LD, dout + off, valid);
      stage_stats(s_l + (buf ^ 1) * BT, lb + (j + 1) * BT);
      stage_stats(s_dr + (buf ^ 1) * BT, db + (j + 1) * BT);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and k, v) have landed
    __syncthreads();
    if (j == 0) {
      load_a(ka, s_k, warp, lane);
      load_a(va, s_v, warp, lane);
    }
    const bf16* qt = s_q + buf * BT * LD;
    const bf16* dt = s_do + buf * BT * LD;
    const float* lt = s_l + buf * BT;
    const float* drt = s_dr + buf * BT;

    float p[NT][4], ds[NT][4];
    product_bt(p, ka, qt, lane);   // S^T = K Q^T
    product_bt(ds, va, dt, lane);  // dP^T = V dO^T
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = nt * 8 + 2 * t + (i & 1);  // query of the tile; lse = +inf past N
        p[nt][i] = exp2_approx(fmaf(p[nt][i], c, -lt[col]));
        ds[nt][i] = p[nt][i] * (ds[nt][i] - drt[col]);  // dS^T
      }
    product_ab(ddv, p, dt, lane);   // dV += P^T dO
    product_ab(ddk, ds, qt, lane);  // dK / c += dS^T Q
    __syncthreads();                // this buffer is refilled at iteration j + 1
  }
  store_rows(dk + base, ddk, k0 + warp * 16, N, scale, g, t);
  store_rows(dv + base, ddv, k0 + warp * 16, N, 1.f, g, t);
}

#else  // f32: products on the CUDA cores

constexpr int THREADS = 128;
constexpr int QTILE = THREADS;  // query rows a dq block takes, one a thread
constexpr int KTILE = THREADS;  // keys a dk/dv block takes, one a thread
constexpr int BK = 64;          // keys of a dq block's shared-memory tile
constexpr int BQ = 32;          // query rows of a dk/dv block's shared-memory tile
constexpr size_t DQ_SMEM = 2 * BK * D * sizeof(float);
constexpr size_t DKV_SMEM = (2 * BQ * D + 2 * BQ) * sizeof(float);

__device__ __forceinline__ float dot(const float (&a)[D], const float* b) {
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    const float4 x = b4[i];
    s += a[4 * i] * x.x + a[4 * i + 1] * x.y + a[4 * i + 2] * x.z + a[4 * i + 3] * x.w;
  }
  return s;
}

__device__ __forceinline__ void axpy(float (&y)[D], float a, const float* x) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    const float4 b = x4[i];
    y[4 * i] += a * b.x; y[4 * i + 1] += a * b.y;
    y[4 * i + 2] += a * b.z; y[4 * i + 3] += a * b.w;
  }
}

// rows [r0, r0 + n) of (N, D) into shared memory
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n * D / 4; i += THREADS) load16(src + 4 * i, dst + 4 * i);
}

__global__ void __launch_bounds__(THREADS)
attention_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ out,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ dq, float* __restrict__ st_lse,
                    float* __restrict__ st_drow, int N, int npad, int n_qtiles, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* s_k = smem;           // (BK, D)
  float* s_v = smem + BK * D;  // (BK, D)

  const int bh = blockIdx.x / n_qtiles;
  const int row = (blockIdx.x % n_qtiles) * QTILE + threadIdx.x;
  const bool has_row = row < N;
  const size_t base = static_cast<size_t>(bh) * N * D;

  float qr[D], dr[D], acc[D];
  float l = INFINITY, drow = 0.f;
  if (has_row) {
    float o[D];
    load_row<float, D>(q + base + static_cast<size_t>(row) * D, qr);
    load_row<float, D>(dout + base + static_cast<size_t>(row) * D, dr);
    load_row<float, D>(out + base + static_cast<size_t>(row) * D, o);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[d] *= scale;
      drow += dr[d] * o[d];
    }
    l = lse[static_cast<size_t>(bh) * N + row];
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = dr[d] = 0.f;
  }
  st_lse[static_cast<size_t>(bh) * npad + row] = l;
  st_drow[static_cast<size_t>(bh) * npad + row] = drow;
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  for (int k0 = 0; k0 < N; k0 += BK) {
    const int nk = min(BK, N - k0);
    __syncthreads();  // the previous tile is consumed
    stage_rows(s_k, k + base + static_cast<size_t>(k0) * D, nk);
    stage_rows(s_v, v + base + static_cast<size_t>(k0) * D, nk);
    __syncthreads();
    for (int jj = 0; jj < nk; ++jj) {
      const float p = expf(dot(qr, s_k + jj * D) - l);
      const float ds = p * (dot(dr, s_v + jj * D) - drow);
      axpy(acc, ds, s_k + jj * D);
    }
  }
  if (has_row) {
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= scale;
    store_row<float, D>(dq + base + static_cast<size_t>(row) * D, acc);
  }
}

__global__ void __launch_bounds__(THREADS)
attention_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ st_lse, const float* __restrict__ st_drow,
                      float* __restrict__ dk, float* __restrict__ dv, int N, int npad,
                      int n_ktiles, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;             // (BQ, D)
  float* s_do = s_q + BQ * D;    // (BQ, D)
  float* s_l = s_do + BQ * D;    // (BQ)
  float* s_dr = s_l + BQ;        // (BQ)

  const int bh = blockIdx.x / n_ktiles;
  const int key = (blockIdx.x % n_ktiles) * KTILE + threadIdx.x;
  const bool has_key = key < N;
  const size_t base = static_cast<size_t>(bh) * N * D;

  float kr[D], vr[D], ak[D], av[D];  // k c, v, dK / c, dV
  if (has_key) {
    load_row<float, D>(k + base + static_cast<size_t>(key) * D, kr);
    load_row<float, D>(v + base + static_cast<size_t>(key) * D, vr);
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) kr[d] = vr[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kr[d] *= scale;
    ak[d] = av[d] = 0.f;
  }

  for (int i0 = 0; i0 < N; i0 += BQ) {
    const int nq = min(BQ, N - i0);
    __syncthreads();  // the previous tile is consumed
    stage_rows(s_q, q + base + static_cast<size_t>(i0) * D, nq);
    stage_rows(s_do, dout + base + static_cast<size_t>(i0) * D, nq);
    if (threadIdx.x < nq) {
      s_l[threadIdx.x] = st_lse[static_cast<size_t>(bh) * npad + i0 + threadIdx.x];
      s_dr[threadIdx.x] = st_drow[static_cast<size_t>(bh) * npad + i0 + threadIdx.x];
    }
    __syncthreads();
    for (int ii = 0; ii < nq; ++ii) {
      const float p = expf(dot(kr, s_q + ii * D) - s_l[ii]);
      axpy(av, p, s_do + ii * D);
      const float ds = p * (dot(vr, s_do + ii * D) - s_dr[ii]);
      axpy(ak, ds, s_q + ii * D);
    }
  }
  if (has_key) {
#pragma unroll
    for (int d = 0; d < D; ++d) ak[d] *= scale;
    store_row<float, D>(dk + base + static_cast<size_t>(key) * D, ak);
    store_row<float, D>(dv + base + static_cast<size_t>(key) * D, av);
  }
}

#endif

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const void* lse, void* dq, void* dk, void* dv, float* stats, int BH, int N, int npad,
           float scale, cudaStream_t stream) {
  const int n_qtiles = (N + QTILE - 1) / QTILE, n_ktiles = (N + KTILE - 1) / KTILE;
  float* st_lse = stats;
  float* st_drow = stats + static_cast<size_t>(BH) * npad;
  attention_dq_kernel<<<BH * n_qtiles, THREADS, DQ_SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(out), static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<T*>(dq), st_lse, st_drow, N, npad, n_qtiles, scale);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  attention_dkdv_kernel<<<BH * n_ktiles, THREADS, DKV_SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), st_lse, st_drow, static_cast<T*>(dk), static_cast<T*>(dv), N,
      npad, n_ktiles, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// stats: f32 scratch (2, BH, npad), npad >= N a multiple of 128
extern "C" int calo_blockwise_attention_backward(const void* q, const void* k, const void* v,
                                                 const void* out, const void* dout,
                                                 const void* lse, void* dq, void* dk, void* dv,
                                                 void* stats, int BH, int N, int npad,
                                                 int head_dim, int is_bf16, float scale,
                                                 void* stream) {
  const long long blocks = static_cast<long long>(BH) * ((N + QTILE - 1) / QTILE);
  if (BH < 1 || N < 1 || npad < N || npad % NPAD || head_dim != D || blocks > 0x7fffffffLL ||
      !is_dtype_variant(is_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<VariantT>(q, k, v, out, dout, lse, dq, dk, dv, static_cast<float*>(stats), BH,
                          N, npad, scale, static_cast<cudaStream_t>(stream));
}
