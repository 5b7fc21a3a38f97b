// Fused PreNormResidual(LinearAttention) block, backward, for Hopper (sm_90a).
//
// Given x and g = dL/d out of the forward kernel (linear_attention_block.cu)
//
//   out = x + GN1_post(y),  y = W_o^T (ctx^T qs) + b_o,  qs = softmax_d(q) d^-1/2,
//   ctx = softmax_N(k) v^T,  q/k/v = W_{q,k,v}^T xn,  xn = GN1_pre(x)
//
// it returns dx and, per sample, the gradients of the pre-GN affine, W_q,
// W_k, W_v, W_o, b_o and the post-GN affine; the wrapper sums the per-sample
// weight gradients over the batch (deterministic, no atomics).  heads = 1,
// dim_head D = 32, x and g laid out (B, N, C) with C in {16, 32, 64, 96}.  Replaces
// the Pallas kernel
// calodiffusion_tpu/ops/pallas_linear_attention.py::_block_bwd_kernel.
//
// Bound.  The card's memory: the function must read x and g once and write
// dx once (3 * B * N * C elements); its products are (12 C D + 8 D^2) * 2
// FLOPs a position, below the tensor cores' rate per byte.
//
// Design: K1's layout.  A cluster of G CTAs (8 warps each) takes one
// sample; CTA r holds positions [r P, r P + P), P = N / G rounded up to
// 16.  x and g of its share come into shared memory once (cp.async), and
// y and dxn (f32, the fragments' own order) stay there: at ds2's
// (6480, 32) that takes G = 16, a cluster past the portable 8 that the H100
// places (cudaFuncAttributeNonPortableClusterSizeAllowed; the occupancy
// query is checked before the first launch).  k, v and q are recomputed
// from x on the tensor cores in each phase that needs them, never staged.
// Each warp takes 16 positions at a time; its operands go through its own
// rows of shared memory.  Every sum over the sample meets over distributed
// shared memory in rank order, so every CTA holds the same value; the warps'
// partials of a CTA add in warp order; each rank sums a 1/G share of the
// entries over the cluster (cluster_merge), and writes the per-sample
// gradients of its share.
//   phase 0  x, g -> shared memory; pre-GN mean, then centred variance
//   phase A  k, v, the online softmax of k, ctx partials; merged: ctx and
//            the softmax's final max and sum (attention_common.cuh, as K1)
//   phase B  q, softmax over d, o = ctx^T qs, y = W_o^T o + b_o -> y; mean
//            of y, then its centred variance
//   phase G  S1 = sum g2 g, S2 = sum g2 g yhat; d gamma_post, d beta_post
//   phase M  q, qs, o again; dy = inv_y (g2 g - S1/(NC) - yhat S2/(NC));
//            dW_o += o dy^T, db_o += dy, do = W_o dy, dqs = ctx do,
//            dctx += qs do^T, dq = qs0 (dqs - sum qs0 dqs), dxn = W_q dq,
//            dW_q += xn dq^T; merged: dctx (every CTA), dW_o, dW_q, db_o
//   phase R  k, ks, v again; dks = dctx v, r_d = sum_n ks dks; merged
//   phase K  k, ks, v, dks again; dk = ks (dks - r_d), dv = dctx^T ks,
//            dxn += W_v dv + W_k dk, dW_v, dW_k; T1, T2, d gamma_pre,
//            d beta_pre from the final dxn; merged
//   phase F  dx = inv (g1 dxn - T1/(NC) - xhat T2/(NC)) + g -> device memory
// The C entry's plan picks G, the smallest of 1, 2, 4, 8, 16 (f32: up to
// 8) that holds x, g, y and dxn on chip (16 at (6480, 32), 4 at (736, 64),
// 2 at (736, 32), 1 at N = 96 in bf16).  Where no G holds a sample (f32 at
// (6480, 32) and (736, 64); dataset 3's N = 40,500), the largest G and
// dxn, then y, then g, then x live in device memory instead: a scratch for
// dxn and y from the wrapper, x and g re-read from L2, the same code on
// other pointers.
//
// Numerics follow the Pallas kernel: statistics, softmaxes, exps and every
// accumulator in f32; values are rounded to the compute dtype T where the
// Pallas kernel casts (xn, v and the k softmax numerators before the
// context product, ctx, qs, the attention output, dy, do, dq, dv, dk and
// dctx before each product).  bf16 products on the tensor cores (mma.sync
// m16n8k16, f32 sums); the f32 variant computes the same fragments with
// FFMA (TF32 would break K2_TOL).
//
// Measured on one NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py): bf16
// 2.34 ms of device time at (128, 6480, 32) (G = 16, 227 KB a CTA), 6.14 ms
// for the 7 launches of a ds2 train step, against a 0.114 ms bound; the
// first port (one 128-thread block a sample on the CUDA cores, f32 scratch
// in device memory) took 12.8 ms a step by CUDA events.  Registers: each
// lane of phase M accumulates a_wo and a_wq (C floats each), a_ctx (32) and
// the b_o partials (C/4), 248 floats at C = 96, and phase K 240; there
// ptxas spills 1.3 KB a thread (bf16; 2.3 KB f32), correct but 0.178 ms of
// device time at (128, 28, 96) against 0.120 at C = 64 (chip_smoke.py,
// same card).
//
// C entries, for the one (dtype, C) variant of the build: calo_attention_
// block_backward_plan (G, P, what stays on chip) and
// calo_attention_block_backward; both return a CUDA error code.

#include <algorithm>

#include "attention_common.cuh"

namespace {

using namespace calo;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// bf16: up to 16 (non-portable; the H100 places clusters of 16), which holds
// ds2's largest sample on chip.  f32 holds no ds2 sample of N = 6480 or 736
// x 64 on chip at any G, and there 8 CTAs with part of the sample in device
// memory beat 16 (a cluster's merges cost more than the L2 traffic;
// scripts/torch_kernel_variants.py): up to 8.
constexpr int MAX_CLUSTER = CALO_BF16 ? 16 : 8;
constexpr int N_SCAL = 8;        // scalar slots: 4 cluster sums, S1, S2, T1, T2

// byte sizes of the shared-memory regions (multiples of 16)
constexpr size_t W_BYTES = C * LDW * sizeof(T) + D * LDO * sizeof(T) + 2 * D * LDD * sizeof(T);
constexpr size_t PAR_BYTES = (5 * C + 3 * D + WARPS + N_SCAL) * sizeof(float);
constexpr size_t XA_BYTES = TILE * LDA * sizeof(T);    // a (TILE, C) operand
constexpr size_t DA_BYTES = TILE * LDD * sizeof(T);    // a (TILE, D) operand
// a warp's operands: xn and a (TILE, C) buffer, two (TILE, D) buffers; in
// phase A, xn and K1's staging
constexpr size_t WS_BYTES = XA_BYTES + std::max(CTX_STAGE_BYTES, XA_BYTES + 2 * DA_BYTES);
// partials published for a merge: dctx, dW_o, dW_q, db_o (the largest)
constexpr size_t PUB_FLOATS = D * D + 2 * C * D + C;
constexpr size_t WS_ALL = std::max({WARPS * WS_BYTES, (WARPS + 1) * CTX_PART_FLOATS * 4,
                                    PUB_FLOATS * 4});
static_assert(W_BYTES % 16 == 0 && PAR_BYTES % 16 == 0 && WS_BYTES % 16 == 0 &&
              WS_ALL % 16 == 0, "alignment");

// where a launch keeps a sample
struct Plan {
  int G;       // CTAs a cluster = a sample
  int P;       // positions a CTA, a multiple of TILE
  int res;     // bits: RES_X, RES_G, RES_Y, RES_DXN on chip (else device memory)
  size_t smem; // dynamic shared memory a CTA
};
constexpr int RES_X = 1, RES_G = 2, RES_Y = 4, RES_DXN = 8;
// what stays on chip, from all to none: dxn leaves first, x last
constexpr int MODES[] = {15, 7, 3, 1, 0};

size_t smem_bytes(int P, int res) {
  const size_t pc = static_cast<size_t>(P) * C;
  return W_BYTES + PAR_BYTES + WS_ALL + ((res & RES_X) ? pc * sizeof(T) : 0) +
         ((res & RES_G) ? pc * sizeof(T) : 0) + ((res & RES_Y) ? pc * 4 : 0) +
         ((res & RES_DXN) ? pc * 4 : 0);
}

// cluster 0: the smallest G of 1, 2, .., MAX_CLUSTER that holds the sample
// on chip, else G = MAX_CLUSTER with as much on chip as fits; cluster > 0: that G, with as
// much on chip as fits.  smem_limit: the bytes a CTA may take.
bool make_plan(int N, int cluster, size_t smem_limit, Plan* p) {
  for (int G = cluster ? cluster : 1; G <= (cluster ? cluster : MAX_CLUSTER); G *= 2) {
    const int P = ((N + G - 1) / G + TILE - 1) / TILE * TILE;
    const bool last = G >= (cluster ? cluster : MAX_CLUSTER);
    for (int res : MODES) {
      const size_t s = smem_bytes(P, res);
      if (s <= smem_limit) {
        *p = Plan{G, P, res, s};
        return true;
      }
      if (!last) break;  // try a larger G before leaving the chip
    }
  }
  return false;
}

// q's fragments -> the softmax over d of each row (unscaled, f32), in place
__device__ __forceinline__ void softmax_rows(float (&q)[1][4][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // rows g and g + 8: 8 values here, 32 over the quad
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) mx = fmaxf(mx, fmaxf(q[0][nt][2 * h], q[0][nt][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        q[0][nt][2 * h + j] = expf(q[0][nt][2 * h + j] - mx);
        sum += q[0][nt][2 * h + j];
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) q[0][nt][2 * h + j] /= sum;
  }
}

// a per-channel partial of each lane (channels nt * 8 + 2t + j, summed over
// its rows) summed over the warp's 8 row groups: lanes 0..3 hold the totals
template <int NT>
__device__ __forceinline__ void sum_over_rows(float (&v)[NT][2]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) v[nt][j] += __shfl_xor_sync(0xffffffffu, v[nt][j], o);
}

// (MT*16 x NT*8) fragments added into dst (row-major, row stride ld)
template <int MT, int NT>
__device__ __forceinline__ void add_frags(float* dst, int ld, const float (&a)[MT][NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dst[(mt * 16 + g + 8 * (i >> 1)) * ld + nt * 8 + 2 * t + (i & 1)] += a[mt][nt][i];
}

// add() run by each warp in turn, warp 0 first: the warps' partials meet
// in a fixed order
template <int WARPS_, class F>
__device__ __forceinline__ void in_warp_order(F add) {
#pragma unroll 1
  for (int w = 0; w < WARPS_; ++w) {
    if ((threadIdx.x >> 5) == w) add();
    __syncthreads();
  }
}

// f(i, pos, c, value) for this lane's elements i of fragment v (n-tile nt
// of a (TILE, C) tile) that hold one of the cnt positions
template <class F>
__device__ __forceinline__ void for_frag(int tile, int nt, int cnt, const float4& v, F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pos = tile * TILE + g + 8 * (i >> 1);
    if (pos < cnt) f(i, pos, nt * 8 + 2 * t + (i & 1), e[i]);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
attention_block_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gout,
                           const float* __restrict__ gn_pre_scale,
                           const float* __restrict__ gn_pre_bias, const T* __restrict__ w_qkv,
                           const T* __restrict__ w_out, const float* __restrict__ b_out,
                           const float* __restrict__ gn_post_scale, float* __restrict__ y_scr,
                           float* __restrict__ dxn_scr, T* __restrict__ dx,
                           float* __restrict__ dg1, float* __restrict__ db1,
                           float* __restrict__ dwq, float* __restrict__ dwk,
                           float* __restrict__ dwv, float* __restrict__ dwo,
                           float* __restrict__ dbo, float* __restrict__ dg2,
                           float* __restrict__ db2, int N, int P, int res, float eps) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int G = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // shared memory
  char* sp = reinterpret_cast<char*>(smem);
  T* s_w = reinterpret_cast<T*>(sp);            // (C, LDW): q | k | v columns
  T* s_wo = s_w + C * LDW;                      // (D, LDO)
  T* s_ctx = s_wo + D * LDO;                    // (D, LDD)
  T* s_dctx = s_ctx + D * LDD;                  // (D, LDD)
  float* pre_sc = reinterpret_cast<float*>(sp + W_BYTES);  // folded pre-GN affine
  float* pre_sh = pre_sc + C;
  float* s_g1 = pre_sh + C;                     // gn_pre_scale
  float* s_g2 = s_g1 + C;                       // gn_post_scale
  float* s_bo = s_g2 + C;
  float* s_km = s_bo + C;                       // the k softmax's max, sum (D)
  float* s_ks = s_km + D;
  float* s_rd = s_ks + D;                       // r_d (D)
  float* s_red = s_rd + D;                      // block reductions
  float* s_scal = s_red + WARPS;                // cluster sums and merged scalars
  char* ws = sp + W_BYTES + PAR_BYTES;          // the warps' operands, or a merge's partials
  float* pub = reinterpret_cast<float*>(ws);
  T* s_xa = reinterpret_cast<T*>(ws + warp * WS_BYTES);  // (TILE, LDA): xn
  T* s_c = s_xa + TILE * LDA;                   // (TILE, LDA): dy; ks (stride LDD)
  T* s_d1 = s_c + TILE * LDA;                   // (TILE, LDD): qs, dq; dk
  T* s_d2 = s_d1 + TILE * LDD;                  // (TILE, LDD): o, do; v, dv
  char* rp = ws + WS_ALL;
  const size_t pc = static_cast<size_t>(P) * C;
  T* s_x = reinterpret_cast<T*>(rp);
  rp += (res & RES_X) ? pc * sizeof(T) : 0;
  T* s_g = reinterpret_cast<T*>(rp);
  rp += (res & RES_G) ? pc * sizeof(T) : 0;
  float* s_y = reinterpret_cast<float*>(rp);
  rp += (res & RES_Y) ? pc * 4 : 0;
  float* s_dxn = reinterpret_cast<float*>(rp);

  const int n0 = rank * P;
  const int cnt = max(0, min(P, N - n0));       // this CTA's positions
  const int tiles = (cnt + TILE - 1) / TILE;
  const size_t off = (static_cast<size_t>(b) * N + n0) * C;
  const size_t scr = (static_cast<size_t>(b) * G + rank) * pc;
  const T* xs = (res & RES_X) ? s_x : x + off;  // this CTA's x, g: (cnt, C)
  const T* gs = (res & RES_G) ? s_g : gout + off;
  float* ys = (res & RES_Y) ? s_y : y_scr + scr;        // y, dxn: fragment order
  float* dxns = (res & RES_DXN) ? s_dxn : dxn_scr + scr;
  const float denom = static_cast<float>(C) * static_cast<float>(N);

  // ---- phase 0: x and g on chip, weights, pre-GN statistics ------------------
  {
    const int chunks = cnt * C * static_cast<int>(sizeof(T)) / 16;
    if (res & RES_X)
      for (int i = tid; i < chunks; i += THREADS)
        cp_async16(reinterpret_cast<char*>(s_x) + 16 * i,
                   reinterpret_cast<const char*>(x + off) + 16 * i, true);
    if (res & RES_G)
      for (int i = tid; i < chunks; i += THREADS)
        cp_async16(reinterpret_cast<char*>(s_g) + 16 * i,
                   reinterpret_cast<const char*>(gout + off) + 16 * i, true);
    cp_async_commit();
  }
  for (int i = tid; i < C * 3 * D; i += THREADS) s_w[(i / (3 * D)) * LDW + i % (3 * D)] = w_qkv[i];
  for (int i = tid; i < D * C; i += THREADS) s_wo[(i / C) * LDO + i % C] = w_out[i];
  if (tid < C) {
    s_g1[tid] = gn_pre_scale[tid];
    s_g2[tid] = gn_post_scale[tid];
    s_bo[tid] = b_out[tid];
  }
  cp_async_wait<0>();
  __syncthreads();

  constexpr int PER = 16 / sizeof(T);
  const int n_vec = cnt * C / PER;
  float acc = 0.f;
  for (int i = tid; i < n_vec; i += THREADS) {
    float r[PER];
    load16(xs + i * PER, r);
#pragma unroll
    for (int j = 0; j < PER; ++j) acc += r[j];
  }
  const float mu = cluster_sum<THREADS, MAX_CLUSTER>(cluster, acc, s_red, s_scal, 0) / denom;
  acc = 0.f;
  for (int i = tid; i < n_vec; i += THREADS) {
    float r[PER];
    load16(xs + i * PER, r);
#pragma unroll
    for (int j = 0; j < PER; ++j) acc += (r[j] - mu) * (r[j] - mu);
  }
  const float inv =
      rsqrtf(cluster_sum<THREADS, MAX_CLUSTER>(cluster, acc, s_red, s_scal, 1) / denom + eps);
  if (tid < C) {
    const float sc = s_g1[tid] * inv;
    pre_sc[tid] = sc;
    pre_sh[tid] = gn_pre_bias[tid] - sc * mu;
  }
  __syncthreads();

  auto make_xn = [&](int tile) { stage_input<true>(s_xa, xs, cnt, tile, pre_sc, pre_sh); };
  // element (row, col) of a (TILE, C) fragment tile of y or dxn: lane's
  // float4 at frag(tile, nt) holds (g, c), (g, c+1), (g+8, c), (g+8, c+1)
  auto frag = [&](float* base, int tile, int nt) {
    return reinterpret_cast<float4*>(base + ((tile * NT_C + nt) * 32 + lane) * 4);
  };
  auto clear_pub = [&](int n) {
    __syncthreads();  // the warps' operands are dead: pub takes their place
    for (int i = tid; i < n; i += THREADS) pub[i] = 0.f;
    __syncthreads();
  };
  // a lane's per-channel partials, summed over the warp's rows, += dst[C]
  auto add_channels = [&](float* dst, const float (&v)[NT_C][2]) {
    if (lane < 4)
#pragma unroll
      for (int nt = 0; nt < NT_C; ++nt) {
        dst[nt * 8 + 2 * t] += v[nt][0];
        dst[nt * 8 + 2 * t + 1] += v[nt][1];
      }
  };

  // ---- phase A: ctx, the k softmax's max and sum ----------------------------
  {
    CtxPartial part;
    context_partial<WARPS>(part, make_xn, s_xa, s_w, ws + warp * WS_BYTES + XA_BYTES, cnt);
    context_merge<THREADS, MAX_CLUSTER>(cluster, part, pub, s_ctx, s_km, s_ks);
  }

  // q of a staged xn tile -> qs0 (unscaled softmax, f32 fragments) and qs
  // (scaled, rounded) in s_d1
  auto q_softmax = [&](float (&qs0)[1][4][4]) {
    zero(qs0);
    warp_gemm<1, 4, C / 16, false>(qs0, s_xa, LDA, s_w, LDW);
    softmax_rows(qs0);
    float qs[1][4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) qs[0][nt][i] = qs0[0][nt][i] * QSCALE;
    store_frags(s_d1, LDD, qs);
    __syncwarp();
  };
  // o = ctx^T qs of the tile, rounded, into s_d2
  auto attend = [&]() {
    float o[1][4][4];
    zero(o);
    warp_gemm<1, 4, 2, false>(o, s_d1, LDD, s_ctx, LDD);
    store_frags(s_d2, LDD, o);
    __syncwarp();
  };

  // ---- phase B: y and its statistics ----------------------------------------
  acc = 0.f;
  for (int tile = warp; tile < tiles; tile += WARPS) {
    make_xn(tile);
    float qs0[1][4][4];
    q_softmax(qs0);
    attend();
    float yacc[1][NT_C][4];
    zero(yacc);
    warp_gemm<1, NT_C, 2, false>(yacc, s_d2, LDD, s_wo, LDO);
    const bool ok0 = tile * TILE + g < cnt, ok1 = tile * TILE + g + 8 < cnt;
#pragma unroll
    for (int nt = 0; nt < NT_C; ++nt) {
      const float b0 = s_bo[nt * 8 + 2 * t], b1 = s_bo[nt * 8 + 2 * t + 1];
      const float4 y = make_float4(yacc[0][nt][0] + b0, yacc[0][nt][1] + b1,
                                   yacc[0][nt][2] + b0, yacc[0][nt][3] + b1);
      *frag(ys, tile, nt) = y;
      acc += (ok0 ? y.x + y.y : 0.f) + (ok1 ? y.z + y.w : 0.f);
    }
    __syncwarp();  // the next tile overwrites this warp's operands
  }
  const float mu_y = cluster_sum<THREADS, MAX_CLUSTER>(cluster, acc, s_red, s_scal, 2) / denom;
  acc = 0.f;
  for (int tile = warp; tile < tiles; tile += WARPS) {
    const bool ok0 = tile * TILE + g < cnt, ok1 = tile * TILE + g + 8 < cnt;
#pragma unroll
    for (int nt = 0; nt < NT_C; ++nt) {
      const float4 y = *frag(ys, tile, nt);
      if (ok0) acc += (y.x - mu_y) * (y.x - mu_y) + (y.y - mu_y) * (y.y - mu_y);
      if (ok1) acc += (y.z - mu_y) * (y.z - mu_y) + (y.w - mu_y) * (y.w - mu_y);
    }
  }
  const float inv_y =
      rsqrtf(cluster_sum<THREADS, MAX_CLUSTER>(cluster, acc, s_red, s_scal, 3) / denom + eps);


  // ---- phase G: post-GN backward sums, d gamma_post, d beta_post -------------
  {
    float s1 = 0.f, s2 = 0.f, cg2[NT_C][2] = {}, cb2[NT_C][2] = {};
    for (int tile = warp; tile < tiles; tile += WARPS)
#pragma unroll
      for (int nt = 0; nt < NT_C; ++nt)
        for_frag(tile, nt, cnt, *frag(ys, tile, nt), [&](int i, int pos, int c, float y) {
          const float gv = to_f<T>(gs[static_cast<size_t>(pos) * C + c]);
          const float yh = (y - mu_y) * inv_y;
          const float dyh = s_g2[c] * gv;
          s1 += dyh;
          s2 += dyh * yh;
          cg2[nt][i & 1] += gv * yh;
          cb2[nt][i & 1] += gv;
        });
    sum_over_rows(cg2);
    sum_over_rows(cb2);
    s1 = block_sum<THREADS>(s1, s_red);
    s2 = block_sum<THREADS>(s2, s_red);
    // pub: S1, S2 (every CTA), dg2, db2 (written)
    clear_pub(2 + 2 * C);
    if (tid == 0) {
      pub[0] = s1;
      pub[1] = s2;
    }
    in_warp_order<WARPS>([&] {
      add_channels(pub + 2, cg2);
      add_channels(pub + 2 + C, cb2);
    });
    cluster_merge<THREADS, MAX_CLUSTER>(cluster, pub, 2, 2 + 2 * C, [&](int i, float v) {
      if (i < 2) s_scal[4 + i] = v;
      else if (i < 2 + C) dg2[static_cast<size_t>(b) * C + i - 2] = v;
      else db2[static_cast<size_t>(b) * C + i - 2 - C] = v;
    });
  }
  const float s1n = s_scal[4] / denom, s2n = s_scal[5] / denom;

  // ---- phase M: dy -> do -> dqs -> dq -> dxn; dW_o, dctx, dW_q, db_o --------
  {
    float a_wo[2][NT_C][4], a_ctx[2][4][4], a_wq[C / 16][4][4], cbo[NT_C][2] = {};
    zero(a_wo);
    zero(a_ctx);
    zero(a_wq);
    for (int tile = warp; tile < tiles; tile += WARPS) {
      make_xn(tile);
      float qs0[1][4][4];
      q_softmax(qs0);
      // dy, rounded, into s_c; zero past cnt
#pragma unroll
      for (int nt = 0; nt < NT_C; ++nt) {
        const float4 y = *frag(ys, tile, nt);
        float dy[4] = {0.f, 0.f, 0.f, 0.f};
        for_frag(tile, nt, cnt, y, [&](int i, int pos, int c, float yv) {
          const float gv = to_f<T>(gs[static_cast<size_t>(pos) * C + c]);
          const float yh = (yv - mu_y) * inv_y;
          dy[i] = inv_y * (s_g2[c] * gv - s1n - yh * s2n);
          cbo[nt][i & 1] += dy[i];
        });
        store2(s_c + g * LDA + nt * 8 + 2 * t, dy[0], dy[1]);
        store2(s_c + (g + 8) * LDA + nt * 8 + 2 * t, dy[2], dy[3]);
      }
      attend();  // o -> s_d2 (its __syncwarp also publishes dy)
      warp_gemm<2, NT_C, 1, true>(a_wo, s_d2, LDD, s_c, LDA);      // dW_o += o^T dy
      float dq[1][4][4];
      zero(dq);
      warp_gemm<1, 4, C / 16, false, true>(dq, s_c, LDA, s_wo, LDO);  // do = dy W_o^T
      __syncwarp();                                                 // o is read
      store_frags(s_d2, LDD, dq);                                   // do, rounded
      __syncwarp();
      zero(dq);
      warp_gemm<1, 4, 2, false, true>(dq, s_d2, LDD, s_ctx, LDD);   // dqs = do ctx^T
      warp_gemm<2, 4, 1, true>(a_ctx, s_d1, LDD, s_d2, LDD);        // dctx += qs^T do
      // dq = qs0 (dqs d^-1/2 - sum_d qs0 dqs d^-1/2), rows over the quad
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float cs = 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            dq[0][nt][2 * h + j] *= QSCALE;
            cs += qs0[0][nt][2 * h + j] * dq[0][nt][2 * h + j];
          }
        cs += __shfl_xor_sync(0xffffffffu, cs, 1);
        cs += __shfl_xor_sync(0xffffffffu, cs, 2);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            dq[0][nt][2 * h + j] = qs0[0][nt][2 * h + j] * (dq[0][nt][2 * h + j] - cs);
      }
      __syncwarp();  // qs is read
      store_frags(s_d1, LDD, dq);  // dq, rounded
      __syncwarp();
      float dxn[1][NT_C][4];
      zero(dxn);
      warp_gemm<1, NT_C, 2, false, true>(dxn, s_d1, LDD, s_w, LDW);  // dxn = dq W_q^T
#pragma unroll
      for (int nt = 0; nt < NT_C; ++nt)
        *frag(dxns, tile, nt) = make_float4(dxn[0][nt][0], dxn[0][nt][1], dxn[0][nt][2],
                                            dxn[0][nt][3]);
      warp_gemm<C / 16, 4, 1, true>(a_wq, s_xa, LDA, s_d1, LDD);     // dW_q += xn^T dq
      __syncwarp();  // the next tile overwrites this warp's operands
    }
    sum_over_rows(cbo);
    // pub: dctx (every CTA), dW_o, dW_q, db_o (written)
    constexpr int O_WO = D * D, O_WQ = O_WO + D * C, O_BO = O_WQ + C * D, N_PUB = O_BO + C;
    clear_pub(N_PUB);
    in_warp_order<WARPS>([&] {
      add_frags(pub, D, a_ctx);
      add_frags(pub + O_WO, C, a_wo);
      add_frags(pub + O_WQ, D, a_wq);
      add_channels(pub + O_BO, cbo);
    });
    cluster_merge<THREADS, MAX_CLUSTER>(cluster, pub, O_WO, N_PUB, [&](int i, float v) {
      if (i < O_WO) s_dctx[(i / D) * LDD + i % D] = from_f<T>(v);
      else if (i < O_WQ) dwo[static_cast<size_t>(b) * D * C + i - O_WO] = v;
      else if (i < O_BO) dwq[static_cast<size_t>(b) * C * D + i - O_WQ] = v;
      else dbo[static_cast<size_t>(b) * C + i - O_BO] = v;
    });
  }

  // the k softmax (final max and sum) of a staged xn tile, f32 fragments,
  // zero past cnt; v, rounded, into s_d2; dks = v dctx^T
  auto k_softmax_dks = [&](int tile, float (&ks)[1][4][4], float (&dks)[1][4][4]) {
    float v[1][4][4];
    zero(ks);
    zero(v);
    warp_gemm<1, 4, C / 16, false>(ks, s_xa, LDA, s_w + D, LDW);
    warp_gemm<1, 4, C / 16, false>(v, s_xa, LDA, s_w + 2 * D, LDW);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = nt * 8 + 2 * t + (i & 1);
        const bool ok = tile * TILE + g + 8 * (i >> 1) < cnt;
        ks[0][nt][i] = ok ? expf(ks[0][nt][i] - s_km[d]) / s_ks[d] : 0.f;
      }
    store_frags(s_d2, LDD, v);
    __syncwarp();
    zero(dks);
    warp_gemm<1, 4, 2, false, true>(dks, s_d2, LDD, s_dctx, LDD);
  };

  // ---- phase R: r_d = sum_n ks dks ----------------------------------------------
  {
    float rd[4][2] = {};
    for (int tile = warp; tile < tiles; tile += WARPS) {
      make_xn(tile);
      float ks[1][4][4], dks[1][4][4];
      k_softmax_dks(tile, ks, dks);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) rd[nt][i & 1] += ks[0][nt][i] * dks[0][nt][i];
      __syncwarp();  // the next tile overwrites this warp's operands
    }
    sum_over_rows(rd);
    clear_pub(D);
    in_warp_order<WARPS>([&] {
      if (lane < 4)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          pub[nt * 8 + 2 * t] += rd[nt][0];
          pub[nt * 8 + 2 * t + 1] += rd[nt][1];
        }
    });
    cluster_merge<THREADS, MAX_CLUSTER>(cluster, pub, D, D, [&](int i, float v) { s_rd[i] = v; });
  }

  // ---- phase K: dk, dv -> dxn; dW_k, dW_v; pre-GN backward sums ---------------
  {
    float a_wv[C / 16][4][4], a_wk[C / 16][4][4], cg1[NT_C][2] = {}, cb1[NT_C][2] = {};
    float t1 = 0.f, t2 = 0.f;
    zero(a_wv);
    zero(a_wk);
    for (int tile = warp; tile < tiles; tile += WARPS) {
      make_xn(tile);
      float ks[1][4][4], dk[1][4][4];
      k_softmax_dks(tile, ks, dk);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dk[0][nt][i] = ks[0][nt][i] * (dk[0][nt][i] - s_rd[nt * 8 + 2 * t + (i & 1)]);
      store_frags(s_d1, LDD, dk);  // dk, rounded
      store_frags(s_c, LDD, ks);   // ks, rounded
      __syncwarp();                // (and v is read)
      float dv[1][4][4];
      zero(dv);
      warp_gemm<1, 4, 2, false>(dv, s_c, LDD, s_dctx, LDD);  // dv = ks dctx
      store_frags(s_d2, LDD, dv);  // dv, rounded
      __syncwarp();
      float dxn[1][NT_C][4];
#pragma unroll
      for (int nt = 0; nt < NT_C; ++nt) {
        const float4 v = *frag(dxns, tile, nt);
        dxn[0][nt][0] = v.x;
        dxn[0][nt][1] = v.y;
        dxn[0][nt][2] = v.z;
        dxn[0][nt][3] = v.w;
      }
      warp_gemm<1, NT_C, 2, false, true>(dxn, s_d2, LDD, s_w + 2 * D, LDW);  // += dv W_v^T
      warp_gemm<1, NT_C, 2, false, true>(dxn, s_d1, LDD, s_w + D, LDW);      // += dk W_k^T
#pragma unroll
      for (int nt = 0; nt < NT_C; ++nt) {
        const float4 v = make_float4(dxn[0][nt][0], dxn[0][nt][1], dxn[0][nt][2], dxn[0][nt][3]);
        *frag(dxns, tile, nt) = v;
        for_frag(tile, nt, cnt, v, [&](int i, int pos, int c, float dv_) {
          const float xh = (to_f<T>(xs[static_cast<size_t>(pos) * C + c]) - mu) * inv;
          const float dxh = s_g1[c] * dv_;
          t1 += dxh;
          t2 += dxh * xh;
          cg1[nt][i & 1] += dv_ * xh;
          cb1[nt][i & 1] += dv_;
        });
      }
      warp_gemm<C / 16, 4, 1, true>(a_wv, s_xa, LDA, s_d2, LDD);  // dW_v += xn^T dv
      warp_gemm<C / 16, 4, 1, true>(a_wk, s_xa, LDA, s_d1, LDD);  // dW_k += xn^T dk
      __syncwarp();  // the next tile overwrites this warp's operands
    }
    sum_over_rows(cg1);
    sum_over_rows(cb1);
    t1 = block_sum<THREADS>(t1, s_red);
    t2 = block_sum<THREADS>(t2, s_red);
    // pub: T1, T2 (every CTA), dW_v, dW_k, dg1, db1 (written)
    constexpr int O_WV = 2, O_WK = O_WV + C * D, O_G1 = O_WK + C * D, O_B1 = O_G1 + C,
                  N_PUB = O_B1 + C;
    clear_pub(N_PUB);
    if (tid == 0) {
      pub[0] = t1;
      pub[1] = t2;
    }
    in_warp_order<WARPS>([&] {
      add_frags(pub + O_WV, D, a_wv);
      add_frags(pub + O_WK, D, a_wk);
      add_channels(pub + O_G1, cg1);
      add_channels(pub + O_B1, cb1);
    });
    cluster_merge<THREADS, MAX_CLUSTER>(cluster, pub, 2, N_PUB, [&](int i, float v) {
      if (i < O_WV) s_scal[6 + i] = v;
      else if (i < O_WK) dwv[static_cast<size_t>(b) * C * D + i - O_WV] = v;
      else if (i < O_G1) dwk[static_cast<size_t>(b) * C * D + i - O_WK] = v;
      else if (i < O_B1) dg1[static_cast<size_t>(b) * C + i - O_G1] = v;
      else db1[static_cast<size_t>(b) * C + i - O_B1] = v;
    });
  }

  // ---- phase F: dx = inv (g1 dxn - T1/(NC) - xhat T2/(NC)) + g ----------------
  const float t1n = s_scal[6] / denom, t2n = s_scal[7] / denom;
  T* dxb = dx + off;
  for (int tile = warp; tile < tiles; tile += WARPS)
#pragma unroll
    for (int nt = 0; nt < NT_C; ++nt) {
      const float4 v = *frag(dxns, tile, nt);
      const int c = nt * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t pos = tile * TILE + g + 8 * h;
        if (static_cast<int>(pos) >= cnt) continue;
        float x0, x1, g0, g1;
        load2(xs + pos * C + c, x0, x1);
        load2(gs + pos * C + c, g0, g1);
        const float d0 = h ? v.z : v.x, d1 = h ? v.w : v.y;
        store2(dxb + pos * C + c,
               inv * (s_g1[c] * d0 - t1n - (x0 - mu) * inv * t2n) + g0,
               inv * (s_g1[c + 1] * d1 - t1n - (x1 - mu) * inv * t2n) + g1);
      }
    }
}

int plan_for(int N, int cluster, int smem_limit, Plan* p) {
  if (N < 1 || cluster < 0 || cluster > MAX_CLUSTER || (cluster & (cluster - 1)) || smem_limit < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t limit = smem_limit ? static_cast<size_t>(smem_limit) : card_smem_limit();
  return make_plan(N, cluster, limit, p) ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// where a launch at (N, cluster, smem_limit) keeps a sample: plan[0..6] =
// {G, P, x, g, y, dxn in shared memory (1) or device memory (0), shared
// bytes a CTA}.  cluster 0 lets the kernel choose G; smem_limit 0 is the
// card's opt-in limit.
extern "C" int calo_attention_block_backward_plan(int N, int C_, int is_bf16, int cluster,
                                                  int smem_limit, int* plan) {
  if (!is_variant(is_bf16, C_)) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const int err = plan_for(N, cluster, smem_limit, &p);
  if (err) return err;
  plan[0] = p.G;
  plan[1] = p.P;
  plan[2] = (p.res & RES_X) != 0;
  plan[3] = (p.res & RES_G) != 0;
  plan[4] = (p.res & RES_Y) != 0;
  plan[5] = (p.res & RES_DXN) != 0;
  plan[6] = static_cast<int>(p.smem);
  return 0;
}

// scratch: y, dxn, each (B, G * P * C) f32 where the plan keeps it in
// device memory, else unused; grads (per sample, f32): dg1, db1 (B, C);
// dwq, dwk, dwv (B, C, D); dwo (B, D, C); dbo, dg2, db2 (B, C)
extern "C" int calo_attention_block_backward(const void* x, const void* g,
                                             const void* gn_pre_scale, const void* gn_pre_bias,
                                             const void* w_qkv, const void* w_out,
                                             const void* b_out, const void* gn_post_scale,
                                             void* const* scratch, void* dx,
                                             void* const* grads, int B, int N, int C_,
                                             int is_bf16, float eps, int cluster, int smem_limit,
                                             void* stream) {
  if (B < 1 || !is_variant(is_bf16, C_)) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  int err = plan_for(N, cluster, smem_limit, &p);
  if (err) return err;
  if ((!(p.res & RES_Y) && scratch[0] == nullptr) || (!(p.res & RES_DXN) && scratch[1] == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(B) * p.G > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ClusterLaunch launch(B, p.G, THREADS, p.smem, stream);
  // a cluster the card cannot place is an error, never a smaller launch
  err = check_launch<MAX_CLUSTER>(attention_block_bwd_kernel, launch.cfg, p.G);
  if (err) return err;
  auto f = [&](int i) { return static_cast<float*>(grads[i]); };
  err = static_cast<int>(cudaLaunchKernelEx(
      &launch.cfg, attention_block_bwd_kernel, static_cast<const T*>(x),
      static_cast<const T*>(g), static_cast<const float*>(gn_pre_scale),
      static_cast<const float*>(gn_pre_bias), static_cast<const T*>(w_qkv),
      static_cast<const T*>(w_out), static_cast<const float*>(b_out),
      static_cast<const float*>(gn_post_scale), static_cast<float*>(scratch[0]),
      static_cast<float*>(scratch[1]), static_cast<T*>(dx), f(0), f(1), f(2), f(3), f(4), f(5),
      f(6), f(7), f(8), N, p.P, p.res, eps));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
