// Fused PreNormResidual(LinearAttention) block, forward, for Hopper (sm_90a).
//
//   out = x + GN1_post(W_o^T (ctx^T softmax_d(q) d^-1/2) + b_o),
//   xn = GN1_pre(x), q/k/v = W_{q,k,v}^T xn, ctx = softmax_N(k) v^T
//
// per sample, heads = 1, dim_head D = 32, x laid out (B, N, C) with
// C in {32, 64}.  Replaces the Pallas kernel
// calodiffusion_tpu/ops/pallas_linear_attention.py::_block_kernel.
//
// Bound.  The card's memory: the function must read x once and write out
// once (2 * B * N * C elements); its matrix products are ~6 * 1024 * N
// FLOPs a sample, far below the tensor cores' rate per byte.  The TPU
// kernel keeps a sample's (C, N) slab and an f32 copy of the attention
// output in VMEM, so that x is read from HBM once.  One Hopper SM has 227 KB
// of shared memory, less than a ds2 sample (6480 x 32 bf16 = 415 KB with
// its f32 y), but a thread-block cluster of up to 8 CTAs holds one.
//
// Design.  A cluster of G CTAs (16 warps each at bf16 C = 32, else 8) takes
// one sample; CTA r holds positions [r P, r P + P), P = N / G rounded up to
// 16: x in the compute dtype and y in f32, both in its own shared memory.
// Sums over the sample meet over distributed shared memory (map_shared_rank,
// cluster.sync), in rank order, so every CTA of the cluster holds the same:
//   phase 0  x -> shared memory (cp.async); the pre-GN mean, then the
//            centred variance (two passes over shared memory), each summed
//            over the cluster
//   phase A  per 16-position tile and warp: xn tile, k and v projections
//            (tensor cores), the online softmax of k over positions (lane d
//            owns column d: tile max, rescale, exponentials, sum), ctx
//            partial += k'^T v (tensor cores); the warps' partials merge in
//            the CTA, then the CTAs' over the cluster, each rescaled by
//            exp(m_part - m_all): every CTA ends with the same ctx
//   phase B  per tile: q projection, softmax over d, ctx^T q, W_o^T, bias
//            (three products on the tensor cores); y stays in shared
//            memory in the fragments' own order; its mean, then centred
//            variance, summed over the cluster
//   phase C  out = x + GN1_post(y), from shared memory to device memory
// One read of x from device memory and one write of out; no scratch.
// The wrapper picks G from N, the smallest of 1, 2, 4, 8 whose share fits a
// CTA (8 for ds2's N = 6480, 1 or 2 for 736, 1 for 96).  Where no G holds a
// sample (N past ~7,000 at C = 32, such as dataset 3's 40,500 positions),
// G = 8 and y, then x too, live in device memory instead: a scratch for y
// from the wrapper, x re-read from L2, the same code on other pointers.
// The f32 variant holds twice the bytes of x: at (6480, 32) it keeps x in
// shared memory and y in the device scratch.
//
// Products.  bf16: mma.sync m16n8k16 (bf16 inputs, exact products, f32
// sums), operands staged in shared memory and read by ldmatrix.  f32: the
// same fragments computed with FFMA on the CUDA cores (TF32 would not keep
// K1_TOL).  Both round to the compute dtype T where the Pallas kernel
// casts: the pre-GN output, the k softmax numerators and v, ctx, the scaled
// q softmax, the attention output before W_o, the post-GN output before the
// residual add.  Statistics, softmaxes and sums in f32.
//
// Measured on one NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py,
// scripts/torch_kernel_variants.py): bf16 0.40 ms of device time at
// (128, 6480, 32), 0.95 ms for the 7 launches of a ds2 denoise, against a
// 0.076 ms bound; at (6480, 32) one 190 KB CTA fits an SM, and about half of
// a CTA's time goes to cluster barriers, merges and statistics.
//
// C entries, for the one (dtype, C) variant of the build
// (attention_common.cuh): calo_attention_block_plan (the cluster size,
// positions a CTA and where x and y live) and calo_attention_block_forward;
// both return a CUDA error code.

#include <cooperative_groups.h>

#include <algorithm>

#include "attention_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace calo;

using T = VariantT;
constexpr int C = CALO_C;
// 16 warps at bf16 C = 32 (ds2's N = 6480: one CTA an SM, whose warps hide
// each other's latency); 8 otherwise, where 16 would spill (bf16 C = 64) or
// not fit a sample's share (f32)
constexpr int THREADS = CALO_BF16 && C == 32 ? 512 : 256;
constexpr int WARPS = THREADS / 32;
static_assert(D * D % THREADS == 0 && THREADS <= D * D, "ctx entries split evenly over threads");
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
constexpr int NT_C = C / 8;     // n-tiles of 8 channels
constexpr int TILE = 16;        // positions a warp takes at a time: one m-tile
// shared-memory rows, in elements; bf16 rows padded by 16 bytes so that the
// 8 rows an ldmatrix reads fall in distinct banks
constexpr int PAD = CALO_BF16 ? 8 : 0;
constexpr int LDW = 3 * D + PAD;  // w_qkv (C, 96): q | k | v columns
constexpr int LDO = C + PAD;      // w_out (D, C)
constexpr int LDD = D + PAD;      // ctx (D, D), k' and v tiles (16, D)
constexpr int LDA = C + PAD;      // a warp's A operand: xn (TILE, C), q softmax and o (TILE, D)
constexpr int LDK = D + 8;        // a warp's f32 k tile (TILE, D): conflict-free pair stores

// byte sizes of the shared-memory regions (multiples of 16)
constexpr size_t W_BYTES = C * LDW * sizeof(T) + D * LDO * sizeof(T) + D * LDD * sizeof(T);
constexpr size_t PAR_BYTES = (5 * C + WARPS + MAX_CLUSTER) * sizeof(float);
constexpr size_t XA_BYTES = TILE * LDA * sizeof(T);  // a warp's A operand
// phase A, a warp: f32 k tile, k' tile, v tile, the per-d rescale
constexpr size_t STAGE_BYTES = TILE * LDK * 4 + 2 * TILE * LDD * sizeof(T) + D * 4;
constexpr size_t PART_FLOATS = D * D + 2 * D;  // ctx, m, s of one partial
static_assert(W_BYTES % 16 == 0 && PAR_BYTES % 16 == 0 && STAGE_BYTES % 16 == 0, "alignment");

// where a launch keeps a sample
struct Plan {
  int G;        // CTAs a cluster = a sample
  int P;        // positions a CTA, a multiple of TILE
  bool x_res;   // x in shared memory (else re-read from device memory)
  bool y_res;   // y in shared memory (else the wrapper's device scratch)
  size_t smem;  // dynamic shared memory a CTA
};

size_t smem_bytes(int P, bool x_res, bool y_res) {
  const size_t y = y_res ? static_cast<size_t>(P) * C * 4 : 0;
  const size_t scratch = std::max({y, WARPS * STAGE_BYTES, (WARPS + 1) * PART_FLOATS * 4});
  return W_BYTES + PAR_BYTES + WARPS * XA_BYTES +
         (x_res ? static_cast<size_t>(P) * C * sizeof(T) : 0) + scratch;
}

// cluster 0: the smallest G of 1, 2, 4, 8 that holds x and y on chip, else
// G = 8 with y, then also x, in device memory; cluster > 0: that G, with as
// much on chip as fits.  smem_limit: the bytes a CTA may take.
bool make_plan(int N, int cluster, size_t smem_limit, Plan* p) {
  const bool modes[3][2] = {{true, true}, {true, false}, {false, false}};
  for (int G = cluster ? cluster : 1; G <= (cluster ? cluster : MAX_CLUSTER); G *= 2) {
    const int P = ((N + G - 1) / G + TILE - 1) / TILE * TILE;
    for (const auto& m : modes) {
      const bool last = G >= (cluster ? cluster : MAX_CLUSTER);
      if (!last && !(m[0] && m[1])) break;  // try a larger G before leaving the chip
      const size_t s = smem_bytes(P, m[0], m[1]);
      if (s <= smem_limit) {
        *p = Plan{G, P, m[0], m[1], s};
        return true;
      }
    }
  }
  return false;
}

// ---- warp-level products -----------------------------------------------------
// acc[MT][NT] (C fragments) += A (MT*16 x KT*16) B (KT*16 x NT*8), A row-major
// with row stride lda (A_TRANS: stored as its transpose, (K, M) with stride
// lda), B row-major (K, N) with stride ldb, all in shared memory.

#if CALO_BF16
template <int MT, int NT, int KT, bool A_TRANS>
__device__ __forceinline__ void warp_gemm(float (&acc)[MT][NT][4], const T* A, int lda,
                                          const T* B, int ldb) {
  static_assert(NT % 2 == 0, "B fragments are read two n-tiles at a time");
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    unsigned a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (A_TRANS)  // matrix i: k rows (i >> 1) * 8.., m columns (i & 1) * 8..
        ldmatrix_x4_trans(a[mt], A + (kt * 16 + ((lane >> 4) << 3) + (lane & 7)) * lda +
                                     mt * 16 + ((lane >> 3) & 1) * 8);
      else          // matrix i: m rows (i & 1) * 8.., k columns (i >> 1) * 8..
        ldmatrix_x4(a[mt], A + (mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * lda +
                               kt * 16 + (lane >> 4) * 8);
    }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      unsigned b[4];
      ldmatrix_x4_trans(b, B + (kt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldb +
                               (np * 2 + (lane >> 4)) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16_16816(acc[mt][2 * np], a[mt], b[0], b[1]);
        mma_bf16_16816(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
      }
    }
  }
}
#else
template <int MT, int NT, int KT, bool A_TRANS>
__device__ __forceinline__ void warp_gemm(float (&acc)[MT][NT][4], const T* A, int lda,
                                          const T* B, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < KT * 16; ++k) {
    float a[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mt * 16 + g + 8 * h;
        a[mt][h] = A_TRANS ? A[k * lda + row] : A[row * lda + k];
      }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 b = *reinterpret_cast<const float2*>(B + k * ldb + nt * 8 + 2 * t);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        acc[mt][nt][0] += a[mt][0] * b.x;
        acc[mt][nt][1] += a[mt][0] * b.y;
        acc[mt][nt][2] += a[mt][1] * b.x;
        acc[mt][nt][3] += a[mt][1] * b.y;
      }
    }
  }
}
#endif

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// two consecutive elements <-> floats
__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a, float& b) {
  const unsigned u = *reinterpret_cast<const unsigned*>(p);
  a = bf16_lo(u);
  b = bf16_hi(u);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<unsigned*>(p) = pack_bf16(a, b);
}

// sum of v over the cluster, in rank order (every thread of every CTA gets
// the same value); slot: this call's own cluster-reduction slot
__device__ float cluster_sum(cg::cluster_group& cluster, float v, float* red, float* slots,
                             int slot) {
  const float local = block_sum<THREADS>(v, red);
  if (threadIdx.x == 0) slots[slot] = local;
  cluster.sync();
  float total = 0.f;
#pragma unroll
  for (unsigned r = 0; r < MAX_CLUSTER; ++r)  // unrolled: the remote loads overlap
    if (r < cluster.num_blocks()) total += cluster.map_shared_rank(slots, r)[slot];
  return total;
}

__global__ void __launch_bounds__(THREADS, 1)
attention_block_kernel(const T* __restrict__ x, const float* __restrict__ gn_pre_scale,
                       const float* __restrict__ gn_pre_bias, const T* __restrict__ w_qkv,
                       const T* __restrict__ w_out, const float* __restrict__ b_out,
                       const float* __restrict__ gn_post_scale,
                       const float* __restrict__ gn_post_bias, float* __restrict__ y_scr,
                       T* __restrict__ out, int N, int P, int x_res, int y_res, float eps) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int G = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // shared memory
  char* sp = reinterpret_cast<char*>(smem);
  T* s_w = reinterpret_cast<T*>(sp);            // (C, LDW)
  T* s_wo = s_w + C * LDW;                      // (D, LDO)
  T* s_ctx = s_wo + D * LDO;                    // (D, LDD)
  float* s_par = reinterpret_cast<float*>(sp + W_BYTES);
  float* pre_sc = s_par;                        // folded GroupNorm affines
  float* pre_sh = pre_sc + C;
  float* post_sc = pre_sh + C;
  float* post_sh = post_sc + C;
  float* s_bo = post_sh + C;
  float* s_red = s_bo + C;                      // block reductions
  float* s_slots = s_red + WARPS;               // cluster reductions, one slot each
  T* s_xa = reinterpret_cast<T*>(sp + W_BYTES + PAR_BYTES) + warp * TILE * LDA;
  char* after_xa = sp + W_BYTES + PAR_BYTES + WARPS * XA_BYTES;
  T* s_x = reinterpret_cast<T*>(after_xa);      // (P, C) if x_res
  char* scratch = after_xa + (x_res ? static_cast<size_t>(P) * C * sizeof(T) : 0);

  const int n0 = rank * P;
  const int cnt = max(0, min(P, N - n0));       // this CTA's positions
  const int tiles = (cnt + TILE - 1) / TILE;
  const T* xg = x + (static_cast<size_t>(b) * N + n0) * C;
  const T* xs = x_res ? s_x : xg;               // this CTA's x, (cnt, C)
  float* ys = y_res ? reinterpret_cast<float*>(scratch)
                    : y_scr + (static_cast<size_t>(b) * G + rank) * P * C;
  const float denom = static_cast<float>(C) * static_cast<float>(N);

  // ---- phase 0: x on chip, weights, pre-GN statistics ---------------------
  if (x_res) {
    const int chunks = cnt * C * static_cast<int>(sizeof(T)) / 16;
    for (int i = tid; i < chunks; i += THREADS)
      cp_async16(reinterpret_cast<char*>(s_x) + 16 * i,
                 reinterpret_cast<const char*>(xg) + 16 * i, true);
    cp_async_commit();
  }
  for (int i = tid; i < C * 3 * D; i += THREADS) s_w[(i / (3 * D)) * LDW + i % (3 * D)] = w_qkv[i];
  for (int i = tid; i < D * C; i += THREADS) s_wo[(i / C) * LDO + i % C] = w_out[i];
  if (tid < C) s_bo[tid] = b_out[tid];
  if (x_res) cp_async_wait<0>();
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
  const float mu = cluster_sum(cluster, acc, s_red, s_slots, 0) / denom;
  acc = 0.f;
  for (int i = tid; i < n_vec; i += THREADS) {
    float r[PER];
    load16(xs + i * PER, r);
#pragma unroll
    for (int j = 0; j < PER; ++j) acc += (r[j] - mu) * (r[j] - mu);
  }
  const float inv = rsqrtf(cluster_sum(cluster, acc, s_red, s_slots, 1) / denom + eps);
  if (tid < C) {
    const float sc = gn_pre_scale[tid] * inv;
    pre_sc[tid] = sc;
    pre_sh[tid] = gn_pre_bias[tid] - sc * mu;
  }
  __syncthreads();

  // the pre-GN output of a tile's positions into this warp's A operand,
  // rounded to T; positions past cnt are zeros
  auto make_xn = [&](int tile) {
    for (int i = lane; i < TILE * C / 8; i += 32) {
      const int row = i / (C / 8), c8 = (i % (C / 8)) * 8;
      const int pos = tile * TILE + row;
      float r[8];
      if (pos < cnt) {
        load8(xs + static_cast<size_t>(pos) * C + c8, r);
#pragma unroll
        for (int j = 0; j < 8; ++j) r[j] = rnd<T>(r[j] * pre_sc[c8 + j] + pre_sh[c8 + j]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) r[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; j += PER) store16(s_xa + row * LDA + c8 + j, r + j);
    }
    __syncwarp();
  };

  // ---- phase A: ctx = softmax_N(k) v^T, online over this warp's tiles ------
  float* s_kf = reinterpret_cast<float*>(scratch + warp * STAGE_BYTES);  // (TILE, LDK)
  T* s_kp = reinterpret_cast<T*>(s_kf + TILE * LDK);                      // (TILE, LDD)
  T* s_v = s_kp + TILE * LDD;                                             // (TILE, LDD)
  float* s_resc = reinterpret_cast<float*>(s_v + TILE * LDD);             // (D)
  float m_d = -INFINITY, s_d = 0.f;  // lane d: running max and sum of column d
  float cacc[2][4][4];               // ctx partial (d, e)
  zero(cacc);
  for (int tile = warp; tile < tiles; tile += WARPS) {
    make_xn(tile);
    float kacc[1][4][4], vacc[1][4][4];
    zero(kacc);
    zero(vacc);
    warp_gemm<1, 4, C / 16, false>(kacc, s_xa, LDA, s_w + D, LDW);
    warp_gemm<1, 4, C / 16, false>(vacc, s_xa, LDA, s_w + 2 * D, LDW);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = g + 8 * h, col = nt * 8 + 2 * t;
        const bool ok = tile * TILE + row < cnt;
        store2(s_kf + row * LDK + col, ok ? kacc[0][nt][2 * h] : -INFINITY,
               ok ? kacc[0][nt][2 * h + 1] : -INFINITY);
        store2(s_v + row * LDD + col, ok ? rnd<T>(vacc[0][nt][2 * h]) : 0.f,
               ok ? rnd<T>(vacc[0][nt][2 * h + 1]) : 0.f);
      }
    __syncwarp();
    {  // lane d: column d's tile max, rescale, numerators, sum
      float bm = -INFINITY;
#pragma unroll
      for (int r = 0; r < TILE; ++r) bm = fmaxf(bm, s_kf[r * LDK + lane]);
      const float m_new = fmaxf(m_d, bm);  // finite: the tile holds a position
      const float resc = expf(m_d - m_new);
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < TILE; ++r) {
        const float w = expf(s_kf[r * LDK + lane] - m_new);  // 0 past cnt
        sum += w;
        s_kp[r * LDD + lane] = from_f<T>(w);
      }
      s_d = s_d * resc + sum;
      m_d = m_new;
      s_resc[lane] = resc;
    }
    __syncwarp();
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float rs = s_resc[mt * 16 + g + 8 * h];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          cacc[mt][nt][2 * h] *= rs;
          cacc[mt][nt][2 * h + 1] *= rs;
        }
      }
    warp_gemm<2, 4, 1, true>(cacc, s_kp, LDD, s_v, LDD);
    __syncwarp();  // the next tile overwrites this warp's tiles
  }

  // the warps' partials -> the CTA's, published in `pub` for the cluster
  __syncthreads();  // phase A's tiles are dead: the partials take their place
  float* part = reinterpret_cast<float*>(scratch) + warp * PART_FLOATS;
  float* pub = reinterpret_cast<float*>(scratch) + WARPS * PART_FLOATS;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        part[(mt * 16 + g + 8 * (i >> 1)) * D + nt * 8 + 2 * t + (i & 1)] = cacc[mt][nt][i];
  part[D * D + lane] = m_d;
  part[D * D + D + lane] = s_d;
  __syncthreads();

  // thread: row d, columns e0..e0+EPT-1 of ctx; a partial with no position
  // (m = -inf) weighs 0
  constexpr int EPT = D * D / THREADS;
  const int d = tid / (D / EPT), e0 = (tid % (D / EPT)) * EPT;
  // (loops unrolled to the most partials, so that their loads overlap)
  constexpr int MAX_PARTS = WARPS > MAX_CLUSTER ? WARPS : MAX_CLUSTER;
  auto merge = [&](auto partial, int n_parts, float (&ce)[EPT], float& mx, float& s) {
    mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < MAX_PARTS; ++w)
      if (w < n_parts) mx = fmaxf(mx, partial(w)[D * D + d]);
    s = 0.f;
#pragma unroll
    for (int j = 0; j < EPT; ++j) ce[j] = 0.f;
#pragma unroll
    for (int w = 0; w < MAX_PARTS; ++w) {
      if (w >= n_parts) break;
      const float* p = partial(w);
      const float mw = p[D * D + d];
      const float f = mw == -INFINITY ? 0.f : expf(mw - mx);
      s += f * p[D * D + D + d];
#pragma unroll
      for (int j = 0; j < EPT; ++j) ce[j] += f * p[d * D + e0 + j];
    }
  };
  {
    float ce[EPT], mx, s;
    merge([&](int w) { return reinterpret_cast<const float*>(scratch) + w * PART_FLOATS; },
          WARPS, ce, mx, s);
#pragma unroll
    for (int j = 0; j < EPT; ++j) pub[d * D + e0 + j] = ce[j];
    if (e0 == 0) {
      pub[D * D + d] = mx;
      pub[D * D + D + d] = s;
    }
  }
  cluster.sync();
  {
    float ce[EPT], mx, s;
    merge([&](int r) { return cluster.map_shared_rank(pub, r); }, G, ce, mx, s);
    const float sden = fmaxf(s, 1e-30f);
#pragma unroll
    for (int j = 0; j < EPT; ++j) s_ctx[d * LDD + e0 + j] = from_f<T>(ce[j] / sden);
  }
  cluster.sync();  // every CTA has read the others' partials: y may take their place

  // ---- phase B: y = W_o^T (ctx^T softmax_d(q) d^-1/2) + b_o -----------------
  const float qscale = 0.17677669529663687f;  // 32 ** -0.5
  acc = 0.f;
  for (int tile = warp; tile < tiles; tile += WARPS) {
    make_xn(tile);
    float qacc[1][4][4];
    zero(qacc);
    warp_gemm<1, 4, C / 16, false>(qacc, s_xa, LDA, s_w, LDW);
    __syncwarp();  // s_xa is read: the q softmax takes its place
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g (h = 0) and g + 8: 8 values here, 32 over the quad
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mx = fmaxf(mx, fmaxf(qacc[0][nt][2 * h], qacc[0][nt][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          qacc[0][nt][2 * h + j] = expf(qacc[0][nt][2 * h + j] - mx);
          sum += qacc[0][nt][2 * h + j];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        store2(s_xa + (g + 8 * h) * LDA + nt * 8 + 2 * t,
               rnd<T>(qacc[0][nt][2 * h] / sum * qscale),
               rnd<T>(qacc[0][nt][2 * h + 1] / sum * qscale));
    }
    __syncwarp();
    float oacc[1][4][4];
    zero(oacc);
    warp_gemm<1, 4, 2, false>(oacc, s_xa, LDA, s_ctx, LDD);
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store2(s_xa + (g + 8 * h) * LDA + nt * 8 + 2 * t, oacc[0][nt][2 * h],
               oacc[0][nt][2 * h + 1]);  // rounded to T by the store
    __syncwarp();
    float yacc[1][NT_C][4];
    zero(yacc);
    warp_gemm<1, NT_C, 2, false>(yacc, s_xa, LDA, s_wo, LDO);
    const bool ok0 = tile * TILE + g < cnt, ok1 = tile * TILE + g + 8 < cnt;
#pragma unroll
    for (int nt = 0; nt < NT_C; ++nt) {
      const float b0 = s_bo[nt * 8 + 2 * t], b1 = s_bo[nt * 8 + 2 * t + 1];
      const float4 y = make_float4(yacc[0][nt][0] + b0, yacc[0][nt][1] + b1,
                                   yacc[0][nt][2] + b0, yacc[0][nt][3] + b1);
      *reinterpret_cast<float4*>(ys + ((tile * NT_C + nt) * 32 + lane) * 4) = y;
      acc += (ok0 ? y.x + y.y : 0.f) + (ok1 ? y.z + y.w : 0.f);
    }
    __syncwarp();  // the next tile overwrites s_xa
  }
  const float mu_y = cluster_sum(cluster, acc, s_red, s_slots, 2) / denom;

  // post-GN variance, centred, over this warp's own fragments of y
  acc = 0.f;
  for (int tile = warp; tile < tiles; tile += WARPS) {
    const bool ok0 = tile * TILE + g < cnt, ok1 = tile * TILE + g + 8 < cnt;
#pragma unroll
    for (int nt = 0; nt < NT_C; ++nt) {
      const float4 y = *reinterpret_cast<const float4*>(ys + ((tile * NT_C + nt) * 32 + lane) * 4);
      if (ok0) acc += (y.x - mu_y) * (y.x - mu_y) + (y.y - mu_y) * (y.y - mu_y);
      if (ok1) acc += (y.z - mu_y) * (y.z - mu_y) + (y.w - mu_y) * (y.w - mu_y);
    }
  }
  const float inv_y = rsqrtf(cluster_sum(cluster, acc, s_red, s_slots, 3) / denom + eps);
  if (tid < C) {
    const float sc = gn_post_scale[tid] * inv_y;
    post_sc[tid] = sc;
    post_sh[tid] = gn_post_bias[tid] - sc * mu_y;
  }
  __syncthreads();

  // ---- phase C: out = x + GN1_post(y) -----------------------------------------
  T* ob = out + (static_cast<size_t>(b) * N + n0) * C;
  for (int tile = warp; tile < tiles; tile += WARPS) {
#pragma unroll
    for (int nt = 0; nt < NT_C; ++nt) {
      const float4 y = *reinterpret_cast<const float4*>(ys + ((tile * NT_C + nt) * 32 + lane) * 4);
      const int c = nt * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pos = tile * TILE + g + 8 * h;
        if (pos < cnt) {
          float a, bb;
          load2(xs + static_cast<size_t>(pos) * C + c, a, bb);
          const float y0 = h ? y.z : y.x, y1 = h ? y.w : y.y;
          store2(ob + static_cast<size_t>(pos) * C + c,
                 a + rnd<T>(y0 * post_sc[c] + post_sh[c]),
                 bb + rnd<T>(y1 * post_sc[c + 1] + post_sh[c + 1]));
        }
      }
    }
  }
  cluster.sync();  // no CTA leaves while another may still read its slots
}

constexpr int MAX_DEVICES = 64;

// the card's opt-in shared memory a block (cached per device)
size_t card_smem_limit() {
  static int limit[MAX_DEVICES];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES) return 0;
  if (limit[dev] == 0 &&
      cudaDeviceGetAttribute(&limit[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    limit[dev] = 0;
  return static_cast<size_t>(limit[dev]);
}

// Once per device: the kernel may take the card's whole opt-in shared
// memory.  Once per (device, G, shared bytes): the card can place such a
// cluster (cudaOccupancyMaxActiveClusters >= 1), else an error.  Both are
// fixed properties of the card, so later launches skip the queries.
int check_launch(const cudaLaunchConfig_t& cfg, int G) {
  static bool attr_set[MAX_DEVICES];
  static size_t placed[MAX_DEVICES][MAX_CLUSTER + 1];  // largest shared bytes seen to fit
  int dev = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidValue);
  if (!attr_set[dev]) {
    err = static_cast<int>(cudaFuncSetAttribute(attention_block_kernel,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                static_cast<int>(card_smem_limit())));
    if (err) return err;
    attr_set[dev] = true;
  }
  if (cfg.dynamicSmemBytes > placed[dev][G]) {
    int clusters = 0;
    err = static_cast<int>(cudaOccupancyMaxActiveClusters(&clusters, attention_block_kernel, &cfg));
    if (err) return err;
    if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    placed[dev][G] = cfg.dynamicSmemBytes;
  }
  return 0;
}

int plan_for(int N, int cluster, int smem_limit, Plan* p) {
  if (N < 1 || cluster < 0 || cluster > MAX_CLUSTER || (cluster & (cluster - 1)) || smem_limit < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t limit = smem_limit ? static_cast<size_t>(smem_limit) : card_smem_limit();
  return make_plan(N, cluster, limit, p) ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// where a launch at (N, cluster, smem_limit) keeps a sample: plan[0..4] =
// {G, P, x in shared memory, y in shared memory, shared bytes a CTA}.
// cluster 0 lets the kernel choose G; smem_limit 0 is the card's opt-in limit.
extern "C" int calo_attention_block_plan(int N, int C_, int is_bf16, int cluster,
                                         int smem_limit, int* plan) {
  if (!is_variant(is_bf16, C_)) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const int err = plan_for(N, cluster, smem_limit, &p);
  if (err) return err;
  plan[0] = p.G;
  plan[1] = p.P;
  plan[2] = p.x_res;
  plan[3] = p.y_res;
  plan[4] = static_cast<int>(p.smem);
  return 0;
}

// y_scr: (B, G * P * C) f32 when the plan keeps y in device memory, else unused
extern "C" int calo_attention_block_forward(const void* x, const void* gn_pre_scale,
                                            const void* gn_pre_bias, const void* w_qkv,
                                            const void* w_out, const void* b_out,
                                            const void* gn_post_scale,
                                            const void* gn_post_bias, void* y_scr,
                                            void* out, int B, int N, int C_, int is_bf16,
                                            float eps, int cluster, int smem_limit,
                                            void* stream) {
  if (B < 1 || !is_variant(is_bf16, C_)) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  int err = plan_for(N, cluster, smem_limit, &p);
  if (err) return err;
  if (!p.y_res && y_scr == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(B) * p.G > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B * p.G));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(p.G);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a cluster the card cannot place is an error, never a smaller launch
  err = check_launch(cfg, p.G);
  if (err) return err;
  err = static_cast<int>(cudaLaunchKernelEx(
      &cfg, attention_block_kernel, static_cast<const T*>(x),
      static_cast<const float*>(gn_pre_scale), static_cast<const float*>(gn_pre_bias),
      static_cast<const T*>(w_qkv), static_cast<const T*>(w_out),
      static_cast<const float*>(b_out), static_cast<const float*>(gn_post_scale),
      static_cast<const float*>(gn_post_bias), static_cast<float*>(y_scr), static_cast<T*>(out),
      N, p.P, static_cast<int>(p.x_res), static_cast<int>(p.y_res), eps));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
