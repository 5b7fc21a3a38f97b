// The one (dtype, C) variant a build of the linear-attention kernels (K1,
// K2, K3) compiles, and the pieces they share on Hopper: warp-level
// products on the tensor cores, sums over a thread-block cluster in rank
// order, the context pass (k/v projections, online softmax of k over
// positions, ctx partials) with its merge over the cluster, and the launch
// checks of a cluster.
//
// Each source builds once per variant, -DCALO_BF16=0|1 -DCALO_C=16|32|64|96
// (the compute dtype and the channel count, a multiple of 16: one k-step of
// the products, two n-tiles of 8), so the variants compile in parallel and
// each library holds one instantiation of its kernel.
//
// A sample's positions are split over the G CTAs of a cluster; CTA r
// holds positions [r P, r P + P).  A warp takes 16 positions at a time (one
// m-tile), with the tile's A operand in its own rows of shared memory.
// bf16: mma.sync m16n8k16 (bf16 inputs, exact products, f32 sums),
// operands read by ldmatrix.  f32: the same fragments computed with FFMA on
// the CUDA cores (TF32 would not keep the kernels' tolerances).
#pragma once

#if !defined(CALO_C)
#error "build one variant: -DCALO_BF16=0|1 -DCALO_C=16|32|64|96"
#endif
#if CALO_C % 16 != 0
#error "CALO_C must be a multiple of 16"
#endif

#include <cooperative_groups.h>

#include "common.cuh"

namespace calo {

namespace cg = cooperative_groups;

constexpr int D = 32;  // dim_head

// whether a call's (is_bf16, C) is the variant this library was built for
inline bool is_variant(int is_bf16, int C) { return is_dtype_variant(is_bf16) && C == CALO_C; }

using T = VariantT;
constexpr int C = CALO_C;
constexpr int NT_C = C / 8;  // n-tiles of 8 channels
constexpr int TILE = 16;     // positions a warp takes at a time: one m-tile
// shared-memory rows, in elements, padded by 16 bytes: the 8 rows an
// ldmatrix reads (bf16), or the 8 rows of an A fragment and the 4 of a
// transposed B fragment that the f32 products read one element at a time,
// fall in distinct banks
constexpr int PAD = CALO_BF16 ? 8 : 4;
constexpr int LDW = 3 * D + PAD;  // w_qkv (C, 96): q | k | v columns
constexpr int LDO = C + PAD;      // w_out (D, C)
constexpr int LDD = D + PAD;      // (D, D) matrices and (TILE, D) tiles
// (TILE, C) tiles, whose rows also take a (TILE, D) tile (K1's q softmax and
// attention output, K2's ks): at least D wide where C < D
constexpr int LDA = (C > D ? C : D) + PAD;
constexpr int LDK = D + 8;        // a warp's f32 k tile (TILE, D): conflict-free pair stores
constexpr float QSCALE = 0.17677669529663687f;  // 32 ** -0.5

// ---- warp-level products -----------------------------------------------------
// acc[MT][NT] (C fragments) += A (MT*16 x KT*16) B (KT*16 x NT*8), all in
// shared memory: A row-major with row stride lda (A_TRANS: stored as its
// transpose, (K, M) with stride lda), B row-major (K, N) with stride ldb
// (B_TRANS: stored as its transpose, (N, K) with stride ldb).

#if CALO_BF16
template <int MT, int NT, int KT, bool A_TRANS, bool B_TRANS = false>
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
      // matrix i: n-tile np * 2 + (i >> 1), k rows kt * 16 + (i & 1) * 8..
      unsigned b[4];
      if (B_TRANS)
        ldmatrix_x4(b, B + ((np * 2 + (lane >> 4)) * 8 + (lane & 7)) * ldb + kt * 16 +
                           ((lane >> 3) & 1) * 8);
      else
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
template <int MT, int NT, int KT, bool A_TRANS, bool B_TRANS = false>
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
      const int n = nt * 8 + 2 * t;
      const float2 b = B_TRANS ? make_float2(B[n * ldb + k], B[(n + 1) * ldb + k])
                               : *reinterpret_cast<const float2*>(B + k * ldb + n);
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

// a (TILE x NT*8) fragment tile into shared memory rows of stride ld, each
// value rounded to T by the store
template <int NT>
__device__ __forceinline__ void store_frags(T* s, int ld, const float (&acc)[1][NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store2(s + (g + 8 * h) * ld + nt * 8 + 2 * t, acc[0][nt][2 * h], acc[0][nt][2 * h + 1]);
}

// The projections' input of positions tile * TILE.. of xs (cnt, C) into a
// warp's A operand s_a (TILE, LDA), rounded to T: x * sc + sh (a folded
// GroupNorm) where AFFINE, else x itself; positions past cnt as zeros.
template <bool AFFINE>
__device__ __forceinline__ void stage_input(T* s_a, const T* xs, int cnt, int tile,
                                            const float* sc, const float* sh) {
  constexpr int PER = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < TILE * C / 8; i += 32) {
    const int row = i / (C / 8), c8 = (i % (C / 8)) * 8;
    const int pos = tile * TILE + row;
    float r[8];
    if (pos < cnt) {
      load8(xs + static_cast<size_t>(pos) * C + c8, r);
      if (AFFINE) {
#pragma unroll
        for (int j = 0; j < 8; ++j) r[j] = rnd<T>(r[j] * sc[c8 + j] + sh[c8 + j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) r[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; j += PER) store16(s_a + row * LDA + c8 + j, r + j);
  }
  __syncwarp();
}

// ---- sums over the cluster ---------------------------------------------------

// sum of v over the cluster, in rank order (every thread of every CTA gets
// the same value); slot: this call's own cluster-reduction slot
template <int THREADS, int MAX_G>
__device__ float cluster_sum(cg::cluster_group& cluster, float v, float* red, float* slots,
                             int slot) {
  const float local = block_sum<THREADS>(v, red);
  if (threadIdx.x == 0) slots[slot] = local;
  cluster.sync();
  float total = 0.f;
#pragma unroll
  for (unsigned r = 0; r < MAX_G; ++r)  // unrolled: the remote loads overlap
    if (r < cluster.num_blocks()) total += cluster.map_shared_rank(slots, r)[slot];
  return total;
}

// The CTAs' partials pub[0, n) (this CTA's written before the call) summed
// over the cluster in rank order.  Rank r sums the entries i = r (mod G),
// reading them from every rank, so each CTA reads n / G entries of each
// partial; then fn(i, total) runs for i < n_all on every CTA (the totals
// gathered from their owners) and for n_all <= i < n on the owner alone
// (per-sample results that one rank writes).  An entry's total replaces the
// owner's own partial of it, which no other rank reads.  Ends with a
// cluster barrier: fn's shared-memory stores are then visible to the CTA
// and pub may be reused.
template <int THREADS, int MAX_G, class Fn>
__device__ void cluster_merge(cg::cluster_group& cluster, float* pub, int n_all, int n, Fn fn) {
  cluster.sync();  // every CTA's partial is published
  const int G = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  for (int i = rank + G * static_cast<int>(threadIdx.x); i < n; i += G * THREADS) {
    float total = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_G; ++r)  // unrolled: the remote loads overlap
      if (r < G) total += cluster.map_shared_rank(pub, r)[i];
    if (i < n_all) pub[i] = total;
    else fn(i, total);
  }
  if (n_all > 0) {
    cluster.sync();  // every total is in its owner's pub
    for (int i = threadIdx.x; i < n_all; i += THREADS) fn(i, cluster.map_shared_rank(pub, i % G)[i]);
  }
  cluster.sync();
}

// ---- the context pass ----------------------------------------------------------

// a warp's part of phase A: the online softmax of k over its positions and
// its ctx partial, cacc(d, e) = sum_n exp(k(d, n) - m_d) v(e, n)
struct CtxPartial {
  float m, s;          // lane d: running max and sum of column d
  float c[2][4][4];    // (D x D) fragments
};

// bytes of a warp's phase-A staging: f32 k tile, k' tile, v tile
constexpr size_t CTX_STAGE_BYTES = TILE * LDK * 4 + 2 * TILE * LDD * sizeof(T);
constexpr size_t CTX_PART_FLOATS = D * D + 2 * D;  // ctx, m, s of one partial
static_assert(CTX_STAGE_BYTES % 16 == 0, "alignment");

// Phase A over this warp's tiles of the CTA's cnt positions (tile = warp,
// warp + WARPS, ...): make_a(tile) writes the tile's projection input
// (positions past cnt as zeros) into s_a (TILE, LDA); k and v are its
// products with w_qkv's k and v columns (s_w, (C, LDW)); stage: this warp's
// CTX_STAGE_BYTES.
template <int WARPS, class MakeA>
__device__ __forceinline__ void context_partial(CtxPartial& p, MakeA make_a, const T* s_a,
                                                const T* s_w, char* stage, int cnt) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int tiles = (cnt + TILE - 1) / TILE;
  float* s_kf = reinterpret_cast<float*>(stage);      // (TILE, LDK)
  T* s_kp = reinterpret_cast<T*>(s_kf + TILE * LDK);  // (TILE, LDD)
  T* s_v = s_kp + TILE * LDD;                         // (TILE, LDD)
  p.m = -INFINITY;
  p.s = 0.f;
  zero(p.c);
  for (int tile = warp; tile < tiles; tile += WARPS) {
    make_a(tile);
    float kacc[1][4][4], vacc[1][4][4];
    zero(kacc);
    zero(vacc);
    warp_gemm<1, 4, C / 16, false>(kacc, s_a, LDA, s_w + D, LDW);
    warp_gemm<1, 4, C / 16, false>(vacc, s_a, LDA, s_w + 2 * D, LDW);
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
    float resc;
    {  // lane d: column d's tile max, rescale, numerators, sum
      float bm = -INFINITY;
#pragma unroll
      for (int r = 0; r < TILE; ++r) bm = fmaxf(bm, s_kf[r * LDK + lane]);
      const float m_new = fmaxf(p.m, bm);  // finite: the tile holds a position
      resc = expf(p.m - m_new);
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < TILE; ++r) {
        const float w = expf(s_kf[r * LDK + lane] - m_new);  // 0 past cnt
        sum += w;
        s_kp[r * LDD + lane] = from_f<T>(w);
      }
      p.s = p.s * resc + sum;
      p.m = m_new;
    }
    __syncwarp();
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // row d of the partial: lane d's rescale
        const float rs = __shfl_sync(0xffffffffu, resc, mt * 16 + g + 8 * h);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          p.c[mt][nt][2 * h] *= rs;
          p.c[mt][nt][2 * h + 1] *= rs;
        }
      }
    warp_gemm<2, 4, 1, true>(p.c, s_kp, LDD, s_v, LDD);
    __syncwarp();  // the next tile overwrites this warp's tiles
  }
}

// Entries (d, e0..e0+EPT-1) of ctx, and the max and sum of column d, merged
// over n_parts partials (partial(w): ctx, m, s of partial w), each rescaled
// by exp(m_w - m_all); a partial with no position (m = -inf) weighs 0.
// (Loops unrolled to the most partials, so that their loads overlap.)
template <int MAX_PARTS, int EPT, class Partial>
__device__ __forceinline__ void merge_partials(Partial partial, int n_parts, int d, int e0,
                                               float (&ce)[EPT], float& mx, float& s) {
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
    const float* q = partial(w);
    const float mw = q[D * D + d];
    const float f = mw == -INFINITY ? 0.f : expf(mw - mx);
    s += f * q[D * D + D + d];
#pragma unroll
    for (int j = 0; j < EPT; ++j) ce[j] += f * q[d * D + e0 + j];
  }
}

// The warps' partials merge in the CTA, then the CTAs' over the cluster in
// rank order (merge_partials).  Every CTA ends with the same ctx, rounded
// to T, in s_ctx (D, LDD), and, where km and ksum are given, the softmax's
// final max and sum of each d.  parts: (WARPS + 1) * CTX_PART_FLOATS floats
// of scratch; ends with a cluster barrier, after which parts may be reused.
template <int THREADS, int MAX_G>
__device__ void context_merge(cg::cluster_group& cluster, const CtxPartial& p, float* parts,
                              T* s_ctx, float* km, float* ksum) {
  constexpr int WARPS = THREADS / 32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int G = static_cast<int>(cluster.num_blocks());
  __syncthreads();  // phase A's tiles are dead: the partials take their place
  float* part = parts + warp * CTX_PART_FLOATS;
  float* pub = parts + WARPS * CTX_PART_FLOATS;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        part[(mt * 16 + g + 8 * (i >> 1)) * D + nt * 8 + 2 * t + (i & 1)] = p.c[mt][nt][i];
  part[D * D + lane] = p.m;
  part[D * D + D + lane] = p.s;
  __syncthreads();

  // thread: row d, columns e0..e0+EPT-1 of ctx
  constexpr int EPT = D * D / THREADS;
  static_assert(D * D % THREADS == 0 && THREADS <= D * D, "ctx entries split evenly over threads");
  const int d = tid / (D / EPT), e0 = (tid % (D / EPT)) * EPT;
  constexpr int MAX_PARTS = WARPS > MAX_G ? WARPS : MAX_G;
  {
    float ce[EPT], mx, s;
    merge_partials<MAX_PARTS>([&](int w) -> const float* { return parts + w * CTX_PART_FLOATS; },
                              WARPS, d, e0, ce, mx, s);
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
    merge_partials<MAX_PARTS>([&](int r) -> const float* { return cluster.map_shared_rank(pub, r); },
                              G, d, e0, ce, mx, s);
    const float sden = fmaxf(s, 1e-30f);
#pragma unroll
    for (int j = 0; j < EPT; ++j) s_ctx[d * LDD + e0 + j] = from_f<T>(ce[j] / sden);
    if (km != nullptr && e0 == 0) {
      km[d] = mx;
      ksum[d] = sden;
    }
  }
  cluster.sync();  // every CTA has read the others' partials: parts may be reused
}

// ---- launching a cluster --------------------------------------------------------

constexpr int MAX_DEVICES = 64;

// The two functions below keep per-library state in static locals, so they
// are `static` (internal linkage): as inline or template functions of
// external linkage, the loader would merge their statics across the
// libraries of the kernels (one a (dtype, C) variant) whose kernels share a
// type, and a library would skip setting its own kernel's attributes.

// the card's opt-in shared memory a block (cached per device)
static size_t card_smem_limit() {
  static int limit[MAX_DEVICES];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES) return 0;
  if (limit[dev] == 0 &&
      cudaDeviceGetAttribute(&limit[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    limit[dev] = 0;
  return static_cast<size_t>(limit[dev]);
}

// Once per device: the kernel may take the card's whole opt-in shared
// memory (and, with MAX_G > 8, clusters past the portable size).  Once per
// (device, G, shared bytes): the card can place such a cluster
// (cudaOccupancyMaxActiveClusters >= 1), else an error.  Both are fixed
// properties of the card, so later launches skip the queries.
template <int MAX_G, class Kernel>
static int check_launch(Kernel kernel, const cudaLaunchConfig_t& cfg, int G) {
  static bool attr_set[MAX_DEVICES];
  static size_t placed[MAX_DEVICES][MAX_G + 1];  // largest shared bytes seen to fit
  int dev = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err) return err;
  if (dev < 0 || dev >= MAX_DEVICES || G < 1 || G > MAX_G)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!attr_set[dev]) {
    err = static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                static_cast<int>(card_smem_limit())));
    if (!err && MAX_G > 8)
      err = static_cast<int>(
          cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
    if (err) return err;
    attr_set[dev] = true;
  }
  if (cfg.dynamicSmemBytes > placed[dev][G]) {
    int clusters = 0;
    err = static_cast<int>(cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg));
    if (err) return err;
    if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    placed[dev][G] = cfg.dynamicSmemBytes;
  }
  return 0;
}

// a launch of B samples of G CTAs of `threads` threads, one cluster a sample
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int B, int G, int threads, size_t smem, void* stream) {
    cfg.gridDim = dim3(static_cast<unsigned>(B * G));
    cfg.blockDim = dim3(static_cast<unsigned>(threads));
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(G);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

}  // namespace calo
