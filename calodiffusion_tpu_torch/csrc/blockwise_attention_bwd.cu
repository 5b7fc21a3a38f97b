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
//   1. dq pass, one CTA a (b*h, tile of query rows): Drow from dO and out,
//      the rows' lse in the kernel's exponent units and Drow written to a
//      scratch (2, B*H, Npad) (Npad = N rounded up to NPAD; rows past N as
//      lse = +inf, Drow = 0, so they weigh nothing below), then dQ over all
//      key tiles.
//   2. dk/dv pass, one CTA a (b*h, tile of keys): dK and dV over all query
//      tiles, the rows' lse and Drow read from the scratch.
// Each pass recomputes S and P: two exponentials a score against the one of
// FlashAttention-2's single pass (whose dQ sums across key blocks with
// atomics), and 14 D FLOPs of products a score against the 10 D the
// gradient needs (S, dP, dV, dK, dQ).  A one-pass deterministic variant
// (FlashAttention-3's: dQ summed in key-tile order under per-query-tile
// semaphores) would drop the second exponential; it is not built.
//
// Bound.  At D = 32, 10 D = 320 FLOPs and one exponential a score: on the
// tensor cores (989 TFLOP/s bf16) the products bound the work, ahead of the
// special-function units' exponentials; in f32 the CUDA cores (67 TFLOP/s).
// As built the bf16 kernel does 14 D FLOPs and two exponentials a score,
// which puts the exponentials (16 a clock an SM) level with the products:
// the design overlaps them rather than removing either.
//
// bf16 design: Hopper's warp-specialised pipeline (hopper.cuh).  A CTA has
// one producer warpgroup and C consumer warpgroups of 64 rows each
// (queries in the dq pass, keys in the dk/dv pass).
//   - The producer's one thread streams the other side's tiles of BT rows
//     (K and V, or Q and dO, plus the dk/dv pass's lse and Drow slices by a
//     bulk copy) with TMA into a ring of STAGES stages, each stage's
//     arrival on a "full" mbarrier with its bytes; the consumers' warps
//     release a stage on its "empty" mbarrier.  Every consumer warpgroup
//     reads every streamed tile, so a CTA streams the sequence once for
//     64 C rows (mma.sync's CTAs of 64 streamed it once for 64), and TMA's
//     64-byte swizzle lays each 64-byte row where wgmma reads it without
//     bank conflicts.  Rows past N come in as TMA's zeros: no padded copies.
//   - Every product is a wgmma.mma_async m64nNk16 (bf16 in, f32 sums), B read
//     once a warpgroup from the swizzled tile through a descriptor: K-major
//     for S = Q K^T and dP = dO V^T (S^T = K Q^T, dP^T = V dO^T), and the same
//     tile MN-major (the transpose bit) for dQ = dS K (dV = P^T dO, dK =
//     dS^T Q).  A is in registers: the CTA's own Q and dO (K and V) rows,
//     loaded once, and P, dS (P^T, dS^T) straight from the f32 accumulator
//     fragments of the S and dP products rounded once to bf16 (the D
//     fragment of m64nN is the A fragment of the next product), so P and dS
//     never pass through shared memory.
//   - S and dP are two commit groups: a consumer waits for S alone and runs
//     its exponentials while dP is in flight, and the consumer warpgroups
//     interleave, one's exponentials beside another's wgmma.
//   - setmaxnreg gives the producer warpgroup 24 registers a thread and the
//     consumers the rest.
//   - Two plans (Plan<C, BT>), picked at the launch from the grid and the
//     card's SM count (read once per device): C = 2, BT = 128 in
//     general, and C = 3, BT = 64 where the 192-row CTAs' grid fills the
//     card four times over (dataset 3's N = 40,500).  Measured on the H100
//     (scripts/torch_kernel_variants.py, PERF.md): the kernel is held by
//     each warpgroup's chain of waits (S, then its exponentials, then the
//     products, then the next tile), not by the special-function units
//     (without the exponentials it is only ~12 % faster); more warpgroups
//     an SM hide more of those waits, and 128-row tiles halve them, but
//     three warpgroups leave 128 registers a thread, which 128-row tiles
//     spill; small grids lose a partial wave to the larger CTAs.  More
//     stages, the two warpgroups taking turns (FlashAttention-3's
//     ping-pong) and issuing the next tile's S and dP early (ptxas then
//     serialises the wgmmas) did not help.  The script forces a plan, the
//     stages or the ping-pong by text substitution into a copy of this
//     source.
// P = 2^(S c log2(e) - lse log2(e)), one FFMA and one ex2 a score.  No
// hi/lo split of P or dS: simulated at N = 512 and 2048, q x 1 and x 8
// (scripts/torch_attention_backward_rounding.py), the gradients lie at most
// 7.4e-3 from the plain version with one rounding each, within K4B_TOL =
// 2e-2 (the plain gradient is itself 2-3e-3 from float64); splitting both
// leaves the largest at 7.4e-3, since Drow taken from the bf16 output then
// dominates (2.0e-3 only with an exact Drow too).
//
// f32 design: the CUDA cores, as K4's f32 forward.  dq pass: a thread a
// query row (its q, dO and dQ in registers), K and V tiles of 64 keys in
// shared memory; dk/dv pass: a thread a key (k, v, dK, dV in registers),
// Q and dO tiles of 32 rows with their lse and Drow in shared memory.
// Keys and queries past N are masked by bounds (zero-filled rows, P = 0 at
// keys past N and at rows past N).
//
// C entry: calo_blockwise_attention_backward, for the one dtype variant of
// the build; returns a CUDA error code (a tensor map the CUDA driver refuses, or
// cudaGetLastError() after each launch).

#include "common.cuh"
#if CALO_BF16
#include "hopper.cuh"
#endif

namespace {

using namespace calo;

constexpr int D = 32;      // head dim
constexpr int NPAD = 128;  // the scratch's rows: N rounded up to a multiple of this
constexpr float LOG2E = 1.4426950408889634f;

#if CALO_BF16

using bf16 = __nv_bfloat16;
constexpr int STAGES = 2;                // the ring's stages
constexpr int SWIZZLE = 2 * D;           // a 64-byte row, TMA's and wgmma's 64-byte swizzle
static_assert(SWIZZLE == SWIZZLE_BYTES, "a row of D bf16 is the swizzle's width");
constexpr int PRODUCER_REGS = 24;        // setmaxnreg of the producer warpgroup
constexpr int QTILE = 128;               // the smaller plan's rows a CTA, for the entry's grid check

// A CTA's shape: C consumer warpgroups of 64 rows (queries, or keys) each
// and one producer warpgroup, streamed tiles of BT rows
template <int C, int TILE> struct Plan {
  static constexpr int CONSUMERS = C, BT = TILE, BR = 64 * C, THREADS = 128 * (1 + C);
  // setmaxnreg: the rest of the SM's 65,536 registers shared by the
  // consumers, a multiple of 8, at most 240
  static constexpr int FREE_REGS = (65536 - 128 * PRODUCER_REGS) / (128 * C) / 8 * 8;
  static constexpr int CONSUMER_REGS = FREE_REGS > 240 ? 240 : FREE_REGS;
  static constexpr unsigned TILE_BYTES = BT * D * sizeof(bf16);
  static constexpr unsigned STAT_BYTES = BT * sizeof(float);
  static constexpr int KB = BT / 16;  // k-steps of 16 over a streamed tile
  // shared memory: STAGES x (two tiles) from a 1024-byte boundary, then the
  // dk/dv pass's stats (lse, Drow) a stage, then the full and empty mbarriers
  static constexpr size_t smem(int stats) {
    return 1024 + STAGES * (2 * TILE_BYTES + stats * 2 * STAT_BYTES) +
           2 * STAGES * sizeof(uint64_t);
  }
  static_assert(BT % 16 == 0 && NPAD % BT == 0, "a streamed tile of whole k-steps within Npad");
  static_assert(TILE_BYTES % 1024 == 0, "tiles on the swizzle pattern's 1024-byte period");
};
// the plans the launch picks from: 128-row CTAs and 128-row tiles, or, where
// the grid fills the card four times over, 192-row CTAs (more warps an SM
// to hide each warpgroup's waits) with 64-row tiles (what fits their 128
// registers a thread)
using SmallGrid = Plan<2, 128>;
using LargeGrid = Plan<3, 64>;

// descriptors of a streamed tile (64-byte rows, 8-row groups 512 bytes
// apart): K-major at k-step kk (the D of its rows), MN-major at k-step kk
// (its rows 16 kk .. 16 kk + 15; D is one swizzle atom wide, so the
// leading byte offset between atoms is never used)
__device__ __forceinline__ uint64_t desc_k(const char* tile, int kk) {
  return smem_desc(tile + 32 * kk, 16, 8 * SWIZZLE);
}
__device__ __forceinline__ uint64_t desc_mn(const char* tile, int kk) {
  return smem_desc(tile + 16 * SWIZZLE * kk, 8 * SWIZZLE, 8 * SWIZZLE);
}

// A fragments (a warp's 16 rows x D, two k-steps) of rows row0.. of (N, D); zeros past N
__device__ __forceinline__ void load_a(unsigned (&a)[2][4], const bf16* src, int row0, int N,
                                       int g, int t) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + g + 8 * (i & 1);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      a[kk][i] = row < N ? *reinterpret_cast<const unsigned*>(
                               src + static_cast<size_t>(row) * D + 16 * kk + 8 * (i >> 1) + 2 * t)
                         : 0u;
  }
}

// A fragment of k-step kk from a D fragment of n-tiles of 8, rounded to bf16
template <int M>
__device__ __forceinline__ void a_from_d(unsigned (&a)[4], const float (&d)[M], int kk) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = 4 * (2 * kk + (i >> 1)) + 2 * (i & 1);
    a[i] = pack_bf16(d[j], d[j + 1]);
  }
}

// rows g and g + 8 of a warp's 16 from an m64n32 D fragment, times `mul`
__device__ __forceinline__ void store_rows(bf16* dst, const float (&o)[16], int row0, int N,
                                           float mul, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= N) continue;
    unsigned* p = reinterpret_cast<unsigned*>(dst + static_cast<size_t>(row) * D);
#pragma unroll
    for (int dt = 0; dt < 4; ++dt)
      p[dt * 4 + t] = pack_bf16(o[4 * dt + 2 * r] * mul, o[4 * dt + 2 * r + 1] * mul);
  }
}

// a consumer warp's release of stage s, once its products have read it
__device__ __forceinline__ void release(uint64_t* empty, int s) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[s]);
}

// the producer: streamed tiles j = 0.. of rows j BT.. of two tensor maps
// (and of the stats rows at st_lse, st_drow) into the ring
template <class P>
__device__ __forceinline__ void produce(char* ring, uint64_t* full, uint64_t* empty,
                                        const CUtensorMap* m0, const CUtensorMap* m1,
                                        const float* st_lse, const float* st_drow, int bh,
                                        int n_tiles) {
  const bool stats = st_lse != nullptr;
  char* stat_base = ring + STAGES * 2 * P::TILE_BYTES;
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
    mbar_arrive_expect_tx(&full[s], 2 * P::TILE_BYTES + (stats ? 2 * P::STAT_BYTES : 0));
    char* st = ring + s * 2 * P::TILE_BYTES;
    tma_load_3d(st, m0, 0, j * P::BT, bh, &full[s]);
    tma_load_3d(st + P::TILE_BYTES, m1, 0, j * P::BT, bh, &full[s]);
    if (stats) {
      char* sl = stat_base + s * 2 * P::STAT_BYTES;
      bulk_load(sl, st_lse + j * P::BT, P::STAT_BYTES, &full[s]);
      bulk_load(sl + P::STAT_BYTES, st_drow + j * P::BT, P::STAT_BYTES, &full[s]);
    }
  }
}

// one thread sets up the ring's barriers: full takes the producer's arrival
// and the stage's bytes, empty one arrival from each consumer warp
template <class P>
__device__ __forceinline__ char* setup_ring(float* smem, int stats, uint64_t*& full,
                                            uint64_t*& empty) {
  char* ring = align_smem_1024(smem);
  full = reinterpret_cast<uint64_t*>(ring +
                                     STAGES * (2 * P::TILE_BYTES + stats * 2 * P::STAT_BYTES));
  empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * P::CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  return ring;
}

template <class P>
__global__ void __launch_bounds__(P::THREADS, 1)
attention_dq_kernel(const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v, const bf16* __restrict__ q,
                    const bf16* __restrict__ out, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, bf16* __restrict__ dq,
                    float* __restrict__ st_lse, float* __restrict__ st_drow, int N, int npad,
                    int n_qtiles, float scale) {
  constexpr int BT = P::BT;
  extern __shared__ __align__(16) float smem[];
  uint64_t *full, *empty;
  char* ring = setup_ring<P>(smem, 0, full, empty);
  const int bh = blockIdx.x / n_qtiles;
  const int n_tiles = (N + BT - 1) / BT;

  if (threadIdx.x < 128) {  // producer warpgroup
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 0)
      produce<P>(ring, full, empty, &map_k, &map_v, nullptr, nullptr, bh, n_tiles);
    return;
  }
  reg_alloc<P::CONSUMER_REGS>();
  const int ct = threadIdx.x - 128, wg = ct >> 7;  // consumer warpgroup
  const int warp = (ct >> 5) & 3, lane = ct & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (blockIdx.x % n_qtiles) * P::BR + wg * 64 + warp * 16;  // a warp's rows
  const size_t base = static_cast<size_t>(bh) * N * D;
  const float c = scale * LOG2E;

  unsigned qa[2][4], da[2][4];
  load_a(qa, q + base, row0, N, g, t);
  load_a(da, dout + base, row0, N, g, t);

  // rows g and g + 8: lse in log2 units, Drow = rowsum(dO o out) in f32
  float lse2[2], drow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
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
    if (t == 0 && row < npad) {  // a CTA of 192 rows may pass Npad
      st_lse[static_cast<size_t>(bh) * npad + row] = lse2[r];
      st_drow[static_cast<size_t>(bh) * npad + row] = d;
    }
  }
  // and short of it: the last CTA fills the rows between its own and Npad
  if (blockIdx.x % n_qtiles == n_qtiles - 1)
    for (int row = n_qtiles * P::BR + ct; row < npad; row += 128 * P::CONSUMERS) {
      st_lse[static_cast<size_t>(bh) * npad + row] = INFINITY;
      st_drow[static_cast<size_t>(bh) * npad + row] = 0.f;
    }

  float acc[16];  // dQ / c, m64n32
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    mbar_wait(&full[s], (j / STAGES) & 1);
    const char* kt = ring + s * 2 * P::TILE_BYTES;
    const char* vt = kt + P::TILE_BYTES;

    // S and dP as two commit groups: the exponentials run while dP does
    float sc[BT / 2], dp[BT / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) Wgmma<BT, 0>::rs(sc, qa[kk], desc_k(kt, kk), kk);  // S = Q K^T
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) Wgmma<BT, 0>::rs(dp, da[kk], desc_k(vt, kk), kk);  // dP = dO V^T
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(sc);
    const int nk = N - j * BT;  // keys of this tile
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) {
      const int col = 8 * (i >> 2) + 2 * t + (i & 1);
      sc[i] = col < nk ? exp2_approx(fmaf(sc[i], c, -lse2[(i >> 1) & 1])) : 0.f;  // P
    }
    wgmma_wait<0>();
    fence_operands(dp);
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) sc[i] *= dp[i] - drow[(i >> 1) & 1];  // dS
    unsigned dsa[P::KB][4];
#pragma unroll
    for (int kk = 0; kk < P::KB; ++kk) a_from_d(dsa[kk], sc, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < P::KB; ++kk) Wgmma<32, 1>::rs(acc, dsa[kk], desc_mn(kt, kk), 1);  // dQ / c += dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    release(empty, s);
  }
  store_rows(dq + base, acc, row0, N, scale, g, t);
}

template <class P>
__global__ void __launch_bounds__(P::THREADS, 1)
attention_dkdv_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_do, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ st_lse,
                      const float* __restrict__ st_drow, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int N, int npad, int n_ktiles, float scale) {
  constexpr int BT = P::BT;
  extern __shared__ __align__(16) float smem[];
  uint64_t *full, *empty;
  char* ring = setup_ring<P>(smem, 1, full, empty);
  const int bh = blockIdx.x / n_ktiles;
  const int n_tiles = (N + BT - 1) / BT;

  if (threadIdx.x < 128) {  // producer warpgroup
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 0)
      produce<P>(ring, full, empty, &map_q, &map_do, st_lse + static_cast<size_t>(bh) * npad,
                 st_drow + static_cast<size_t>(bh) * npad, bh, n_tiles);
    return;
  }
  reg_alloc<P::CONSUMER_REGS>();
  const int ct = threadIdx.x - 128, wg = ct >> 7;  // consumer warpgroup
  const int warp = (ct >> 5) & 3, lane = ct & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (blockIdx.x % n_ktiles) * P::BR + wg * 64 + warp * 16;  // a warp's keys
  const size_t base = static_cast<size_t>(bh) * N * D;
  const float c = scale * LOG2E;
  const char* stat_base = ring + STAGES * 2 * P::TILE_BYTES;

  unsigned ka[2][4], va[2][4];
  load_a(ka, k + base, row0, N, g, t);
  load_a(va, v + base, row0, N, g, t);
  float ddk[16], ddv[16];  // dK / c and dV, m64n32
#pragma unroll
  for (int i = 0; i < 16; ++i) ddk[i] = ddv[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    mbar_wait(&full[s], (j / STAGES) & 1);
    const char* qt = ring + s * 2 * P::TILE_BYTES;
    const char* dt = qt + P::TILE_BYTES;
    const float* lt = reinterpret_cast<const float*>(stat_base + s * 2 * P::STAT_BYTES);
    const float* drt = lt + BT;

    float sc[BT / 2], dp[BT / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) Wgmma<BT, 0>::rs(sc, ka[kk], desc_k(qt, kk), kk);  // S^T = K Q^T
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) Wgmma<BT, 0>::rs(dp, va[kk], desc_k(dt, kk), kk);  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(sc);
    // queries of the tile; lse = +inf past N, so P^T = 0 there
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) {
      const int col = 8 * (i >> 2) + 2 * t + (i & 1);
      sc[i] = exp2_approx(fmaf(sc[i], c, -lt[col]));  // P^T
    }
    unsigned pa[P::KB][4];
#pragma unroll
    for (int kk = 0; kk < P::KB; ++kk) a_from_d(pa[kk], sc, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < P::KB; ++kk) Wgmma<32, 1>::rs(ddv, pa[kk], desc_mn(dt, kk), 1);  // dV += P^T dO
    wgmma_commit();
    wgmma_wait<1>();  // dP^T (dV may still run)
    fence_operands(dp);
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) {
      const int col = 8 * (i >> 2) + 2 * t + (i & 1);
      sc[i] *= dp[i] - drt[col];  // dS^T
    }
    unsigned dsa[P::KB][4];
#pragma unroll
    for (int kk = 0; kk < P::KB; ++kk) a_from_d(dsa[kk], sc, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < P::KB; ++kk) Wgmma<32, 1>::rs(ddk, dsa[kk], desc_mn(qt, kk), 1);  // dK / c += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(ddv);
    fence_operands(ddk);
    release(empty, s);
  }
  store_rows(dk + base, ddk, row0, N, scale, g, t);
  store_rows(dv + base, ddv, row0, N, 1.f, g, t);
}

constexpr int MAX_DEVICES = 64;

// the card's SMs, read once per device
int card_sms(int dev, int* sms) {
  static int cached[MAX_DEVICES];
  if (cached[dev] == 0) {
    const int rc = static_cast<int>(
        cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev));
    if (rc != 0) {
      cached[dev] = 0;
      return rc;
    }
  }
  *sms = cached[dev];
  return 0;
}

// the two launches of one plan: the dq pass (which fills the scratch), then
// the dk/dv pass.  The tensor maps hold the tensors' addresses, so they are
// encoded at every call; the kernels' shared-memory limits once per device.
template <class P>
int launch_plan(const void* q, const void* k, const void* v, const void* out, const void* dout,
                const void* lse, void* dq, void* dk, void* dv, float* stats, int BH, int N,
                int npad, float scale, int dev, cudaStream_t stream) {
  static bool attr_set[MAX_DEVICES];
  CUtensorMap map_q, map_k, map_v, map_do;
  int rc = 0;
  const void* srcs[4] = {q, k, v, dout};
  CUtensorMap* maps[4] = {&map_q, &map_k, &map_v, &map_do};
  for (int i = 0; i < 4 && rc == 0; ++i)
    rc = encode_tile_map(maps[i], srcs[i], D, N, BH, P::BT);
  if (rc != 0) return rc;
  constexpr int threads = P::THREADS;
  constexpr size_t dq_smem = P::smem(0), dkdv_smem = P::smem(1);
  const int n_tiles = (N + P::BR - 1) / P::BR;
  float* st_lse = stats;
  float* st_drow = stats + static_cast<size_t>(BH) * npad;
  if (!attr_set[dev]) {
    rc = static_cast<int>(cudaFuncSetAttribute(
        attention_dq_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dq_smem)));
    if (rc == 0)
      rc = static_cast<int>(cudaFuncSetAttribute(
          attention_dkdv_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(dkdv_smem)));
    if (rc != 0) return rc;
    attr_set[dev] = true;
  }
  attention_dq_kernel<P><<<BH * n_tiles, threads, dq_smem, stream>>>(
      map_k, map_v, static_cast<const bf16*>(q), static_cast<const bf16*>(out),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse), static_cast<bf16*>(dq),
      st_lse, st_drow, N, npad, n_tiles, scale);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  attention_dkdv_kernel<P><<<BH * n_tiles, threads, dkdv_smem, stream>>>(
      map_q, map_do, static_cast<const bf16*>(k), static_cast<const bf16*>(v), st_lse, st_drow,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), N, npad, n_tiles, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_variant(const void* q, const void* k, const void* v, const void* out,
                   const void* dout, const void* lse, void* dq, void* dk, void* dv, float* stats,
                   int BH, int N, int npad, float scale, cudaStream_t stream) {
  int dev = 0, sms = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  if (dev < 0 || dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidValue);
  rc = card_sms(dev, &sms);
  if (rc != 0) return rc;
  // the larger CTAs where their grid fills the card four times over
  const long long large_ctas =
      static_cast<long long>(BH) * ((N + LargeGrid::BR - 1) / LargeGrid::BR);
  if (large_ctas >= 4LL * sms)
    return launch_plan<LargeGrid>(q, k, v, out, dout, lse, dq, dk, dv, stats, BH, N, npad, scale,
                                  dev, stream);
  return launch_plan<SmallGrid>(q, k, v, out, dout, lse, dq, dk, dv, stats, BH, N, npad, scale,
                                dev, stream);
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

// two launches: the dq pass (which fills the scratch), then the dk/dv pass
int launch_variant(const void* q, const void* k, const void* v, const void* out,
                   const void* dout, const void* lse, void* dq, void* dk, void* dv, float* stats,
                   int BH, int N, int npad, float scale, cudaStream_t stream) {
  using T = float;
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

#endif

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
  return launch_variant(q, k, v, out, dout, lse, dq, dk, dv, static_cast<float*>(stats), BH, N,
                        npad, scale, static_cast<cudaStream_t>(stream));
}
