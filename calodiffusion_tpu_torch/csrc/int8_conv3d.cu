// W8A8 int8 3D convolution, dequantized, for Hopper (sm_90a): Q1.
//
//   y[n, co, z, a, r] = cast(float(sum_k q(x)[...] wq[co, k]) * s[co] + b[co])
//
// over activations x (B, Cin, Z, A, R) in the build's dtype (bf16 or f32),
// in any strides (NCDHW, or the channels-last view K1 leaves), int8 weights
// wq (Cout, Cin, kz, ka, kr), an f32 per-channel scale s = sw * sx and an
// optional f32 bias b; q(x) = clip(rint(x * inv_sx), -127, 127), round half
// to even.  Stride (sz, sa, sr), zero padding pz on Z and pr on R, and on A
// (phi) either zero padding pa or, cylindrical, a circular wrap by pa.
// Replaces the XLA s8 x s8 -> s32 convolution of
// calodiffusion_tpu/ops/quant.py::int8_conv3d (:173) and the stride-1 core
// of its int8_conv3d_transpose (:205); PyTorch has no int8 conv3d on CUDA.
//
// Bound.  At ds2's largest launch (B = 128 at 45 x 16 x 9, 3x3x3, 32 -> 32)
// the card's memory: 53 MB of bf16 read and 53 MB written (32 us at 3.35
// TB/s) against 45.9 G int8 operations (23 us at 1,979 TOPS).
//
// Design: two kernels behind one entry.
//   1. quantize_pad_kernel quantizes x once, in whatever strides it comes,
//      into xq (B, Zp, Ap, Rp, Cp) int8, channels last: the Z and R pads
//      (and A's, unless cylindrical) zeros, the phi pads the circular wrap,
//      Cin zero-padded to Cp, a multiple of 32.  A thread writes 16
//      channels of one position, one 16-byte store.  The convolution below
//      then does no bounds checks, no wrap and no quantization.
//   2. int8_gemm_kernel, an implicit GEMM over xq with K ordered (dz, da,
//      dr, ci), the order of the weights' image wk (Cout, kz, ka, kr, Cp)
//      that the wrapper caches once a weight version.  Persistent CTAs of
//      two warpgroups, each CTA on one tile of NT (32, 64, 128) output
//      channels whose weights (NT x K) it loads once into shared memory, in
//      K-major rows of 64 bytes with the 64-byte swizzle, and keeps.  M
//      tiles of TM = 128 MW rows, their A double buffered by cp.async:
//      - stride 1 ("window"): a row is a position of the padded grid, and
//        tap (dz, da, dr) of row p reads row p + dz Ap Rp + da Rp + dr of
//        xq, so one window of TM + halo whole rows serves all the taps of
//        a tile; rows that are pads (1.44x the outputs at ds2's level 0)
//        are computed and dropped.  Taken where it reads at most an eighth
//        of the gather's A rows: every 3x3x3 of ds2 (1.15-2.2x faster
//        than the gather at all but one, within 8 % there), not the 2x2x2
//        transpose cores (as fast or slower) or a 1x1x1 (the same work).
//      - other strides, and the rest ("gather"): a row is an output
//        position; each row of kr taps (dz, da) is gathered whole (Cp
//        bytes a row and tap); where the weights do not fit beside it,
//        their slice streams in with it.
//      A k-step is 32 bytes.  A stage of 3 k-steps: ldmatrix gives each
//      warp its 16 x 32 A fragments of each 64-row block (the A ring's
//      32-byte swizzle keeps any starting row free of bank conflicts),
//      then one wgmma m64nNTk32 (s8 in, s32 sums) a k-step and block reads
//      the resident weights through a descriptor; the stage retires before
//      the next defines fragments (ptxas serializes the wgmmas otherwise).
//      A stays in registers because a tap's rows start at any row of the
//      window, not on the 8-row atom that a shared-memory descriptor
//      addresses.  Epilogue: each sum to f32 (round to nearest),
//      __fadd_rn(__fmul_rn(sum, s), b) with no contraction into an FMA, so
//      the f32 output is the plain version's bit for bit; cast to T and
//      stored NCDHW straight from the accumulators, a warp's store 8
//      consecutive positions of 4 channels (staging the tile in shared
//      memory for longer runs measured no faster).  Every |sum| stays
//      below 2^31: |q| <= 127 and K <= 2^17 here.
//
// C entries, for the one dtype variant of the build: calo_int8_conv3d (the
// two kernels) and calo_int8_quantize_pad (the first alone), each returning
// cudaGetLastError(), or cudaErrorInvalidValue for a shape, dtype or plan
// it does not take.

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace calo;

constexpr int THREADS = 256;  // two warpgroups
constexpr int QUANT_THREADS = 256;
constexpr int SMEM_LIMIT = 232448;
constexpr int MAX_K = 1 << 17;
enum Mode { AUTO = 0, WINDOW = 1, GATHER = 2, STREAM = 3 };

struct Conv {
  int B, Cin, Z, A, R, Cout, kz, ka, kr, sz, sa, sr, pz, pa, pr, cyl, Zo, Ao, Ro;
  int Cp, Zp, Ap, Rp;
};

struct Strides {
  long long b, c, z, a, r;
};

// what the GEMM needs of a conv and of its plan
struct Gemm {
  int Cp, S, T, kz, ka, kr, sz, sa, sr, Rp, Ao, Ro, Cout, NN, mode, has_bias;
  int arows;           // rows of a stage's A: TM + halo (window), TM (gather)
  int kpad;            // a resident weight row: K rounded up to 64 bytes
  int apr, so, zapr;   // Ap Rp, Zo Ao Ro, Zp Ap Rp
  int rows;            // rows of xq (positions of the padded grid)
  int M, tiles;        // GEMM rows (up to the last output), their tiles
  int steps;           // k-steps a chunk
  unsigned off_a, a_stage, off_b_stage, off_rows, off_sb, smem;
};

__device__ __forceinline__ unsigned quantize(float v, float inv_sx) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(v, inv_sx)), -127.f), 127.f);
  return static_cast<unsigned>(static_cast<int>(q)) & 0xffu;
}

// x quantized into xq, 16 channels (one 16-byte store) a thread.  With CP
// (32, 64 or 128) known, a block holds CP / 16 groups of consecutive
// positions, one group of channels each, so that a warp reads 32
// consecutive positions of one channel a load; with CP 0, c.Cp, a thread
// takes all the channels of one position
template <typename T, int CP>
__global__ void __launch_bounds__(QUANT_THREADS)
    quantize_pad_kernel(const T* __restrict__ x, Strides st, signed char* __restrict__ xq,
                        Conv c, float inv_sx, int positions) {
  constexpr int PB = CP ? QUANT_THREADS / (CP / 16) : QUANT_THREADS;  // positions a block
  const int cp = CP ? CP : c.Cp;
  for (int p0 = blockIdx.x * PB; p0 < positions; p0 += gridDim.x * PB) {
    const int p = p0 + threadIdx.x % PB;
    if (p >= positions) continue;
    const int rp = p % c.Rp, ap = p / c.Rp % c.Ap, plane = p / (c.Rp * c.Ap);
    const int zp = plane % c.Zp, b = plane / c.Zp;
    const int zi = zp - c.pz, ri = rp - c.pr;
    int ai = ap - c.pa;
    if (c.cyl) ai = ai < 0 ? ai + c.A : (ai >= c.A ? ai - c.A : ai);
    const bool in = zi >= 0 && zi < c.Z && ai >= 0 && ai < c.A && ri >= 0 && ri < c.R;
    const T* px = x + b * st.b + zi * st.z + ai * st.a + ri * st.r;
    uint4* out = reinterpret_cast<uint4*>(xq + static_cast<long long>(p) * cp);
    auto sixteen = [&](int c0) {  // channels c0 .. c0 + 15, one 16-byte store
      float v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = in && c0 + j < c.Cin ? to_f<T>(px[(c0 + j) * st.c]) : 0.f;
      unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 16; ++j) w[j >> 2] |= quantize(v[j], inv_sx) << (8 * (j & 3));
      out[c0 / 16] = make_uint4(w[0], w[1], w[2], w[3]);
    };
    if (CP) {
      sixteen(threadIdx.x / PB * 16);
    } else {
      for (int c0 = 0; c0 < cp; c0 += 16) sixteen(c0);
    }
  }
}

// k-steps a wgmma stage: their A fragments all load before it starts, so
// that no fragment is defined while a wgmma of the warpgroup is in flight
// (ptxas serializes the wgmmas otherwise)
constexpr int KB = 3;

// STREAMED: each chunk's slice of the weights arrives with its rows (gather
// plans whose weights do not fit beside the A stages)
template <typename T, int NT, int MW, bool STREAMED>
__global__ void __launch_bounds__(THREADS, 2)
    int8_gemm_kernel(const signed char* __restrict__ xq, const signed char* __restrict__ wk,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     T* __restrict__ y, Gemm g) {
  constexpr int TM = 128 * MW;
  extern __shared__ __align__(16) float smem[];
  char* base = align_smem_1024(smem);
  char* sB = base;  // resident weights: K / 64 slabs of NT rows of 64 bytes
  char* sA = base + g.off_a;
  int* rowtab = reinterpret_cast<int*>(base + g.off_rows);  // two tiles' row offsets
  float* s_scale = reinterpret_cast<float*>(base + g.off_sb);
  float* s_bias = s_scale + NT;
  int2* ktab = reinterpret_cast<int2*>(s_bias + NT);  // a chunk's k-steps: A slab, row shift

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int n0 = static_cast<int>(blockIdx.x % g.NN) * NT;
  const int cta = blockIdx.x / g.NN, ctas = gridDim.x / g.NN;
  const int K = g.T * g.Cp;
  const bool window = g.mode == WINDOW;
  // A loads a tile: one window, or each (dz, da) row of kr taps, gathered
  const int chunks = window ? 1 : g.kz * g.ka;
  const int steps = window ? g.T * g.S : g.kr * g.S;  // k-steps a chunk
  const int tiles = g.tiles > cta ? (g.tiles - 1 - cta) / ctas + 1 : 0;  // this CTA's
  const int items = tiles * chunks;

  // 16-byte pieces of the weights' rows n0.. at byte k0 of K, kbytes long,
  // into 64-byte swizzled rows at dst; zeros past Cout and past K
  auto load_weights = [&](char* dst, int k0, int kbytes) {
    const int per = kbytes / 16;
    for (int i = tid; i < NT * per; i += THREADS) {
      const int n = i / per, kb = (i - n * per) * 16;
      const bool full = n0 + n < g.Cout && k0 + kb < K;
      cp_async16(dst + swizzle64((kb >> 6) * (NT * 64) + n * 64 + (kb & 63)),
                 full ? wk + static_cast<long long>(n0 + n) * K + k0 + kb : wk, full);
    }
  };
  if (!STREAMED) load_weights(sB, 0, g.kpad);
  for (int i = tid; i < NT; i += THREADS) {
    const bool in = n0 + i < g.Cout;
    s_scale[i] = in ? scale[n0 + i] : 0.f;
    s_bias[i] = in && bias != nullptr ? bias[n0 + i] : 0.f;
  }
  // k-step (tap t, slab s) of a chunk: window: A slab s at the tap's row
  // shift; gather: the slab of tap dr = t, unshifted
  for (int i = tid; i < steps; i += THREADS) {
    const int t = i / g.S, s = i - t * g.S;
    ktab[i] = window ? make_int2(s * g.arows * 32,
                                 t / (g.ka * g.kr) * g.apr + t / g.kr % g.ka * g.Rp + t % g.kr)
                     : make_int2(i * TM * 32, 0);
  }

  // item q (a tile's window, or a row of taps of a tile) into stage q & 1
  auto issue = [&](int q) {
    const int tile = cta + q / chunks * ctas;
    char* buf = sA + (q & 1) * g.a_stage;
    const int half = tid & 1;
    if (window) {
      for (int r = tid >> 1; r < g.arows; r += THREADS / 2) {
        const int row = tile * TM + r;
        const bool full = row < g.rows;
        const signed char* src = xq + static_cast<long long>(full ? row : 0) * g.Cp + 16 * half;
        for (int s = 0; s < g.S; ++s)
          cp_async16(buf + s * g.arows * 32 + ring32_offset(r, half), src + 32 * s, full);
      }
      return;
    }
    const int chunk = q % chunks, dz = chunk / g.ka, da = chunk % g.ka;
    for (int r = tid >> 1; r < TM; r += THREADS / 2) {
      const int m = tile * TM + r;
      const bool full = m < g.M;
      int row = 0;
      if (full) {
        const int b = m / g.so, s = m - b * g.so;
        const int ro = s % g.Ro, ao = s / g.Ro % g.Ao, zo = s / (g.Ro * g.Ao);
        row = b * g.zapr + (zo * g.sz + dz) * g.apr + (ao * g.sa + da) * g.Rp + ro * g.sr;
      }
      for (int dr = 0; dr < g.kr; ++dr) {
        const signed char* src = xq + static_cast<long long>(row + dr) * g.Cp + 16 * half;
        for (int s = 0; s < g.S; ++s)
          cp_async16(buf + (dr * g.S + s) * TM * 32 + ring32_offset(r, half), src + 32 * s,
                     full);
      }
    }
    if (STREAMED) load_weights(buf + g.off_b_stage, chunk * g.kr * g.Cp, g.kr * g.Cp);
  };

  int acc[MW][NT / 2];
  // this lane's row of a 16-row ldmatrix block and its half of the k-step
  const int lrow = wg * 64 * MW + 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int lhalf = lane >> 4;
  const uint64_t desc0 = smem_desc(sB, 16, 512);
  // N k-steps from k-step i of a chunk in stage buf, k-step kbase + i of
  // the weights at wdesc: each 64-row block's A fragments by ldmatrix from
  // the A ring, then the wgmmas, retired before the next stage
  auto stage = [&](auto n, const char* buf, int i, int kbase, uint64_t wdesc) {
    constexpr int N = decltype(n)::value;
    unsigned a[N][MW][4];
    uint64_t db[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int2 e = ktab[i + k];
#pragma unroll
      for (int mw = 0; mw < MW; ++mw)
        ldmatrix_x4(a[k][mw], buf + e.x + ring32_offset(lrow + 64 * mw + e.y, lhalf));
      // slab ks / 2 of the weights, bytes 32 (ks & 1) of its rows, in 16-byte units
      const int ks = kbase + i + k;
      db[k] = wdesc + static_cast<uint64_t>((ks >> 1) * (NT * 4) + 2 * (ks & 1));
      asm volatile("" : "+l"(db[k]));  // defined before the stage starts
    }
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < N; ++k)
#pragma unroll
      for (int mw = 0; mw < MW; ++mw) WgmmaS8<NT>::rs(acc[mw], a[k][mw], db[k], 1);
    wgmma_commit();
    wgmma_wait<0>();
  };

  // each row's output offset (channel 0) of tile t, -1 where it is no output
  auto fill_rows = [&](int t, int* rows) {
    for (int r = tid; r < TM; r += THREADS) {
      const int p = t * TM + r;
      int o = -1;
      if (p < g.M && window) {
        const int b = p / g.zapr, rem = p - b * g.zapr;
        const int zp = rem / g.apr, ap = rem % g.apr / g.Rp, rp = rem % g.Rp;
        if (ap < g.Ao && rp < g.Ro && zp * g.Ao * g.Ro < g.so)
          o = b * g.Cout * g.so + (zp * g.Ao + ap) * g.Ro + rp;
      } else if (p < g.M) {
        const int b = p / g.so;
        o = b * g.Cout * g.so + (p - b * g.so);
      }
      rows[r] = o;
    }
  };

  if (items > 0) {
    issue(0);
    fill_rows(cta, rowtab);
  }
  cp_async_commit();
  for (int j = 0, q = 0; j < tiles; ++j) {
    const int tile = cta + j * ctas;
#pragma unroll
    for (int mw = 0; mw < MW; ++mw)
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) acc[mw][i] = 0;
    for (int chunk = 0; chunk < chunks; ++chunk, ++q) {
      cp_async_wait<0>();
      __syncthreads();  // item q landed; item q - 1's stage and the last epilogue are done with
      if (q + 1 < items) issue(q + 1);
      cp_async_commit();

      // the next tile's row offsets, read in its epilogue, past a barrier
      if (chunk == 0 && j + 1 < tiles) fill_rows(tile + ctas, rowtab + ((j + 1) & 1) * TM);

      const char* buf = sA + (q & 1) * g.a_stage;
      // the weights' k-step of the chunk's first: the row's first tap where
      // gathered from the resident weights, else 0
      const uint64_t wdesc = STREAMED ? smem_desc(buf + g.off_b_stage, 16, 512) : desc0;
      const int kbase = STREAMED || window ? 0 : chunk * g.kr * g.S;
      int i = 0;
      for (; i + KB <= steps; i += KB)
        stage(std::integral_constant<int, KB>{}, buf, i, kbase, wdesc);
      for (; i < steps; ++i) stage(std::integral_constant<int, 1>{}, buf, i, kbase, wdesc);
    }

    // epilogue (every wgmma retired): f32 sum * s + b, rounded once to T,
    // stored NCDHW from the accumulators: a warp's store is 8 consecutive
    // positions of each of 4 channels
    const int* rows = rowtab + (j & 1) * TM;
    const int g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int mw = 0; mw < MW; ++mw) {
      fence_operands(acc[mw]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = rows[wg * 64 * MW + 64 * mw + 16 * warp + g8 + 8 * h];
        if (o < 0) continue;
#pragma unroll
        for (int i = 0; i < NT / 2; ++i) {
          const int col = 8 * (i >> 2) + 2 * t4 + (i & 1);
          if (((i >> 1) & 1) != h || n0 + col >= g.Cout) continue;  // row g8 + 8 h's
          const float v = __fmul_rn(static_cast<float>(acc[mw][i]), s_scale[col]);
          y[o + static_cast<long long>(n0 + col) * g.so] =
              from_f<T>(g.has_bias ? __fadd_rn(v, s_bias[col]) : v);
        }
      }
    }
  }
  cp_async_wait<0>();
}

unsigned round_up(unsigned v, unsigned m) { return (v + m - 1) / m * m; }

// the shared-memory layout of a plan; false where it does not fit
bool lay_out(Gemm& g, int NT, int MW) {
  const int TM = 128 * MW;
  const unsigned b_bytes = g.mode == STREAM ? 0u : static_cast<unsigned>(NT) * g.kpad;
  unsigned a = static_cast<unsigned>(g.mode == WINDOW ? g.S : g.kr * g.S) * g.arows * 32;
  g.off_b_stage = round_up(a, 1024);
  if (g.mode == STREAM)  // a row of kr taps' weights
    a = g.off_b_stage + static_cast<unsigned>(NT) * ((g.kr * g.S + 1) / 2) * 64;
  g.a_stage = round_up(a, 1024);
  g.off_a = b_bytes;
  g.off_rows = g.off_a + 2 * g.a_stage;
  g.off_sb = g.off_rows + 2 * TM * 4;
  g.smem = 1024 + g.off_sb + 2 * NT * 4 + 8 * g.steps;  // scale, bias, the k-step table
  return g.smem <= static_cast<unsigned>(SMEM_LIMIT);
}

template <typename T, int NT, int MW, bool STREAMED = false>
int launch_gemm(const signed char* xq, const signed char* wk, const float* scale,
                const float* bias, T* y, const Gemm& g, int sms, cudaStream_t stream) {
  auto kernel = int8_gemm_kernel<T, NT, MW, STREAMED>;
  const int smem = static_cast<int>(g.smem);
  // CTAs an SM at this shared memory, asked once a device and size: the
  // host's time is what a sampling step's small convolutions wait on
  struct Occupancy {
    int device = -1, smem = -1, per_sm = 0;
  };
  static thread_local Occupancy last;
  int device = 0;
  cudaGetDevice(&device);
  if (last.device != device || last.smem != smem) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&last.per_sm, kernel, THREADS, smem);
    last.device = device;
    last.smem = smem;
  }
  const int per_sm = last.per_sm;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // persistent: as many CTAs as the card holds at once, each channel tile alike
  const int per_n = std::min(g.tiles, std::max(1, per_sm * sms / g.NN));
  const int grid = per_n * g.NN;
  kernel<<<grid, THREADS, smem, stream>>>(xq, wk, scale, bias, y, g);
  return cudaGetLastError();
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <typename T>
int quantize_pad(const T* x, const Strides& st, signed char* xq, const Conv& c, float inv_sx,
                 cudaStream_t stream) {
  const int positions = c.B * c.Zp * c.Ap * c.Rp;
  const int per_block = c.Cp <= 128 && (c.Cp & (c.Cp - 1)) == 0 ? QUANT_THREADS * 16 / c.Cp
                                                                 : QUANT_THREADS;
  const int qgrid =
      std::min((positions + per_block - 1) / per_block, 32 * std::max(1, sm_count()));
  auto run = [&](auto kernel) {
    kernel<<<qgrid, QUANT_THREADS, 0, stream>>>(x, st, xq, c, inv_sx, positions);
    return cudaGetLastError();
  };
  if (c.Cp == 32) return run(quantize_pad_kernel<T, 32>);
  if (c.Cp == 64) return run(quantize_pad_kernel<T, 64>);
  if (c.Cp == 128) return run(quantize_pad_kernel<T, 128>);
  return run(quantize_pad_kernel<T, 0>);
}

// the GEMM's plan for a convolution, by shape (or forced): g filled for
// its mode, channel tile NT and row tiles MW; false where none fits
bool choose_plan(Gemm& g, const Conv& c, int force, int sms, int& NT_out, int& MW_out) {
  g = Gemm{};
  g.Cp = c.Cp;
  g.S = c.Cp / 32;
  g.T = c.kz * c.ka * c.kr;
  g.kz = c.kz;
  g.ka = c.ka;
  g.kr = c.kr;
  g.sz = c.sz;
  g.sa = c.sa;
  g.sr = c.sr;
  g.Rp = c.Rp;
  g.Ao = c.Ao;
  g.Ro = c.Ro;
  g.Cout = c.Cout;
  g.kpad = static_cast<int>(round_up(static_cast<unsigned>(g.T * c.Cp), 64));
  g.apr = c.Ap * c.Rp;
  g.so = c.Zo * c.Ao * c.Ro;
  g.zapr = c.Zp * g.apr;
  g.rows = c.B * g.zapr;
  const bool unit = c.sz == 1 && c.sa == 1 && c.sr == 1;
  const int halo = (c.kz - 1) * g.apr + (c.ka - 1) * c.Rp + (c.kr - 1);
  if (force == WINDOW && !unit) return false;

  // the window where the stride allows and it reads at most an eighth of
  // the gather's A rows (TM + halo a tile against T TM), else the gather;
  // the widest channel tile whose weights fit resident; 256-row tiles where
  // there are enough; else the gather with the weights streamed, 32
  // channels and 128 rows
  auto plan = [&](int mode, int NT, int MW) {
    if (mode == WINDOW && force == AUTO && 1LL * g.T * 128 * MW < 8LL * (128 * MW + halo))
      return false;
    g.mode = mode;
    g.NN = (c.Cout + NT - 1) / NT;
    g.M = mode == WINDOW ? g.rows - halo : c.B * g.so;
    g.tiles = (g.M + 128 * MW - 1) / (128 * MW);
    g.arows = mode == WINDOW ? 128 * MW + halo : 128 * MW;
    g.steps = mode == WINDOW ? g.T * g.S : c.kr * g.S;
    return (MW == 1 || 1LL * g.tiles * g.NN >= 4LL * sms) && lay_out(g, NT, MW);
  };
  const int widest = c.Cout <= 32 ? 32 : (c.Cout <= 64 ? 64 : 128);
  for (int mode = WINDOW; mode <= GATHER; ++mode) {
    if ((mode == WINDOW && !unit) || (force != AUTO && mode != force)) continue;
    for (int NT = widest; NT >= 32; NT /= 2)
      for (int MW = NT <= 64 ? 2 : 1; MW >= 1; --MW)
        if (plan(mode, NT, MW)) {
          NT_out = NT;
          MW_out = MW;
          return true;
        }
  }
  NT_out = 32;
  MW_out = 1;
  return (force == AUTO || force == STREAM) && plan(STREAM, 32, 1);
}

// the GEMM over xq: its plan, launched
template <typename T>
int gemm(const signed char* xq, const signed char* wk, const float* scale, const float* bias,
         T* y, const Conv& c, int force, cudaStream_t stream) {
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidValue;
  Gemm g{};
  int NT = 0, MW = 0;
  if (!choose_plan(g, c, force, sms, NT, MW))
    return cudaErrorInvalidValue;  // no plan fits in shared memory
  g.has_bias = bias != nullptr;
  if (g.mode == STREAM) return launch_gemm<T, 32, 1, true>(xq, wk, scale, bias, y, g, sms, stream);
  if (NT == 128) return launch_gemm<T, 128, 1>(xq, wk, scale, bias, y, g, sms, stream);
  if (NT == 64)
    return MW == 2 ? launch_gemm<T, 64, 2>(xq, wk, scale, bias, y, g, sms, stream)
                   : launch_gemm<T, 64, 1>(xq, wk, scale, bias, y, g, sms, stream);
  return MW == 2 ? launch_gemm<T, 32, 2>(xq, wk, scale, bias, y, g, sms, stream)
                 : launch_gemm<T, 32, 1>(xq, wk, scale, bias, y, g, sms, stream);
}

bool make_conv(Conv& c) {
  const int dims[] = {c.B, c.Cin, c.Z, c.A, c.R, c.Cout, c.kz, c.ka, c.kr, c.sz, c.sa, c.sr};
  for (int d : dims)
    if (d < 1) return false;
  if (c.pz < 0 || c.pa < 0 || c.pr < 0 || (c.cyl && c.pa > c.A)) return false;
  if (c.Zo != (c.Z + 2 * c.pz - c.kz) / c.sz + 1 || c.Ao != (c.A + 2 * c.pa - c.ka) / c.sa + 1 ||
      c.Ro != (c.R + 2 * c.pr - c.kr) / c.sr + 1 || c.Zo < 1 || c.Ao < 1 || c.Ro < 1)
    return false;
  c.Cp = (c.Cin + 31) / 32 * 32;
  c.Zp = c.Z + 2 * c.pz;
  c.Ap = c.A + 2 * c.pa;
  c.Rp = c.R + 2 * c.pr;
  if (1LL * c.Cp * c.kz * c.ka * c.kr > MAX_K) return false;
  // output offsets and xq's rows as 32-bit ints in the GEMM
  if (1LL * c.B * c.Cout * c.Zo * c.Ao * c.Ro >= (1LL << 31)) return false;
  return 1LL * c.B * c.Zp * c.Ap * c.Rp < (1LL << 31);
}

}  // namespace

// x in any strides (in elements); xq the caller's scratch of B Zp Ap Rp Cp
// bytes; wk the weights (Cout, kz, ka, kr, Cp) int8;
// force a plan's mode (0: by shape; 1 window, 2 gather, 3 gather with the
// weights streamed)
extern "C" int calo_int8_conv3d(const void* x, long long xs_b, long long xs_c, long long xs_z,
                                long long xs_a, long long xs_r, void* xq, const void* wk,
                                const void* scale, const void* bias, void* y, int B, int Cin,
                                int Z, int A, int R, int Cout, int kz, int ka, int kr, int sz,
                                int sa, int sr, int pz, int pa, int pr, int cyl, int Zo, int Ao,
                                int Ro, float inv_sx, int force, int is_bf16, void* stream) {
  if (!is_dtype_variant(is_bf16) || force < AUTO || force > STREAM) return cudaErrorInvalidValue;
  Conv c{B, Cin, Z, A, R, Cout, kz, ka, kr, sz, sa, sr, pz, pa, pr, cyl, Zo, Ao, Ro, 0, 0, 0, 0};
  if (!make_conv(c)) return cudaErrorInvalidValue;
  if (xs_b < 0 || xs_c < 0 || xs_z < 0 || xs_a < 0 || xs_r < 0) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(xq) | reinterpret_cast<uintptr_t>(wk)) & 15)
    return cudaErrorInvalidValue;  // 16-byte copies
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = quantize_pad<VariantT>(static_cast<const VariantT*>(x),
                                        Strides{xs_b, xs_c, xs_z, xs_a, xs_r},
                                        static_cast<signed char*>(xq), c, inv_sx, s);
  if (rc != cudaSuccess) return rc;
  return gemm<VariantT>(static_cast<const signed char*>(xq), static_cast<const signed char*>(wk),
                        static_cast<const float*>(scale), static_cast<const float*>(bias),
                        static_cast<VariantT*>(y), c, force, s);
}

// the quantize pass alone: xq of calo_int8_conv3d, for tests and timing
extern "C" int calo_int8_quantize_pad(const void* x, long long xs_b, long long xs_c,
                                      long long xs_z, long long xs_a, long long xs_r, void* xq,
                                      int B, int Cin, int Z, int A, int R, int pz, int pa, int pr,
                                      int cyl, float inv_sx, int is_bf16, void* stream) {
  if (!is_dtype_variant(is_bf16)) return cudaErrorInvalidValue;
  // a 1x1x1 conv's geometry on the padded grid: the checks of make_conv
  Conv c{B, Cin, Z, A, R, 1, 1, 1, 1, 1, 1, 1, pz, pa, pr, cyl,
         Z + 2 * pz, A + 2 * pa, R + 2 * pr, 0, 0, 0, 0};
  if (!make_conv(c) || xs_b < 0 || xs_c < 0 || xs_z < 0 || xs_a < 0 || xs_r < 0 ||
      (reinterpret_cast<uintptr_t>(xq) & 15))
    return cudaErrorInvalidValue;
  return quantize_pad<VariantT>(static_cast<const VariantT*>(x),
                                Strides{xs_b, xs_c, xs_z, xs_a, xs_r},
                                static_cast<signed char*>(xq), c, inv_sx,
                                static_cast<cudaStream_t>(stream));
}

// the GEMM's plan for a convolution on the current device, launching
// nothing: out[0] the mode (1 window, 2 gather, 3 gather with the weights
// streamed), out[1] the channel tile, out[2] the row tiles of 128 a CTA
// takes, out[3] its shared-memory bytes; force as in calo_int8_conv3d
extern "C" int calo_int8_conv3d_plan(int B, int Cin, int Z, int A, int R, int Cout, int kz,
                                     int ka, int kr, int sz, int sa, int sr, int pz, int pa,
                                     int pr, int cyl, int Zo, int Ao, int Ro, int force,
                                     int* out) {
  if (force < AUTO || force > STREAM) return cudaErrorInvalidValue;
  Conv c{B, Cin, Z, A, R, Cout, kz, ka, kr, sz, sa, sr, pz, pa, pr, cyl, Zo, Ao, Ro, 0, 0, 0, 0};
  if (!make_conv(c)) return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidValue;
  Gemm g{};
  int NT = 0, MW = 0;
  if (!choose_plan(g, c, force, sms, NT, MW)) return cudaErrorInvalidValue;
  out[0] = g.mode;
  out[1] = NT;
  out[2] = MW;
  out[3] = static_cast<int>(g.smem);
  return cudaSuccess;
}
