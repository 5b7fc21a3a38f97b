// W8A8 int8 3D convolution, dequantized, for Hopper (sm_90a): Q1.
//
//   y[n, co, z, a, r] = cast(float(sum_k q(x)[...] wq[co, k]) * s[co] + b[co])
//
// over NCDHW activations x (B, Cin, Z, A, R) in the build's dtype (bf16 or
// f32), int8 weights wq (Cout, Cin, kz, ka, kr), an f32 per-channel scale
// s = sw * sx and an optional f32 bias b; q(x) = clip(rint(x * inv_sx),
// -127, 127), round half to even.  Stride (sz, sa, sr), zero padding pz on
// Z and pr on R, and on A (phi) either zero padding pa or, cylindrical, a
// circular wrap by pa.  Replaces the XLA s8 x s8 -> s32 convolution of
// calodiffusion_tpu/ops/quant.py::int8_conv3d (and the stride-1 core of
// int8_conv3d_transpose); PyTorch has no int8 conv3d on CUDA.
//
// Bound.  At ds2's largest launch (B = 128 at 45 x 16 x 9, 3x3x3, 32 -> 32)
// the card's memory: 53 MB of bf16 read and 53 MB written (32 us at 3.35
// TB/s) against 45.9 G int8 operations (23 us at 1,979 TOPS).
//
// Design: an implicit GEMM, simple and exact, not yet fast.  M = B Zo Ao Ro
// output positions, N = Cout, K = Cin kz ka kr in the weights' own order.
// A CTA of 4 warps takes 128 positions and 32 channels and walks K in steps
// of 32: 32 threads decode the step's k into (ci, dz, da, dr), then each
// thread gathers its position's 32 values of x, quantizes each as it lands
// (the pads and the phi wrap are folded into the index: no padded or int8
// copy of x is written) and stores them as one 32-byte row of the A tile in
// shared memory; the threads load the 32 x 32 int8 B tile beside it.  Each
// warp then runs 8 mma.sync m16n8k32 (s8 inputs, s32 sums) on its 32 x 32
// corner.  The epilogue converts each sum to f32 (round to nearest), takes
// __fadd_rn(__fmul_rn(sum, s), b) with no contraction into an FMA, so the
// f32 output is the plain version's bit for bit, and stores NCDHW.  Every
// |sum| stays below 2^31: |q| <= 127 and K <= 2^17 here.  wgmma, TMA,
// channels-last activations and a quantized copy of x shared across the 27
// taps are later work.
//
// C entry, for the one dtype variant of the build: calo_int8_conv3d
// (returns cudaGetLastError(), or cudaErrorInvalidValue for a shape or
// dtype it does not take).

#include "common.cuh"

namespace {

using namespace calo;

constexpr int BM = 128;      // output positions a CTA: one a thread
constexpr int BN = 32;       // output channels a CTA
constexpr int BK = 32;       // reduction bytes a step: one m16n8k32
constexpr int THREADS = 128;  // 4 warps, each 32 positions x 32 channels
constexpr int LDS = 48;      // bytes between tile rows: 32 + 16, so the 8 rows a
                             // fragment load reads fall on distinct banks
constexpr int SMEM_BYTES = (BM + BN) * LDS + 4 * BK * 4;
constexpr int MAX_K = 1 << 17;

struct Conv {
  int B, Cin, Z, A, R, Cout, kz, ka, kr, sz, sa, sr, pz, pa, pr, cyl, Zo, Ao, Ro;
};

__device__ __forceinline__ unsigned quantize(float v, float inv_sx) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(v, inv_sx)), -127.f), 127.f);
  return static_cast<unsigned>(static_cast<int>(q)) & 0xffu;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    int8_conv3d_kernel(const T* __restrict__ x, const signed char* __restrict__ wq,
                       const float* __restrict__ scale, const float* __restrict__ bias,
                       T* __restrict__ y, Conv c, float inv_sx, int n_tiles) {
  extern __shared__ __align__(16) float smem[];
  unsigned char* sA = reinterpret_cast<unsigned char*>(smem);
  unsigned char* sB = sA + BM * LDS;
  int* table = reinterpret_cast<int*>(sB + BN * LDS);  // 4 ints a k of the step

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const long long m0 = static_cast<long long>(blockIdx.x / n_tiles) * BM;
  const int kvol = c.kz * c.ka * c.kr, K = c.Cin * kvol;
  const long long S = static_cast<long long>(c.Zo) * c.Ao * c.Ro, M = S * c.B;
  const long long zar = static_cast<long long>(c.Z) * c.A * c.R;

  // this thread's output position, the row of the A tile it gathers
  const long long m = m0 + tid;
  const bool row_ok = m < M;
  long long xb = 0;
  int zi0 = 0, ai0 = 0, ri0 = 0;
  if (row_ok) {
    const long long b = m / S;
    const int s = static_cast<int>(m - b * S);
    const int ro = s % c.Ro, ao = (s / c.Ro) % c.Ao, zo = s / (c.Ro * c.Ao);
    xb = b * c.Cin * zar;
    zi0 = zo * c.sz - c.pz;
    ai0 = ao * c.sa - c.pa;
    ri0 = ro * c.sr - c.pr;
  }

  int acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    if (tid < BK) {  // the step's k -> (ci, dz, da, dr); ci -1 past K
      const int k = k0 + tid;
      int e[4] = {-1, 0, 0, 0};
      if (k < K) {
        const int ci = k / kvol;
        int r = k - ci * kvol;
        e[0] = ci;
        e[1] = r / (c.ka * c.kr);
        r -= e[1] * c.ka * c.kr;
        e[2] = r / c.kr;
        e[3] = r - e[2] * c.kr;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) table[4 * tid + i] = e[i];
    }
    __syncthreads();

    // A: this position's 32 values, quantized, 4 to a word (lowest k low)
    unsigned words[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      unsigned w = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int* e = table + 4 * (4 * j + i);
        unsigned q = 0;
        const int zi = zi0 + e[1], ri = ri0 + e[3];
        int ai = ai0 + e[2];
        if (c.cyl) ai = ai < 0 ? ai + c.A : (ai >= c.A ? ai - c.A : ai);
        if (row_ok && e[0] >= 0 && zi >= 0 && zi < c.Z && ai >= 0 && ai < c.A && ri >= 0 &&
            ri < c.R) {
          const long long off =
              xb + e[0] * zar + (static_cast<long long>(zi) * c.A + ai) * c.R + ri;
          q = quantize(to_f<T>(x[off]), inv_sx);
        }
        w |= q << (8 * i);
      }
      words[j] = w;
    }
    uint4* rowA = reinterpret_cast<uint4*>(sA + tid * LDS);
    rowA[0] = make_uint4(words[0], words[1], words[2], words[3]);
    rowA[1] = make_uint4(words[4], words[5], words[6], words[7]);

    // B: channel n0 + tid / 4, bytes 8 (tid % 4) .. + 7 of the step
    {
      const int n = tid >> 2, kb = (tid & 3) * 8, co = n0 + n;
      unsigned w2[2] = {0u, 0u};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = k0 + kb + i;
        const unsigned v = (co < c.Cout && k < K)
                               ? static_cast<unsigned>(static_cast<unsigned char>(
                                     wq[static_cast<long long>(co) * K + k]))
                               : 0u;
        w2[i >> 2] |= v << (8 * (i & 3));
      }
      unsigned* rowB = reinterpret_cast<unsigned*>(sB + n * LDS + kb);
      rowB[0] = w2[0];
      rowB[1] = w2[1];
    }
    __syncthreads();

    unsigned bf[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const unsigned char* p = sB + (nt * 8 + g) * LDS + 4 * t;
      bf[nt][0] = *reinterpret_cast<const unsigned*>(p);
      bf[nt][1] = *reinterpret_cast<const unsigned*>(p + 16);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      unsigned af[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = warp * 32 + mt * 16 + g + 8 * (r & 1);
        af[r] = *reinterpret_cast<const unsigned*>(sA + row * LDS + 4 * t + 16 * (r >> 1));
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_s8_16832(acc[mt][nt], af, bf[nt][0], bf[nt][1]);
    }
  }

  // epilogue: f32 sum * s + b, rounded once to T, stored NCDHW
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = m0 + warp * 32 + mt * 16 + g + 8 * h;
      if (row >= M) continue;
      const long long b = row / S, s = row - b * S;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int co = n0 + nt * 8 + 2 * t + i;
          if (co >= c.Cout) continue;
          float v = __fmul_rn(static_cast<float>(acc[mt][nt][2 * h + i]), scale[co]);
          if (bias != nullptr) v = __fadd_rn(v, bias[co]);
          y[(b * c.Cout + co) * S + s] = from_f<T>(v);
        }
    }
}

}  // namespace

extern "C" int calo_int8_conv3d(const void* x, const void* wq, const void* scale,
                                const void* bias, void* y, int B, int Cin, int Z, int A, int R,
                                int Cout, int kz, int ka, int kr, int sz, int sa, int sr, int pz,
                                int pa, int pr, int cyl, int Zo, int Ao, int Ro, float inv_sx,
                                int is_bf16, void* stream) {
  if (!is_dtype_variant(is_bf16)) return cudaErrorInvalidValue;
  const Conv c{B, Cin, Z, A, R, Cout, kz, ka, kr, sz, sa, sr, pz, pa, pr, cyl, Zo, Ao, Ro};
  const int dims[] = {B, Cin, Z, A, R, Cout, kz, ka, kr, sz, sa, sr};
  for (int d : dims)
    if (d < 1) return cudaErrorInvalidValue;
  if (pz < 0 || pa < 0 || pr < 0 || (cyl && pa > A)) return cudaErrorInvalidValue;
  if (Zo != (Z + 2 * pz - kz) / sz + 1 || Ao != (A + 2 * pa - ka) / sa + 1 ||
      Ro != (R + 2 * pr - kr) / sr + 1 || Zo < 1 || Ao < 1 || Ro < 1)
    return cudaErrorInvalidValue;
  if (static_cast<long long>(Cin) * kz * ka * kr > MAX_K) return cudaErrorInvalidValue;
  const long long M = static_cast<long long>(B) * Zo * Ao * Ro;
  const int n_tiles = (Cout + BN - 1) / BN;
  const long long blocks = (M + BM - 1) / BM * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(blocks);
  const VariantT* xt = static_cast<const VariantT*>(x);
  const signed char* wt = static_cast<const signed char*>(wq);
  const float* st = static_cast<const float*>(scale);
  const float* bt = static_cast<const float*>(bias);
  VariantT* yt = static_cast<VariantT*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_conv3d_kernel<VariantT><<<grid, THREADS, SMEM_BYTES, s>>>(xt, wt, st, bt, yt, c, inv_sx,
                                                                 n_tiles);
  return cudaGetLastError();
}
