// GroupNorm(G) with its per-channel affine and an optional SiLU, forward,
// for Hopper (sm_90a).
//
//   y = (x - mean_g) rsqrt(var_g + eps) scale_c + bias_c,  out = y sigmoid(y)
//
// over channels-last x (B, S, C): the statistics of group g are taken per
// sample over its S positions and C/G channels.  C and G at run time, C at
// most 384, divisible by G and by the 16-byte vector (8 bf16 or 4 f32
// channels).  Replaces the Pallas kernel
// calodiffusion_tpu/ops/pallas_groupnorm.py::_gn_silu_kernel (entry
// groupnorm_silu).  Forward only, as in the JAX package.
//
// Bound.  The card's memory: x read once and out written once (2 B S C
// elements), against ~10 FLOPs and one exponential an element.
//
// Design.  The TPU kernel holds a sample's (S, C) slab in VMEM and takes its
// variance in one pass, E[x^2] - mean^2.  No SM holds a ds3 sample (40,500 x
// 32 values), and one block a sample would leave most of the 132 SMs idle at
// B = 64, so each sample is cut into chunks of rows, and three launches
// follow each other:
//   1. statistics, one CTA a (sample, chunk): the CTA loads its chunk into
//      registers as 16-byte vectors (thread t keeps vector column t mod
//      C/V, so a warp reads consecutive addresses), takes each group's mean
//      over the chunk, then the centred sum of squares M2 around it from the
//      same registers (two-pass within the chunk: no cancellation), and
//      writes (mean, M2) per group to an f32 scratch (B, chunks, G, 2).
//      Where a warp holds whole rows (C/V divides 32) the rows' sums meet
//      by shuffles before shared memory.
//   2. merge, one CTA a sample: the chunks' partials merged per group with
//      Chan's pairwise formula in a fixed order (a warp a group: lane l
//      folds chunks l, l + 32, ... in turn, then the lanes merge in a
//      butterfly whose every step combines the lower lane's partial with
//      the higher's, so all lanes agree), written as (mean, rsqrt(var +
//      eps)) per (sample, group).
//   3. apply, one CTA a (sample, chunk): the CTA issues its chunk's loads,
//      reads its sample's statistics, and writes y sigmoid(y).  Its CTAs
//      take the chunks in reverse order: the first to run find the chunks
//      the statistics launch read last still in L2.
// x is read twice (the second time from L2 where it fits) and written once.
// A group's channels may straddle a vector (C = 32, G = 8: 4 channels a
// group, 8 bf16 a vector): each channel finds its own group.  Every sum has
// a fixed order and every output is written once, so the result is the same
// bit for bit from call to call.
//
// Numerics: statistics, affine and SiLU in f32, one rounding to the input
// dtype at the store (the plain version's casts).
//
// C entries, for the one dtype variant of the build:
// calo_groupnorm_silu_chunks (the chunks of a sample, for the scratch's
// size, (chunks + 1) B G 2 floats; -1 for a shape the kernel does not take)
// and calo_groupnorm_silu_forward (returns cudaGetLastError()).

#include "common.cuh"

namespace {

using namespace calo;

constexpr int THREADS = 384;  // 12 warps; a multiple of C / V for every C up to 384
constexpr int WARPS = THREADS / 32;
constexpr int MERGE_THREADS = 256;  // the merge: a warp a group
constexpr int MAX_C = 384;
constexpr int MAX_STEPS = 8;      // vectors a thread may hold: a chunk is that many rows a thread
constexpr int DEFAULT_STEPS = 8;  // the chunk size taken unless the caller asks for another
constexpr int V = 16 / sizeof(VariantT);  // channels a 16-byte vector

// a 16-byte vector of x as floats
__device__ __forceinline__ void unpack(const uint4& u, float* r) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#if CALO_BF16
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r[2 * i] = __uint_as_float(w[i] << 16);
    r[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
#else
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = __uint_as_float(w[i]);
#endif
}

// (n, mean, m2) <- the merge of itself with (nb, mb, m2b), Chan et al.'s
// pairwise formula for centred sums of squares
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2, float nb, float mb,
                                           float m2b) {
  if (nb == 0.f) return;
  if (n == 0.f) {
    n = nb; mean = mb; m2 = m2b;
    return;
  }
  const float nn = n + nb, delta = mb - mean;
  mean += delta * (nb / nn);
  m2 += m2b + delta * delta * (n * nb / nn);
  n = nn;
}

// The layout of one (sample, chunk) CTA of the statistics and apply
// launches: thread t keeps vector column t mod C/V of rows slot = t / (C/V),
// slot + rps, ... of the chunk
struct Chunk {
  int vpr, rps, owns, slot, col, b, row0, rows;

  __device__ Chunk(int blk, int S, int C, int steps, int n_chunks) {
    vpr = C / V;
    rps = THREADS / vpr;
    owns = threadIdx.x < rps * vpr;
    slot = threadIdx.x / vpr;
    col = (threadIdx.x % vpr) * V;
    b = blk / n_chunks;
    row0 = (blk % n_chunks) * steps * rps;
    rows = min(steps * rps, S - row0);
  }

  // the thread's vectors, raw; bit s of the result says whether vector s
  // lies in the sample
  template <typename T>
  __device__ __forceinline__ unsigned load(const T* __restrict__ xb, uint4 (&raw)[MAX_STEPS],
                                           int steps, int C) const {
    unsigned valid = 0;
#pragma unroll
    for (int s = 0; s < MAX_STEPS; ++s) {
      const int r = s * rps + slot;
      raw[s] = make_uint4(0u, 0u, 0u, 0u);
      if (owns && s < steps && r < rows) {
        raw[s] = *reinterpret_cast<const uint4*>(xb + static_cast<size_t>(row0 + r) * C + col);
        valid |= 1u << s;
      }
    }
    return valid;
  }
};

// per-thread channel sums acc[V] -> s_part, a (rows, C) table of partial
// channel sums; returns its rows.  Where a warp holds whole rows, they are
// summed by shuffles first and each warp writes one row.
__device__ __forceinline__ int rows_to_shared(float (&acc)[V], float* s_part, const Chunk& ck,
                                              int C) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (32 % ck.vpr == 0) {
#pragma unroll
    for (int e = 0; e < V; ++e)
      for (int o = ck.vpr; o < 32; o <<= 1) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
    if (lane < ck.vpr) {
#pragma unroll
      for (int e = 0; e < V; ++e) s_part[warp * C + ck.col + e] = acc[e];
    }
    return WARPS;
  }
  if (ck.owns) {
#pragma unroll
    for (int e = 0; e < V; ++e) s_part[ck.slot * C + ck.col + e] = acc[e];
  }
  return ck.rps;
}

// dst[g] = the sum of group g's entries of s_part (rows, C), in a fixed
// order; a warp a group
__device__ void group_sums(const float* s_part, float* dst, int rows, int C, int G) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, cg = C / G, n = rows * cg;
  for (int g = warp; g < G; g += WARPS) {
    float t = 0.f;
    for (int i = lane; i < n; i += 32) t += s_part[(i / cg) * C + g * cg + i % cg];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) dst[g] = t;
  }
}

// three CTAs an SM (at most 56 registers a thread, a few bytes spilled):
// 16 % faster than two at ds3 level 0 in bf16, the same in f32
// (scripts/torch_groupnorm_variants.py, stats_3_ctas)
template <typename T>
__global__ void __launch_bounds__(THREADS, 3)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ part, int S, int C, int G,
                int steps, int n_chunks) {
  extern __shared__ __align__(16) float smem[];
  float* s_part = smem;               // (rows, C) partial channel sums
  float* s_sum = smem + THREADS * V;  // (G)
  float* s_m2 = s_sum + MAX_C;        // (G)

  const Chunk ck(blockIdx.x, S, C, steps, n_chunks);
  const int cg = C / G;
  uint4 raw[MAX_STEPS];
  const unsigned valid = ck.load<T>(x + static_cast<size_t>(ck.b) * S * C, raw, steps, C);

  // pass 1: group means over the chunk
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
#pragma unroll
  for (int s = 0; s < MAX_STEPS; ++s) {
    float f[V];
    unpack(raw[s], f);  // zeros where the vector lies past the sample
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] += f[e];
  }
  int rows = rows_to_shared(acc, s_part, ck, C);
  __syncthreads();
  group_sums(s_part, s_sum, rows, C, G);
  __syncthreads();
  const float count = static_cast<float>(ck.rows) * static_cast<float>(cg);

  // pass 2: centred sums of squares, from the registers
  float mu[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    mu[e] = s_sum[(ck.col + e) / cg] / count;
    acc[e] = 0.f;
  }
#pragma unroll
  for (int s = 0; s < MAX_STEPS; ++s) {
    if (!(valid & (1u << s))) continue;
    float f[V];
    unpack(raw[s], f);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float d = f[e] - mu[e];
      acc[e] += d * d;
    }
  }
  __syncthreads();  // every thread has read s_sum; s_part is free again
  rows = rows_to_shared(acc, s_part, ck, C);
  __syncthreads();
  group_sums(s_part, s_m2, rows, C, G);
  __syncthreads();
  if (threadIdx.x < G) {
    float* p = part + (static_cast<size_t>(blockIdx.x) * G + threadIdx.x) * 2;
    p[0] = s_sum[threadIdx.x] / count;
    p[1] = s_m2[threadIdx.x];
  }
}

__global__ void __launch_bounds__(MERGE_THREADS)
gn_merge_kernel(const float* __restrict__ part, float* __restrict__ stats, int S, int G, int cg,
                int chunk_rows, int n_chunks, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* pb = part + static_cast<size_t>(blockIdx.x) * n_chunks * G * 2;
  for (int g = warp; g < G; g += MERGE_THREADS / 32) {
    float n = 0.f, mean = 0.f, m2 = 0.f;
    for (int c = lane; c < n_chunks; c += 32) {
      const float nb = static_cast<float>(min(chunk_rows, S - c * chunk_rows)) * cg;
      chan_merge(n, mean, m2, nb, pb[(c * G + g) * 2], pb[(c * G + g) * 2 + 1]);
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float n2 = __shfl_xor_sync(0xffffffffu, n, o);
      const float mean2 = __shfl_xor_sync(0xffffffffu, mean, o);
      const float m22 = __shfl_xor_sync(0xffffffffu, m2, o);
      if (lane & o) {  // the partner is the lower lane: its partial comes first
        float an = n2, am = mean2, a2 = m22;
        chan_merge(an, am, a2, n, mean, m2);
        n = an; mean = am; m2 = a2;
      } else {
        chan_merge(n, mean, m2, n2, mean2, m22);
      }
    }
    if (lane == 0) {
      float* st = stats + (static_cast<size_t>(blockIdx.x) * G + g) * 2;
      st[0] = mean;
      st[1] = rsqrtf(m2 / n + eps);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ bias, const float* __restrict__ stats,
                T* __restrict__ out, int S, int C, int G, int steps, int n_chunks, int n_blocks,
                int apply_silu) {
  extern __shared__ __align__(16) float smem[];
  float* s_mean = smem;          // (G)
  float* s_inv = smem + MAX_C;   // (G)

  // reverse order: L2 still holds the chunks the statistics launch read last
  const Chunk ck(n_blocks - 1 - blockIdx.x, S, C, steps, n_chunks);
  const size_t base = static_cast<size_t>(ck.b) * S * C;
  uint4 raw[MAX_STEPS];
  const unsigned valid = ck.load<T>(x + base, raw, steps, C);
  if (threadIdx.x < G) {
    const float* st = stats + (static_cast<size_t>(ck.b) * G + threadIdx.x) * 2;
    s_mean[threadIdx.x] = st[0];
    s_inv[threadIdx.x] = st[1];
  }
  __syncthreads();
  if (!ck.owns) return;

  const int cg = C / G;
  float mu[V], a[V], bi[V];
#pragma unroll
  for (int e = 0; e < V; e += 4) {
    load16(scale + ck.col + e, a + e);
    load16(bias + ck.col + e, bi + e);
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int g = (ck.col + e) / cg;
    mu[e] = s_mean[g];
    a[e] *= s_inv[g];
  }
  T* ob = out + base;
#pragma unroll
  for (int s = 0; s < MAX_STEPS; ++s) {
    if (!(valid & (1u << s))) continue;
    float y[V];
    unpack(raw[s], y);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      y[e] = (y[e] - mu[e]) * a[e] + bi[e];
      if (apply_silu) y[e] = y[e] / (1.f + expf(-y[e]));
    }
    store16(ob + static_cast<size_t>(ck.row0 + s * ck.rps + ck.slot) * C + ck.col, y);
  }
}

constexpr size_t STATS_SMEM = (THREADS * V + 2 * MAX_C) * sizeof(float);
constexpr size_t APPLY_SMEM = 2 * MAX_C * sizeof(float);

// the chunks of a sample of S rows, or -1 for a shape the kernel does not take
int chunks_of(int S, int C, int steps) {
  if (S < 1 || C < V || C > MAX_C || C % V || steps < 1 || steps > MAX_STEPS) return -1;
  const int chunk_rows = steps * (THREADS / (C / V));
  return (S + chunk_rows - 1) / chunk_rows;
}

template <typename T>
int launch(const void* x, const void* scale, const void* bias, void* out, float* part, int B,
           int S, int C, int G, int steps, int n_chunks, float eps, int apply_silu,
           cudaStream_t stream) {
  const int n_blocks = B * n_chunks;
  float* stats = part + static_cast<size_t>(n_blocks) * G * 2;
  gn_stats_kernel<T><<<n_blocks, THREADS, STATS_SMEM, stream>>>(
      static_cast<const T*>(x), part, S, C, G, steps, n_chunks);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  gn_merge_kernel<<<B, MERGE_THREADS, 0, stream>>>(part, stats, S, G, C / G,
                                                   steps * (THREADS / (C / V)), n_chunks, eps);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  gn_apply_kernel<T><<<n_blocks, THREADS, APPLY_SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), stats, static_cast<T*>(out), S, C, G, steps, n_chunks,
      n_blocks, apply_silu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// steps < 1: the kernel's own chunk size
extern "C" int calo_groupnorm_silu_chunks(int S, int C, int steps) {
  return chunks_of(S, C, steps < 1 ? DEFAULT_STEPS : steps);
}

// part: f32 scratch of (chunks + 1) * B * G * 2 (calo_groupnorm_silu_chunks):
// the chunks' partials, then the samples' statistics
extern "C" int calo_groupnorm_silu_forward(const void* x, const void* scale, const void* bias,
                                           void* out, void* part, int B, int S, int C, int G,
                                           int is_bf16, float eps, int apply_silu, int steps,
                                           void* stream) {
  if (steps < 1) steps = DEFAULT_STEPS;
  const int n_chunks = chunks_of(S, C, steps);
  if (B < 1 || n_chunks < 1 || G < 1 || C % G ||
      static_cast<long long>(B) * n_chunks > 0x7fffffffLL || !is_dtype_variant(is_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<VariantT>(x, scale, bias, out, static_cast<float*>(part), B, S, C, G, steps,
                          n_chunks, eps, apply_silu, static_cast<cudaStream_t>(stream));
}
