// Fused PreNormResidual(LinearAttention) block, forward, for Hopper (sm_90a)
// (K1), and, built with -DCALO_LINEAR=1, LinearAttention alone (K3).
//
//   K1: out = x + GN1_post(y),  K3: out = y rounded to T,
//   y = W_o^T (ctx^T softmax_d(q) d^-1/2) + b_o,
//   q/k/v = W_{q,k,v}^T xn, ctx = softmax_N(k) v^T, xn = GN1_pre(x) (K1), x (K3)
//
// per sample, heads = 1, dim_head D = 32, x laid out (B, N, C) with
// C in {16, 32, 64, 96}.  Replaces the Pallas kernels
// calodiffusion_tpu/ops/pallas_linear_attention.py::_block_kernel (K1) and
// ::_kernel (K3, entry fused_linear_attention; its backward is autograd of
// the plain version, ops/linear_attention.py, as the JAX custom VJP is).
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
// 16: x in the compute dtype and (K1) y in f32, both in its own shared
// memory.  Sums over the sample meet over distributed shared memory
// (map_shared_rank, cluster.sync), in rank order, so every CTA of the
// cluster holds the same (attention_common.cuh):
//   phase 0  x -> shared memory (cp.async); K1: the pre-GN mean, then the
//            centred variance (two passes over shared memory), each summed
//            over the cluster
//   phase A  per 16-position tile and warp: xn tile, k and v projections
//            (tensor cores), the online softmax of k over positions (lane d
//            owns column d: tile max, rescale, exponentials, sum), ctx
//            partial += k'^T v (tensor cores); the warps' partials merge in
//            the CTA, then the CTAs' over the cluster, each rescaled by
//            exp(m_part - m_all): every CTA ends with the same ctx
//   phase B  per tile: q projection, softmax over d, ctx^T q, W_o^T, bias
//            (three products on the tensor cores); K3 writes y out here.
//            K1: y stays in shared memory in the fragments' own order; its
//            mean, then centred variance, summed over the cluster
//   phase C  K1: out = x + GN1_post(y), from shared memory to device memory
// One read of x from device memory and one write of out; no scratch.
// The wrapper picks G from N, the smallest of 1, 2, 4, 8 whose share fits a
// CTA (K1: 8 for ds2's N = 6480, 1 or 2 for 736, 1 for 96).  Where no G
// holds a sample (N past ~7,000 at C = 32, such as dataset 3's 40,500
// positions), G = 8 and y, then x too, live in device memory instead: a
// scratch for y from the wrapper, x re-read from L2, the same code on other
// pointers.  The f32 variant holds twice the bytes of x: at (6480, 32) K1
// keeps x in shared memory and y in the device scratch.  K3 keeps no y.
//
// Products.  bf16: mma.sync m16n8k16 (bf16 inputs, exact products, f32
// sums), operands staged in shared memory and read by ldmatrix.  f32: the
// same fragments computed with FFMA on the CUDA cores (TF32 would not keep
// K1_TOL).  Both round to the compute dtype T where the Pallas kernels
// cast: the pre-GN output, the k softmax numerators and v, ctx, the scaled
// q softmax, the attention output before W_o, the post-GN output before the
// residual add (K1), the output (K3).  Statistics, softmaxes and sums in
// f32.
//
// Measured on one NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py,
// scripts/torch_kernel_variants.py): K1 bf16 0.40 ms of device time at
// (128, 6480, 32), 0.95 ms for the 7 launches of a ds2 denoise, against a
// 0.076 ms bound; at (6480, 32) one 190 KB CTA fits an SM, and about half of
// a CTA's time goes to cluster barriers, merges and statistics.  K3 bf16:
// 0.60 ms of device time at dataset 3's (64, 40,500, 32) (G = 8, x re-read
// from device memory) against a 0.099 ms bound; its first port, one block
// a sample on the CUDA cores, took 7.3 ms.
//
// C entries, for the one (dtype, C) variant of the build: K1
// calo_attention_block_plan (the cluster size, positions a CTA and where x
// and y live) and calo_attention_block_forward; K3 calo_linear_attention_plan
// and calo_linear_attention_forward; each returns a CUDA error code.

#include <algorithm>

#include "attention_common.cuh"

#if !defined(CALO_LINEAR)
#define CALO_LINEAR 0
#endif

namespace {

using namespace calo;

constexpr bool BLOCK = !CALO_LINEAR;  // K1: the two GroupNorms and the residual
// 16 warps at bf16 C = 32 (ds2's N = 6480: one CTA an SM, whose warps hide
// each other's latency); 8 otherwise, where 16 would spill (bf16 C = 64) or
// not fit a sample's share (f32)
constexpr int THREADS = CALO_BF16 && C == 32 ? 512 : 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size

// byte sizes of the shared-memory regions (multiples of 16)
constexpr size_t W_BYTES = C * LDW * sizeof(T) + D * LDO * sizeof(T) + D * LDD * sizeof(T);
constexpr size_t PAR_BYTES = (5 * C + WARPS + MAX_CLUSTER) * sizeof(float);
constexpr size_t XA_BYTES = TILE * LDA * sizeof(T);  // a warp's A operand
static_assert(W_BYTES % 16 == 0 && PAR_BYTES % 16 == 0, "alignment");

// where a launch keeps a sample
struct Plan {
  int G;        // CTAs a cluster = a sample
  int P;        // positions a CTA, a multiple of TILE
  bool x_res;   // x in shared memory (else re-read from device memory)
  bool y_res;   // y in shared memory (else the wrapper's device scratch; K3 keeps none)
  size_t smem;  // dynamic shared memory a CTA
};

size_t smem_bytes(int P, bool x_res, bool y_res) {
  const size_t y = y_res ? static_cast<size_t>(P) * C * 4 : 0;
  const size_t scratch = std::max({y, WARPS * CTX_STAGE_BYTES, (WARPS + 1) * CTX_PART_FLOATS * 4});
  return W_BYTES + PAR_BYTES + WARPS * XA_BYTES +
         (x_res ? static_cast<size_t>(P) * C * sizeof(T) : 0) + scratch;
}

// cluster 0: the smallest G of 1, 2, 4, 8 that holds the sample on chip (K1:
// x and y; K3: x), else G = 8 with y, then also x, in device memory;
// cluster > 0: that G, with as much on chip as fits.  smem_limit: the
// bytes a CTA may take.
bool make_plan(int N, int cluster, size_t smem_limit, Plan* p) {
  const bool modes[3][2] = {{true, true}, {true, false}, {false, false}};
  constexpr int first = BLOCK ? 0 : 1;  // K3 has no y to keep
  for (int G = cluster ? cluster : 1; G <= (cluster ? cluster : MAX_CLUSTER); G *= 2) {
    const int P = ((N + G - 1) / G + TILE - 1) / TILE * TILE;
    const bool last = G >= (cluster ? cluster : MAX_CLUSTER);
    for (int m = first; m < 3; ++m) {
      if (!last && m > first) break;  // try a larger G before leaving the chip
      const size_t s = smem_bytes(P, modes[m][0], modes[m][1]);
      if (s <= smem_limit) {
        *p = Plan{G, P, modes[m][0], modes[m][1], s};
        return true;
      }
    }
  }
  return false;
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
  float acc = 0.f;
  if constexpr (BLOCK) {
    const int n_vec = cnt * C / PER;
    for (int i = tid; i < n_vec; i += THREADS) {
      float r[PER];
      load16(xs + i * PER, r);
#pragma unroll
      for (int j = 0; j < PER; ++j) acc += r[j];
    }
    const float mu = cluster_sum<THREADS, MAX_CLUSTER>(cluster, acc, s_red, s_slots, 0) / denom;
    acc = 0.f;
    for (int i = tid; i < n_vec; i += THREADS) {
      float r[PER];
      load16(xs + i * PER, r);
#pragma unroll
      for (int j = 0; j < PER; ++j) acc += (r[j] - mu) * (r[j] - mu);
    }
    const float inv =
        rsqrtf(cluster_sum<THREADS, MAX_CLUSTER>(cluster, acc, s_red, s_slots, 1) / denom + eps);
    if (tid < C) {
      const float sc = gn_pre_scale[tid] * inv;
      pre_sc[tid] = sc;
      pre_sh[tid] = gn_pre_bias[tid] - sc * mu;
    }
    __syncthreads();
  }

  // the projections' input of a tile's positions into this warp's A
  // operand (K1: the pre-GN output; K3: x itself)
  auto make_xn = [&](int tile) { stage_input<BLOCK>(s_xa, xs, cnt, tile, pre_sc, pre_sh); };

  // ---- phase A: ctx = softmax_N(k) v^T, online over this warp's tiles ------
  CtxPartial part;
  context_partial<WARPS>(part, make_xn, s_xa, s_w, scratch + warp * CTX_STAGE_BYTES, cnt);
  // the warps' partials, then the CTAs', merged into s_ctx
  context_merge<THREADS, MAX_CLUSTER>(cluster, part, reinterpret_cast<float*>(scratch), s_ctx,
                                      nullptr, nullptr);

  // ---- phase B: y = W_o^T (ctx^T softmax_d(q) d^-1/2) + b_o -----------------
  T* ob = out + (static_cast<size_t>(b) * N + n0) * C;
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
               rnd<T>(qacc[0][nt][2 * h] / sum * QSCALE),
               rnd<T>(qacc[0][nt][2 * h + 1] / sum * QSCALE));
    }
    __syncwarp();
    float oacc[1][4][4];
    zero(oacc);
    warp_gemm<1, 4, 2, false>(oacc, s_xa, LDA, s_ctx, LDD);
    __syncwarp();
    store_frags(s_xa, LDA, oacc);  // rounded to T by the store
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
      if constexpr (BLOCK) {
        *reinterpret_cast<float4*>(ys + ((tile * NT_C + nt) * 32 + lane) * 4) = y;
        acc += (ok0 ? y.x + y.y : 0.f) + (ok1 ? y.z + y.w : 0.f);
      } else {  // K3: y is the output
        const int c = nt * 8 + 2 * t;
        if (ok0) store2(ob + static_cast<size_t>(tile * TILE + g) * C + c, y.x, y.y);
        if (ok1) store2(ob + static_cast<size_t>(tile * TILE + g + 8) * C + c, y.z, y.w);
      }
    }
    __syncwarp();  // the next tile overwrites s_xa
  }
  if constexpr (!BLOCK) return;  // no cluster sum after the context merge

  const float mu_y = cluster_sum<THREADS, MAX_CLUSTER>(cluster, acc, s_red, s_slots, 2) / denom;

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
  const float inv_y =
      rsqrtf(cluster_sum<THREADS, MAX_CLUSTER>(cluster, acc, s_red, s_slots, 3) / denom + eps);
  if (tid < C) {
    const float sc = gn_post_scale[tid] * inv_y;
    post_sc[tid] = sc;
    post_sh[tid] = gn_post_bias[tid] - sc * mu_y;
  }
  __syncthreads();

  // ---- phase C: out = x + GN1_post(y) -----------------------------------------
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

int plan_for(int N, int cluster, int smem_limit, Plan* p) {
  if (N < 1 || cluster < 0 || cluster > MAX_CLUSTER || (cluster & (cluster - 1)) || smem_limit < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t limit = smem_limit ? static_cast<size_t>(smem_limit) : card_smem_limit();
  return make_plan(N, cluster, limit, p) ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

int write_plan(int N, int C_, int is_bf16, int cluster, int smem_limit, int* plan) {
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

int forward(const void* x, const void* gn_pre_scale, const void* gn_pre_bias,
            const void* w_qkv, const void* w_out, const void* b_out,
            const void* gn_post_scale, const void* gn_post_bias, void* y_scr, void* out,
            int B, int N, int C_, int is_bf16, float eps, int cluster, int smem_limit,
            void* stream) {
  if (B < 1 || !is_variant(is_bf16, C_)) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  int err = plan_for(N, cluster, smem_limit, &p);
  if (err) return err;
  if (BLOCK && !p.y_res && y_scr == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(B) * p.G > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ClusterLaunch launch(B, p.G, THREADS, p.smem, stream);
  // a cluster the card cannot place is an error, never a smaller launch
  err = check_launch<MAX_CLUSTER>(attention_block_kernel, launch.cfg, p.G);
  if (err) return err;
  err = static_cast<int>(cudaLaunchKernelEx(
      &launch.cfg, attention_block_kernel, static_cast<const T*>(x),
      static_cast<const float*>(gn_pre_scale), static_cast<const float*>(gn_pre_bias),
      static_cast<const T*>(w_qkv), static_cast<const T*>(w_out),
      static_cast<const float*>(b_out), static_cast<const float*>(gn_post_scale),
      static_cast<const float*>(gn_post_bias), static_cast<float*>(y_scr), static_cast<T*>(out),
      N, p.P, static_cast<int>(p.x_res), static_cast<int>(p.y_res), eps));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#if CALO_LINEAR
// K3's plan at (N, cluster, smem_limit), as calo_attention_block_plan's
// (plan[3], y in shared memory, is always 0: K3 keeps no y)
extern "C" int calo_linear_attention_plan(int N, int C_, int is_bf16, int cluster,
                                          int smem_limit, int* plan) {
  return write_plan(N, C_, is_bf16, cluster, smem_limit, plan);
}

// y = LinearAttention(x) in x's dtype; cluster and smem_limit as K1's
extern "C" int calo_linear_attention_forward(const void* x, const void* w_qkv,
                                             const void* w_out, const void* b_out, void* out,
                                             int B, int N, int C_, int is_bf16, int cluster,
                                             int smem_limit, void* stream) {
  return forward(x, nullptr, nullptr, w_qkv, w_out, b_out, nullptr, nullptr, nullptr, out, B, N,
                 C_, is_bf16, 0.f, cluster, smem_limit, stream);
}
#else
// where a launch at (N, cluster, smem_limit) keeps a sample: plan[0..4] =
// {G, P, x in shared memory, y in shared memory, shared bytes a CTA}.
// cluster 0 lets the kernel choose G; smem_limit 0 is the card's opt-in limit.
extern "C" int calo_attention_block_plan(int N, int C_, int is_bf16, int cluster,
                                         int smem_limit, int* plan) {
  return write_plan(N, C_, is_bf16, cluster, smem_limit, plan);
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
  return forward(x, gn_pre_scale, gn_pre_bias, w_qkv, w_out, b_out, gn_post_scale, gn_post_bias,
                 y_scr, out, B, N, C_, is_bf16, eps, cluster, smem_limit, stream);
}
#endif
