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
// dim_head D = 32, x and g laid out (B, N, C) with C in {32, 64}.  Replaces
// the Pallas kernel
// calodiffusion_tpu/ops/pallas_linear_attention.py::_block_bwd_kernel.
//
// Design.  As in the forward, one block takes one sample and streams it
// from device memory (L2) once per pass; the TPU kernel's five VMEM slabs
// (y and dxn as (N, C), k, v and q as (N, D), all f32) are scratch in
// device memory from the wrapper's torch.empty.  128 threads, one position
// per thread per tile of 128 positions:
//   pass 0   pre-GN statistics of x, two-pass centered
//   pass A   k/v projections (staged), online softmax over N, ctx
//   pass B   q projection (staged), y (staged), then the post-GN statistics
//   pass G   post-GN backward sums S1, S2 and the post-GN affine gradients
//   pass M   dy -> do -> dqs, dq -> dxn = W_q dq; accumulates dW_o, dctx,
//            dW_q and db_o
//   pass R   k-softmax backward: r_d = sum_n ks dks; dv -> dxn += W_v dv; dW_v
//   pass K   dk = ks (dks - r_d) -> dxn += W_k dk; dW_k
//   pass P   pre-GN backward sums T1, T2 and the pre-GN affine gradients
//   pass F   dx = inv (g1 dxn - T1/(NC) - xhat T2/(NC)) + g
// A sum over positions of an outer product (dW_o, dctx, dW_q, dW_v, dW_k)
// goes through shared memory: each thread writes its position's vectors
// as one column of a (rows, 128) tile, then each thread sums its own
// entries of the matrix over the tile's columns.  Per-channel sums do the
// same with one row per thread.  Positions past N write zero columns.
//
// Bound.  The card's memory: the function must read x and g once and write
// dx once (3 * B * N * C elements); its products are (12 C D + 8 D^2) * 2
// FLOPs a position, below the tensor cores' rate per byte.  This kernel
// reads x five times and its f32 scratch several times, mostly from L2, and
// does its products on the CUDA cores: simple and right first, fast later.
//
// Numerics follow the Pallas kernel: statistics, softmaxes, exps and every
// accumulator in f32; values are rounded to the compute dtype T where the
// Pallas kernel casts (xn, v and the k softmax numerators before the
// context product, ctx, qs, the attention output, dy, do, dq, dv, dk and
// dctx before each product).
//
// C entry: calo_attention_block_backward, for the one (dtype, C) variant
// of the build (attention_common.cuh); returns cudaGetLastError().

#include "attention_common.cuh"

namespace {

using namespace calo;

constexpr int THREADS = 128;   // one position per thread per tile
constexpr int TILE = THREADS;
constexpr int LD = TILE + 1;   // padded row stride of the (rows, TILE) tiles
constexpr int WARPS = THREADS / 32;
constexpr float QSCALE = 0.17677669529663687f;  // 32 ** -0.5

template <int C>
constexpr int TILE_ROWS = 2 * C + 4 * D;  // pass M: dy, xn, o, qs, do, dq

template <int C>
constexpr int smem_floats() {
  return 3 * C * D      // w_q, w_k, w_v  (C, D) each
         + D * C        // w_o            (D, C)
         + C * D        // w_o^T          (C, D)
         + 4 * D * D    // ctx, dctx and their transposes (rounded to T)
         + 4 * C        // pre-GN scale, shift; post-GN scale; b_o
         + 4 * D        // k softmax max, sum, rescale; r_d
         + WARPS        // block reductions
         + TILE_ROWS<C> * LD;
}

// acc[k] += sum_t A[i][t] * B[j][t] over the tile's nv columns, for the
// entries (i, j) = divmod(tid + k * THREADS, J) of an (I, J) matrix, that
// is j = tid % J and i = tid / J + k * THREADS / J; B is rounded to T on
// read when RB.  A warp's lanes share i and take 32 consecutive j: A is a
// broadcast, B has no bank conflicts (LD odd).
template <typename T, int I, int J, bool RB>
__device__ __forceinline__ void outer_acc(float (&acc)[I * J / THREADS], const float* A,
                                          const float* B, int nv) {
  static_assert((I * J) % THREADS == 0 && THREADS % J == 0 && J % 32 == 0,
                "entries per thread");
  constexpr int K = I * J / THREADS;
  constexpr int STEP = (THREADS / J) * LD;  // rows between a thread's entries
  const float* a = A + (threadIdx.x / J) * LD;
  const float* bj = B + (threadIdx.x % J) * LD;
  for (int t = 0; t < nv; ++t) {
    const float bv = RB ? rnd<T>(bj[t]) : bj[t];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] += a[k * STEP + t] * bv;
  }
}

// one row of the tile per thread: sum over the tile's nv columns
__device__ __forceinline__ float row_sum(const float* tile, int rows, int nv) {
  float s = 0.f;
  if (threadIdx.x < rows) {
    const float* r = tile + threadIdx.x * LD;
    for (int t = 0; t < nv; ++t) s += r[t];
  }
  return s;
}

// sum_j w[i*D + j] * v[j]: a row of a (., D) matrix in shared memory times v
__device__ __forceinline__ float dot_d(const float* w, const float (&v)[D]) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < D / 4; ++j) {
    const float4 a = w4[j];
    s += a.x * v[4 * j] + a.y * v[4 * j + 1] + a.z * v[4 * j + 2] + a.w * v[4 * j + 3];
  }
  return s;
}

// out[e] += s * w[e] over a row of D floats in shared memory
__device__ __forceinline__ void axpy_d(float (&out)[D], float s, const float* w) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int j = 0; j < D / 4; ++j) {
    const float4 a = w4[j];
    out[4 * j] += s * a.x; out[4 * j + 1] += s * a.y;
    out[4 * j + 2] += s * a.z; out[4 * j + 3] += s * a.w;
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
attention_block_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                           const float* __restrict__ gn_pre_scale,
                           const float* __restrict__ gn_pre_bias, const T* __restrict__ w_qkv,
                           const T* __restrict__ w_out, const float* __restrict__ b_out,
                           const float* __restrict__ gn_post_scale, float* __restrict__ y_scr,
                           float* __restrict__ dxn_scr, float* __restrict__ k_scr,
                           float* __restrict__ v_scr, float* __restrict__ q_scr,
                           T* __restrict__ dx, float* __restrict__ dg1, float* __restrict__ db1,
                           float* __restrict__ dwq, float* __restrict__ dwk,
                           float* __restrict__ dwv, float* __restrict__ dwo,
                           float* __restrict__ dbo, float* __restrict__ dg2,
                           float* __restrict__ db2, int N, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* s_wq = smem;
  float* s_wk = s_wq + C * D;
  float* s_wv = s_wk + C * D;
  float* s_wo = s_wv + C * D;
  float* s_woT = s_wo + D * C;
  float* s_ctx = s_woT + C * D;
  float* s_ctxT = s_ctx + D * D;
  float* s_dctx = s_ctxT + D * D;
  float* s_dctxT = s_dctx + D * D;
  float* s_g1 = s_dctxT + D * D;
  float* s_b1 = s_g1 + C;
  float* s_g2 = s_b1 + C;
  float* s_bo = s_g2 + C;
  float* s_m = s_bo + C;
  float* s_s = s_m + D;
  float* s_resc = s_s + D;
  float* s_r = s_resc + D;
  float* s_red = s_r + D;
  float* s_tile = s_red + WARPS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x;
  const size_t offC = static_cast<size_t>(b) * N * C;
  const size_t offD = static_cast<size_t>(b) * N * D;
  const T* xb = x + offC;
  const T* gb = g + offC;
  float* yb = y_scr + offC;
  float* dxnb = dxn_scr + offC;
  float* kb = k_scr + offD;
  float* vb = v_scr + offD;
  float* qb = q_scr + offD;
  T* dxb = dx + offC;
  const float denom = static_cast<float>(C) * static_cast<float>(N);

  for (int i = tid; i < C * D; i += THREADS) {
    const int c = i / D, d = i % D;
    s_wq[i] = to_f<T>(w_qkv[c * 3 * D + d]);
    s_wk[i] = to_f<T>(w_qkv[c * 3 * D + D + d]);
    s_wv[i] = to_f<T>(w_qkv[c * 3 * D + 2 * D + d]);
    s_wo[i] = to_f<T>(w_out[i]);                   // (D, C) row-major, same flat size
    s_woT[i] = to_f<T>(w_out[d * C + c]);          // (C, D)
  }
  if (tid < C) {
    s_g1[tid] = gn_pre_scale[tid];
    s_b1[tid] = gn_pre_bias[tid];
    s_g2[tid] = gn_post_scale[tid];
    s_bo[tid] = b_out[tid];
  }
  if (tid < D) {
    s_m[tid] = -INFINITY;
    s_s[tid] = 0.f;
  }

  // ---- pass 0: pre-GN statistics (recompute; two-pass, centered) -------
  float acc = 0.f;
  for (int n = tid; n < N; n += THREADS) {
    float r[C];
    load_row<T, C>(xb + static_cast<size_t>(n) * C, r);
#pragma unroll
    for (int c = 0; c < C; ++c) acc += r[c];
  }
  const float mu = block_sum<THREADS>(acc, s_red) / denom;
  acc = 0.f;
  for (int n = tid; n < N; n += THREADS) {
    float r[C];
    load_row<T, C>(xb + static_cast<size_t>(n) * C, r);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float d = r[c] - mu;
      acc += d * d;
    }
  }
  const float inv = rsqrtf(block_sum<THREADS>(acc, s_red) / denom + eps);

  // Each thread keeps the vectors of its position in its own column of a
  // tile (no barrier needed to read them back), so that the products over
  // C and D run as rolled loops: small code, few registers.
  auto col = [&](const float* tile, int row) -> float { return tile[row * LD + tid]; };
  // xn of position n, (x - mu) inv g1 + b1 rounded to T, into a tile column
  auto xnorm_to_tile = [&](int n, float* tile) {
#pragma unroll 1
    for (int c0 = 0; c0 < C; c0 += 8) {
      float r[8];
      load8<T>(xb + static_cast<size_t>(n) * C + c0, r);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = c0 + i;
        tile[c * LD + tid] = rnd<T>((r[i] - mu) * inv * s_g1[c] + s_b1[c]);
      }
    }
  };
  // out[d] = sum_r col(tile, r) w[r * D + d] over R rows (rolled)
  auto colmat = [&](float (&out)[D], const float* tile, const float* w, int R) {
#pragma unroll
    for (int d = 0; d < D; ++d) out[d] = 0.f;
#pragma unroll 1
    for (int r = 0; r < R; ++r) axpy_d(out, col(tile, r), w + r * D);
  };

  // ---- pass A: k/v projections (staged), online softmax of k, ctx -------
  {
    float* s_kt = s_tile;           // (D, LD)
    float* s_vt = s_kt + D * LD;    // (D, LD)
    float* t_xn = s_vt + D * LD;    // (C, LD)
    float cacc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // ctx(warp + 4i, lane)
    for (int t0 = 0; t0 < N; t0 += TILE) {
      const int n = t0 + tid;
      if (n < N) {
        xnorm_to_tile(n, t_xn);
        float k[D];
        colmat(k, t_xn, s_wk, C);
        store_row<float, D>(kb + static_cast<size_t>(n) * D, k);
#pragma unroll
        for (int d = 0; d < D; ++d) s_kt[d * LD + tid] = k[d];
        colmat(k, t_xn, s_wv, C);  // v
        store_row<float, D>(vb + static_cast<size_t>(n) * D, k);
#pragma unroll
        for (int d = 0; d < D; ++d) s_vt[d * LD + tid] = rnd<T>(k[d]);
      } else {
#pragma unroll
        for (int d = 0; d < D; ++d) {
          s_kt[d * LD + tid] = -INFINITY;
          s_vt[d * LD + tid] = 0.f;
        }
      }
      __syncthreads();

      // one warp per k row: tile max, rescale, exp, row sum
      for (int d = warp; d < D; d += WARPS) {
        float* row = s_kt + d * LD;
        float bm = -INFINITY;
        for (int j = lane; j < TILE; j += 32) bm = fmaxf(bm, row[j]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, o));
        const float m_old = s_m[d];
        const float m_new = fmaxf(m_old, bm);
        float sum = 0.f;
        for (int j = lane; j < TILE; j += 32) {
          const float w = (t0 + j < N) ? expf(row[j] - m_new) : 0.f;
          sum += w;
          row[j] = rnd<T>(w);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        __syncwarp();
        if (lane == 0) {
          const float rs = expf(m_old - m_new);
          s_resc[d] = rs;
          s_s[d] = s_s[d] * rs + sum;
          s_m[d] = m_new;
        }
      }
      __syncthreads();

      const int nv = min(TILE, N - t0);
      float part[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      outer_acc<T, D, D, false>(part, s_kt, s_vt, nv);
#pragma unroll
      for (int i = 0; i < 8; ++i) cacc[i] = cacc[i] * s_resc[warp + 4 * i] + part[i];
      __syncthreads();  // the next tile overwrites the tiles
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int d = warp + 4 * i;
      const float cv = rnd<T>(cacc[i] / fmaxf(s_s[d], 1e-30f));
      s_ctx[d * D + lane] = cv;
      s_ctxT[lane * D + d] = cv;
    }
    __syncthreads();
  }

  // ---- pass B: q (staged), y = W_o^T (ctx^T qs) + b_o (staged) -----------
  acc = 0.f;
  {
    float* t_xn = s_tile;           // (C, LD), this thread's column only
    float* t_v = t_xn + C * LD;     // (D, LD): qs, then o
    for (int n = tid; n < N; n += THREADS) {
      xnorm_to_tile(n, t_xn);
      float q[D];
      colmat(q, t_xn, s_wq, C);
      store_row<float, D>(qb + static_cast<size_t>(n) * D, q);
      float mx = q[0];
#pragma unroll
      for (int d = 1; d < D; ++d) mx = fmaxf(mx, q[d]);
      float qsum = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        q[d] = expf(q[d] - mx);
        qsum += q[d];
      }
#pragma unroll
      for (int d = 0; d < D; ++d) t_v[d * LD + tid] = rnd<T>(q[d] / qsum * QSCALE);
      colmat(q, t_v, s_ctx, D);  // o = ctx^T qs
#pragma unroll
      for (int e = 0; e < D; ++e) t_v[e * LD + tid] = rnd<T>(q[e]);
      float y[C];
#pragma unroll
      for (int c = 0; c < C; ++c) y[c] = s_bo[c];
#pragma unroll 1
      for (int e = 0; e < D; ++e) {
        const float oe = col(t_v, e);
        const float4* w4 = reinterpret_cast<const float4*>(s_wo + e * C);
#pragma unroll
        for (int j = 0; j < C / 4; ++j) {
          const float4 a = w4[j];
          y[4 * j] += oe * a.x; y[4 * j + 1] += oe * a.y;
          y[4 * j + 2] += oe * a.z; y[4 * j + 3] += oe * a.w;
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) acc += y[c];
      store_row<float, C>(yb + static_cast<size_t>(n) * C, y);
    }
  }
  const float mu_y = block_sum<THREADS>(acc, s_red) / denom;
  acc = 0.f;
  for (int n = tid; n < N; n += THREADS) {
    float y[C];
    load_row<float, C>(yb + static_cast<size_t>(n) * C, y);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float d = y[c] - mu_y;
      acc += d * d;
    }
  }
  const float inv_y = rsqrtf(block_sum<THREADS>(acc, s_red) / denom + eps);

  // ---- pass G: post-GN backward sums, d gamma_post, d beta_post ----------
  float S1, S2;
  {
    float s1 = 0.f, s2 = 0.f, racc = 0.f;
    for (int t0 = 0; t0 < N; t0 += TILE) {
      const int n = t0 + tid;
      if (n < N) {
#pragma unroll 1
        for (int c0 = 0; c0 < C; c0 += 8) {
          float gr[8], yr[8];
          load8<T>(gb + static_cast<size_t>(n) * C + c0, gr);
          load8<float>(yb + static_cast<size_t>(n) * C + c0, yr);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int c = c0 + i;
            const float yh = (yr[i] - mu_y) * inv_y;
            const float dyh = s_g2[c] * gr[i];
            s1 += dyh;
            s2 += dyh * yh;
            s_tile[c * LD + tid] = gr[i] * yh;
            s_tile[(C + c) * LD + tid] = gr[i];
          }
        }
      } else {
#pragma unroll 1
        for (int c = 0; c < 2 * C; ++c) s_tile[c * LD + tid] = 0.f;
      }
      __syncthreads();
      racc += row_sum(s_tile, 2 * C, min(TILE, N - t0));
      __syncthreads();
    }
    if (tid < C) dg2[b * C + tid] = racc;
    else if (tid < 2 * C) db2[b * C + tid - C] = racc;
    S1 = block_sum<THREADS>(s1, s_red);
    S2 = block_sum<THREADS>(s2, s_red);
  }

  // dxn(n, c) (+)= sum_d w(c, d) u(d), 4 channels per 16-byte access
  auto dxn_write = [&](int n, const float* w, const float (&u)[D], bool add) {
    float* p = dxnb + static_cast<size_t>(n) * C;
#pragma unroll 1
    for (int c0 = 0; c0 < C; c0 += 4) {
      float r[4] = {0.f, 0.f, 0.f, 0.f};
      if (add) load16(p + c0, r);
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i] += dot_d(w + (c0 + i) * D, u);
      store16(p + c0, r);
    }
  };

  // ---- pass M: dy -> do -> dqs -> dq -> dxn; dW_o, dctx, dW_q, db_o ------
  {
    float* t_dy = s_tile;              // (C, LD) dy, f32
    float* t_xn = t_dy + C * LD;       // (C, LD) xn
    float* t_o = t_xn + C * LD;        // (D, LD) o, rounded
    float* t_qs = t_o + D * LD;        // (D, LD) qs, rounded
    float* t_do = t_qs + D * LD;       // (D, LD) do, rounded
    float* t_dq = t_do + D * LD;       // (D, LD) dq, rounded
    float a_wo[D * C / THREADS], a_ctx[D * D / THREADS], a_wq[C * D / THREADS];
#pragma unroll
    for (int i = 0; i < D * C / THREADS; ++i) a_wo[i] = a_wq[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D * D / THREADS; ++i) a_ctx[i] = 0.f;
    float racc = 0.f;
    const float s1n = S1 / denom, s2n = S2 / denom;
    for (int t0 = 0; t0 < N; t0 += TILE) {
      const int n = t0 + tid;
      if (n < N) {
        // dy = inv_y (g2 g - S1/(NC) - yhat S2/(NC))
#pragma unroll 1
        for (int c0 = 0; c0 < C; c0 += 8) {
          float gr[8], yr[8];
          load8<T>(gb + static_cast<size_t>(n) * C + c0, gr);
          load8<float>(yb + static_cast<size_t>(n) * C + c0, yr);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int c = c0 + i;
            const float yh = (yr[i] - mu_y) * inv_y;
            t_dy[c * LD + tid] = inv_y * (s_g2[c] * gr[i] - s1n - yh * s2n);
          }
        }
        // q softmax from the staged q: qs0 unscaled in f32, qs rounded
        float qs0[D];
        load_row<float, D>(qb + static_cast<size_t>(n) * D, qs0);
        float mx = qs0[0];
#pragma unroll
        for (int d = 1; d < D; ++d) mx = fmaxf(mx, qs0[d]);
        float qsum = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          qs0[d] = expf(qs0[d] - mx);
          qsum += qs0[d];
        }
#pragma unroll
        for (int d = 0; d < D; ++d) {
          qs0[d] = qs0[d] / qsum;
          t_qs[d * LD + tid] = rnd<T>(qs0[d] * QSCALE);
        }
        float v[D];
        colmat(v, t_qs, s_ctx, D);  // o = ctx^T qs
#pragma unroll
        for (int e = 0; e < D; ++e) t_o[e * LD + tid] = rnd<T>(v[e]);
        // do(e) = sum_c W_o(e, c) dy(c), rounded
#pragma unroll
        for (int e = 0; e < D; ++e) v[e] = 0.f;
#pragma unroll 1
        for (int c = 0; c < C; ++c) axpy_d(v, rnd<T>(col(t_dy, c)), s_woT + c * D);
#pragma unroll
        for (int e = 0; e < D; ++e) t_do[e * LD + tid] = rnd<T>(v[e]);
        // dqs(d) = sum_e ctx(d, e) do(e); softmax backward over d
        colmat(v, t_do, s_ctxT, D);
        float colsum = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          v[d] *= QSCALE;
          colsum += qs0[d] * v[d];
        }
#pragma unroll
        for (int d = 0; d < D; ++d) {
          v[d] = rnd<T>(qs0[d] * (v[d] - colsum));
          t_dq[d * LD + tid] = v[d];
        }
        // dxn = W_q dq (W_v and W_k parts added in passes R and K)
        dxn_write(n, s_wq, v, false);
        xnorm_to_tile(n, t_xn);
      } else {
#pragma unroll 1
        for (int r = 0; r < TILE_ROWS<C>; ++r) s_tile[r * LD + tid] = 0.f;
      }
      __syncthreads();
      const int nv = min(TILE, N - t0);
      outer_acc<T, D, C, true>(a_wo, t_o, t_dy, nv);
      outer_acc<T, D, D, false>(a_ctx, t_qs, t_do, nv);
      outer_acc<T, C, D, false>(a_wq, t_xn, t_dq, nv);
      racc += row_sum(t_dy, C, nv);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < D * C / THREADS; ++i) {
      const int e = tid + i * THREADS;
      dwo[static_cast<size_t>(b) * D * C + e] = a_wo[i];
      dwq[static_cast<size_t>(b) * C * D + e] = a_wq[i];
    }
#pragma unroll
    for (int i = 0; i < D * D / THREADS; ++i) {
      const int e = tid + i * THREADS;  // (d, e') = divmod(e, D)
      const float dv = rnd<T>(a_ctx[i]);
      s_dctx[e] = dv;
      s_dctxT[(e % D) * D + e / D] = dv;
    }
    if (tid < C) dbo[b * C + tid] = racc;
    __syncthreads();
  }

  // k softmax of position n from the staged k (final max and sum)
  auto ksoft = [&](int n, float (&kw)[D]) {
    load_row<float, D>(kb + static_cast<size_t>(n) * D, kw);
#pragma unroll
    for (int d = 0; d < D; ++d) kw[d] = expf(kw[d] - s_m[d]) / fmaxf(s_s[d], 1e-30f);
  };
  // dks(d) = sum_e dctx(d, e) v(e) of position n, v rounded, through a
  // tile column
  auto dks_of = [&](int n, float (&dks)[D], float* t_v) {
    load_row<float, D>(vb + static_cast<size_t>(n) * D, dks);
#pragma unroll
    for (int e = 0; e < D; ++e) t_v[e * LD + tid] = rnd<T>(dks[e]);
    colmat(dks, t_v, s_dctxT, D);
  };

  // ---- pass R: r_d = sum_n ks dks; dv -> dxn += W_v dv; dW_v ------------
  {
    float* t_r = s_tile;            // (D, LD) ks * dks
    float* t_xn = t_r + D * LD;     // (C, LD) xn
    float* t_dv = t_xn + C * LD;    // (D, LD) dv, rounded
    float* t_v = t_dv + D * LD;     // (D, LD) v, rounded; then ks, rounded
    float a_wv[C * D / THREADS];
#pragma unroll
    for (int i = 0; i < C * D / THREADS; ++i) a_wv[i] = 0.f;
    float racc = 0.f;
    for (int t0 = 0; t0 < N; t0 += TILE) {
      const int n = t0 + tid;
      if (n < N) {
        float kw[D], dv[D];
        ksoft(n, kw);
        dks_of(n, dv, t_v);  // dks, in dv's registers until dv is needed
#pragma unroll
        for (int d = 0; d < D; ++d) {
          t_r[d * LD + tid] = kw[d] * dv[d];
          t_v[d * LD + tid] = rnd<T>(kw[d]);
        }
        colmat(dv, t_v, s_dctx, D);  // dv(e) = sum_d dctx(d, e) ks(d)
#pragma unroll
        for (int e = 0; e < D; ++e) {
          dv[e] = rnd<T>(dv[e]);
          t_dv[e * LD + tid] = dv[e];
        }
        dxn_write(n, s_wv, dv, true);
        xnorm_to_tile(n, t_xn);
      } else {
#pragma unroll 1
        for (int r = 0; r < C + 2 * D; ++r) s_tile[r * LD + tid] = 0.f;
      }
      __syncthreads();
      const int nv = min(TILE, N - t0);
      outer_acc<T, C, D, false>(a_wv, t_xn, t_dv, nv);
      racc += row_sum(t_r, D, nv);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < C * D / THREADS; ++i)
      dwv[static_cast<size_t>(b) * C * D + tid + i * THREADS] = a_wv[i];
    if (tid < D) s_r[tid] = racc;
    __syncthreads();
  }

  // ---- pass K: dk = ks (dks - r_d) -> dxn += W_k dk; dW_k -----------------
  {
    float* t_xn = s_tile;           // (C, LD) xn
    float* t_dk = t_xn + C * LD;    // (D, LD) dk, rounded
    float* t_v = t_dk + D * LD;     // (D, LD) v, rounded
    float a_wk[C * D / THREADS];
#pragma unroll
    for (int i = 0; i < C * D / THREADS; ++i) a_wk[i] = 0.f;
    for (int t0 = 0; t0 < N; t0 += TILE) {
      const int n = t0 + tid;
      if (n < N) {
        float kw[D], dk[D];
        ksoft(n, kw);
        dks_of(n, dk, t_v);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          dk[d] = rnd<T>(kw[d] * (dk[d] - s_r[d]));
          t_dk[d * LD + tid] = dk[d];
        }
        dxn_write(n, s_wk, dk, true);
        xnorm_to_tile(n, t_xn);
      } else {
#pragma unroll 1
        for (int r = 0; r < C + D; ++r) s_tile[r * LD + tid] = 0.f;
      }
      __syncthreads();
      outer_acc<T, C, D, false>(a_wk, t_xn, t_dk, min(TILE, N - t0));
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < C * D / THREADS; ++i)
      dwk[static_cast<size_t>(b) * C * D + tid + i * THREADS] = a_wk[i];
  }

  // ---- pass P: pre-GN backward sums, d gamma_pre, d beta_pre -------------
  float T1, T2;
  {
    float t1 = 0.f, t2 = 0.f, racc = 0.f;
    for (int t0 = 0; t0 < N; t0 += TILE) {
      const int n = t0 + tid;
      if (n < N) {
#pragma unroll 1
        for (int c0 = 0; c0 < C; c0 += 8) {
          float xr[8], dr[8];
          load8<T>(xb + static_cast<size_t>(n) * C + c0, xr);
          load8<float>(dxnb + static_cast<size_t>(n) * C + c0, dr);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int c = c0 + i;
            const float xh = (xr[i] - mu) * inv;
            const float dxh = s_g1[c] * dr[i];
            t1 += dxh;
            t2 += dxh * xh;
            s_tile[c * LD + tid] = dr[i] * xh;
            s_tile[(C + c) * LD + tid] = dr[i];
          }
        }
      } else {
#pragma unroll 1
        for (int c = 0; c < 2 * C; ++c) s_tile[c * LD + tid] = 0.f;
      }
      __syncthreads();
      racc += row_sum(s_tile, 2 * C, min(TILE, N - t0));
      __syncthreads();
    }
    if (tid < C) dg1[b * C + tid] = racc;
    else if (tid < 2 * C) db1[b * C + tid - C] = racc;
    T1 = block_sum<THREADS>(t1, s_red);
    T2 = block_sum<THREADS>(t2, s_red);
  }

  // ---- pass F: dx = inv (g1 dxn - T1/(NC) - xhat T2/(NC)) + g ------------
  const float t1n = T1 / denom, t2n = T2 / denom;
  for (int n = tid; n < N; n += THREADS) {
#pragma unroll 1
    for (int c0 = 0; c0 < C; c0 += 8) {
      float xr[8], dr[8], gr[8];
      load8<T>(xb + static_cast<size_t>(n) * C + c0, xr);
      load8<float>(dxnb + static_cast<size_t>(n) * C + c0, dr);
      load8<T>(gb + static_cast<size_t>(n) * C + c0, gr);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = c0 + i;
        const float xh = (xr[i] - mu) * inv;
        xr[i] = inv * (s_g1[c] * dr[i] - t1n - xh * t2n) + gr[i];
      }
      constexpr int PER = 16 / sizeof(T);
#pragma unroll
      for (int i = 0; i < 8 / PER; ++i)
        store16(dxb + static_cast<size_t>(n) * C + c0 + i * PER, xr + i * PER);
    }
  }
}

template <typename T, int C>
int launch(const void* x, const void* g, const void* gps, const void* gpb, const void* w_qkv,
           const void* w_out, const void* b_out, const void* gos, void* const* scr,
           void* dx, void* const* grads, int B, int N, float eps, cudaStream_t stream) {
  const size_t smem = smem_floats<C>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attention_block_bwd_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_block_bwd_kernel<T, C><<<B, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const float*>(gps),
      static_cast<const float*>(gpb), static_cast<const T*>(w_qkv),
      static_cast<const T*>(w_out), static_cast<const float*>(b_out),
      static_cast<const float*>(gos), static_cast<float*>(scr[0]),
      static_cast<float*>(scr[1]), static_cast<float*>(scr[2]), static_cast<float*>(scr[3]),
      static_cast<float*>(scr[4]), static_cast<T*>(dx), static_cast<float*>(grads[0]),
      static_cast<float*>(grads[1]), static_cast<float*>(grads[2]),
      static_cast<float*>(grads[3]), static_cast<float*>(grads[4]),
      static_cast<float*>(grads[5]), static_cast<float*>(grads[6]),
      static_cast<float*>(grads[7]), static_cast<float*>(grads[8]), N, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scratch: y, dxn (B, N, C) and k, v, q (B, N, D), all f32;
// grads (per sample, f32): dg1, db1 (B, C); dwq, dwk, dwv (B, C, D);
// dwo (B, D, C); dbo, dg2, db2 (B, C)
extern "C" int calo_attention_block_backward(const void* x, const void* g,
                                             const void* gn_pre_scale, const void* gn_pre_bias,
                                             const void* w_qkv, const void* w_out,
                                             const void* b_out, const void* gn_post_scale,
                                             void* const* scratch, void* dx,
                                             void* const* grads, int B, int N, int C,
                                             int is_bf16, float eps, void* stream) {
  if (B < 1 || N < 1 || !is_variant(is_bf16, C)) return static_cast<int>(cudaErrorInvalidValue);
  return launch<VariantT, CALO_C>(x, g, gn_pre_scale, gn_pre_bias, w_qkv, w_out, b_out,
                                  gn_post_scale, scratch, dx, grads, B, N, eps,
                                  static_cast<cudaStream_t>(stream));
}
