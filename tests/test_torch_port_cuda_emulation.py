"""calodiffusion_tpu_torch's CUDA kernels run on the CPU under emulation,
against their plain versions.

There is no CUDA compiler here, so each ``csrc/*.cu`` variant is compiled
with the host C++ compiler against ``EMULATION_HEADER`` below: every CUDA
thread of a block is a std::thread, ``__syncthreads``/``__syncwarp`` are
std::barriers, warp shuffles go through a per-warp buffer, shared memory is
filled with NaN so a read before a write shows.  The kernel launch
``kernel<<<grid, block, smem, stream>>>(args)`` is rewritten into a call
that runs the block's threads.  The libraries expose the same C entries as
the nvcc builds and are called through the ops modules' ``launch*``
functions with CPU tensors: K1/K2/K3 (``ops/linear_attention.py``), K4 and
its backward (``ops/attention.py``), K5 (``ops/groupnorm.py``), Q1 (the int8
convolution, ``ops/int8_conv.py``).  A source
with several launches runs them in turn.  This checks the
kernels' arithmetic, indexing, masking and barriers; it says nothing about
their speed, and the card's own compiler may still refuse what g++ takes.
Tolerances are the on-card ones (``ops/tolerances.py``).
"""

import ctypes
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from calodiffusion_tpu_torch.ops import attention as tatt
from calodiffusion_tpu_torch.ops import cuda_build
from calodiffusion_tpu_torch.ops import groupnorm as tgn
from calodiffusion_tpu_torch.ops import int8_conv as tq1
from calodiffusion_tpu_torch.ops import linear_attention as tattn
from calodiffusion_tpu_torch.ops.tolerances import (K1_TOL, K2_TOL, K3_TOL, K4_TOL, K4B_TOL,
                                                    K5_TOL)

# every (kernel, variant) of the three ops modules
JOBS = (tattn.BUILDS + tatt.KERNEL.builds + tatt.BACKWARD_KERNEL.builds + tgn.KERNEL.builds
        + tq1.KERNEL.builds)
# one library a dtype
ONE_DTYPE_KERNELS = {k.name: k for k in (tatt.KERNEL, tatt.BACKWARD_KERNEL, tgn.KERNEL,
                                         tq1.KERNEL)}


def _job(module, dtype, kernel="KERNEL"):
    """The (kernel, variant) of K4's, K4's backward's or K5's library for ``dtype``."""
    return getattr(module, kernel).name, cuda_build.dtype_variant(dtype)


EMULATION_HEADER = r"""
// CPU emulation of the CUDA subset the attention kernels use: one std::thread
// per CUDA thread, std::barrier for __syncthreads/__syncwarp, shuffles,
// mma.sync and ldmatrix via per-warp buffers, cp.async as copies deferred to
// their wait, the CTAs of a thread-block cluster run together (cluster.sync
// a barrier over their threads, map_shared_rank onto the other CTA's
// buffer); Hopper's mbarriers (arrivals, transaction bytes, phases), TMA
// tiles (swizzled, landing when issued), and wgmma (register A gathered
// over the warpgroup when issued, run at the wait_group that retires it, B
// read through the descriptor then); setmaxnreg a no-op.
// Shared memory is poisoned with NaN (all-ones bytes: NaN as f32 and as
// bf16).
#pragma once
#include <math.h>
#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstdint>
#include <cstring>
#include <cstddef>
#include <barrier>
#include <thread>
#include <vector>
#include <memory>
#include <algorithm>
#include <utility>
using std::min; using std::max;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)

struct EmuDim { int x = 0, y = 0, z = 0; };
inline thread_local EmuDim threadIdx, blockIdx, gridDim;

struct uint4 { unsigned x, y, z, w; };
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct int2 { int x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline int2 make_int2(int a, int b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }

struct __nv_bfloat16 { uint16_t v; };
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
inline float __bfloat162float(__nv_bfloat16 h) { return __uint_as_float(unsigned(h.v) << 16); }
inline __nv_bfloat16 __float2bfloat16(float f) {
  unsigned u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {uint16_t((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {uint16_t(u >> 16)};
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 h) { return h.v; }
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}
inline float rsqrtf(float v) { return 1.0f / std::sqrt(v); }
// one rounding each, never contracted into an FMA
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 0;
constexpr int cudaFuncAttributeNonPortableClusterSizeAllowed = 1, cudaErrorInvalidConfiguration = 9;
constexpr int cudaDevAttrMaxSharedMemoryPerBlockOptin = 97;
// the kernels that may take clusters past the portable 8, and each
// kernel's dynamic shared memory limit (48 KB until raised), as the card
// keeps them per kernel
inline std::vector<const void*> emu_nonportable;
inline std::vector<std::pair<const void*, int>> emu_smem_limit;
template <class F> int cudaFuncSetAttribute(F f, int attr, int v) {
  const void* k = reinterpret_cast<const void*>(f);
  if (attr == cudaFuncAttributeNonPortableClusterSizeAllowed && v) emu_nonportable.push_back(k);
  if (attr == cudaFuncAttributeMaxDynamicSharedMemorySize) emu_smem_limit.emplace_back(k, v);
  return 0;
}
inline size_t emu_smem_of(const void* k) {
  size_t limit = 48 * 1024;
  for (const auto& e : emu_smem_limit)
    if (e.first == k) limit = e.second;
  return limit;
}
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
// an H100's shared memory a block; a card of one SM (or of $CALO_EMU_SMS),
// so that a tiny grid reaches the plans a kernel keeps for grids that fill
// the card
constexpr int cudaDevAttrMultiProcessorCount = 16;
inline int cudaDeviceGetAttribute(int* v, int attr, int) {
  const char* sms = std::getenv("CALO_EMU_SMS");
  *v = attr == cudaDevAttrMultiProcessorCount ? (sms ? std::atoi(sms) : 1) : 232448;
  return 0;
}

struct EmuCluster {
  std::barrier<>* bar;
  std::vector<float*> smem;  // each CTA's shared memory, by rank
};
struct EmuBlock {
  std::barrier<>* bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
  std::vector<float> shfl;
  std::vector<unsigned> words;     // 32 lanes x 6 words a warp (mma operands)
  std::vector<const void*> ptrs;   // 32 lanes a warp (ldmatrix row addresses)
  std::vector<std::unique_ptr<std::barrier<>>> wg_bars;  // a warpgroup's (wgmma operands)
  std::vector<unsigned> wg_words;  // 4 words a thread (wgmma A fragments)
  float* smem;
  EmuCluster* cluster;
  unsigned rank;
};
inline thread_local EmuBlock* emu_block;
inline void __syncthreads() { emu_block->bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_block->warp_bars[threadIdx.x >> 5]->arrive_and_wait(); }
inline float __shfl_sync(unsigned, float v, int src) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  float* buf = emu_block->shfl.data() + w * 32;
  buf[lane] = v;
  __syncwarp();
  const float r = buf[src & 31];
  __syncwarp();
  return r;
}
inline float __shfl_xor_sync(unsigned, float v, int o) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  float* buf = emu_block->shfl.data() + w * 32;
  buf[lane] = v;
  __syncwarp();
  const float r = buf[lane ^ o];
  __syncwarp();
  return r;
}

// ldmatrix .x4 (.trans): lane l gives row l & 7 of matrix l >> 3; each lane
// gathers its two b16 elements of each matrix from the rows' owners
inline void emu_ldmatrix(unsigned (&r)[4], const void* p, bool trans) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const void** rows = emu_block->ptrs.data() + w * 32;
  rows[lane] = p;
  __syncwarp();
  for (int i = 0; i < 4; ++i) {
    r[i] = 0;
    for (int h = 0; h < 2; ++h) {
      const int row = trans ? 2 * (lane & 3) + h : lane >> 2;
      const int col = trans ? lane >> 2 : 2 * (lane & 3) + h;
      r[i] |= unsigned(static_cast<const uint16_t*>(rows[8 * i + row])[col]) << (16 * h);
    }
  }
  __syncwarp();
}

// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32, d += a b: each lane
// gathers row g (g + 8) of A and column 2t (2t + 1) of B from the lanes
// that hold them in the PTX ISA's fragment layout
inline void emu_mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  unsigned* buf = emu_block->words.data() + w * 32 * 6;
  for (int i = 0; i < 4; ++i) buf[lane * 6 + i] = a[i];
  buf[lane * 6 + 4] = b0;
  buf[lane * 6 + 5] = b1;
  __syncwarp();
  auto elem = [&](int owner, int reg, int k) {
    return __uint_as_float((k & 1) ? buf[owner * 6 + reg] & 0xffff0000u : buf[owner * 6 + reg] << 16);
  };
  const int g = lane >> 2, t = lane & 3;
  float out[4];
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i >> 1), col = 2 * t + (i & 1);
    float acc = d[i];
    for (int k = 0; k < 16; ++k) {
      const float av = elem((row & 7) * 4 + (k & 7) / 2, (row >> 3) + 2 * (k >> 3), k);
      const float bv = elem(col * 4 + (k & 7) / 2, 4 + (k >> 3), k);
      acc += av * bv;
    }
    out[i] = acc;
  }
  __syncwarp();
  for (int i = 0; i < 4; ++i) d[i] = out[i];
}

// mma.sync.m16n8k32.row.col.s32.s8.s8.s32, d += a b: a register holds 4
// int8 (the lowest k in the low byte); A element (row, k) lies in lane
// (row & 7) * 4 + (k & 15) / 4, register (row >> 3) + 2 (k >> 4); B element
// (k, col) in lane col * 4 + (k & 15) / 4, register k >> 4 (the PTX ISA's
// fragment layouts); C as the bf16 mma's, in s32
inline void emu_mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  unsigned* buf = emu_block->words.data() + w * 32 * 6;
  for (int i = 0; i < 4; ++i) buf[lane * 6 + i] = a[i];
  buf[lane * 6 + 4] = b0;
  buf[lane * 6 + 5] = b1;
  __syncwarp();
  auto elem = [&](int owner, int reg, int k) {
    return int(int8_t(uint8_t(buf[owner * 6 + reg] >> (8 * (k & 3)))));
  };
  const int g = lane >> 2, t = lane & 3;
  int out[4];
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i >> 1), col = 2 * t + (i & 1);
    int acc = d[i];
    for (int k = 0; k < 32; ++k) {
      acc += elem((row & 7) * 4 + (k & 15) / 4, (row >> 3) + 2 * (k >> 4), k) *
             elem(col * 4 + (k & 15) / 4, 4 + (k >> 4), k);
    }
    out[i] = acc;
  }
  __syncwarp();
  for (int i = 0; i < 4; ++i) d[i] = out[i];
}

// cp.async: a copy is queued and lands when a wait retires its group, so a
// read before the wait finds the poison
struct EmuCopy { void* dst; const void* src; bool full; };
inline thread_local std::vector<EmuCopy> emu_cp_open;
inline thread_local std::vector<std::vector<EmuCopy>> emu_cp_groups;
inline void emu_cp_async16(void* dst, const void* src, bool full) { emu_cp_open.push_back({dst, src, full}); }
inline void emu_cp_async_commit() { emu_cp_groups.push_back(std::move(emu_cp_open)); emu_cp_open.clear(); }
inline void emu_cp_async_wait(int n) {
  while (static_cast<int>(emu_cp_groups.size()) > n) {
    for (const EmuCopy& c : emu_cp_groups.front()) {
      if (c.full) std::memcpy(c.dst, c.src, 16); else std::memset(c.dst, 0, 16);
    }
    emu_cp_groups.erase(emu_cp_groups.begin());
  }
}

// ---- Hopper (hopper.cuh): shared addresses, mbarriers, TMA, wgmma ----
#define __grid_constant__
inline unsigned emu_smem_addr(const void* p) {
  return unsigned(static_cast<const char*>(p) - reinterpret_cast<const char*>(emu_block->smem));
}
// the 64-byte swizzle of a shared address: bits [4, 6) XOR bits [7, 9)
inline unsigned emu_swizzle64(unsigned addr) { return addr ^ (((addr >> 7) & 3u) << 4); }
inline uint16_t emu_smem_u16(unsigned addr) {
  uint16_t v;
  std::memcpy(&v, reinterpret_cast<const char*>(emu_block->smem) + addr, 2);
  return v;
}

// an mbarrier in its 8 bytes of shared memory: pending arrivals [0, 20),
// expected arrivals [20, 40), transaction bytes + 2^22 [40, 63), phase bit 63;
// a phase completes when no arrival and no byte is pending
constexpr int64_t EMU_TX0 = int64_t(1) << 22;
inline uint64_t emu_mbar_pack(uint64_t pend, uint64_t expect, int64_t tx, uint64_t phase) {
  return pend | (expect << 20) | (uint64_t(tx + EMU_TX0) << 40) | (phase << 63);
}
inline void emu_mbar_init(uint64_t* bar, unsigned count) { *bar = emu_mbar_pack(count, count, 0, 0); }
inline void emu_mbar_update(uint64_t* bar, unsigned arrivals, int64_t tx) {
  std::atomic_ref<uint64_t> a(*bar);
  uint64_t v = a.load(), nv;
  do {
    uint64_t pend = v & 0xfffff, expect = (v >> 20) & 0xfffff, phase = v >> 63;
    int64_t bytes = int64_t((v >> 40) & 0x7fffff) - EMU_TX0 + tx;
    if (arrivals > pend) { std::fprintf(stderr, "emulation: mbarrier over-arrived\n"); std::abort(); }
    pend -= arrivals;
    if (pend == 0 && bytes == 0) { pend = expect; phase ^= 1; }
    nv = emu_mbar_pack(pend, expect, bytes, phase);
  } while (!a.compare_exchange_weak(v, nv));
}
// until the phase of this parity has completed (the phase bit differs from it)
inline void emu_mbar_wait(uint64_t* bar, unsigned parity) {
  std::atomic_ref<uint64_t> a(*bar);
  const auto deadline = std::chrono::steady_clock::now() + std::chrono::seconds(120);
  for (int spin = 0; (a.load() >> 63) == parity; ++spin) {
    if (spin < 64) { std::this_thread::yield(); continue; }
    std::this_thread::sleep_for(std::chrono::microseconds(20));
    if (std::chrono::steady_clock::now() > deadline) {
      std::fprintf(stderr, "emulation: mbarrier wait never completed (a deadlock)\n");
      std::abort();
    }
  }
}

// a tensor map: a 3-D bf16 tensor (dims innermost first) in boxes of
// (dim0, box_rows, 1), 64-byte swizzled, rows past the tensor read as zeros
struct CUtensorMap { const char* base; long long dims[3]; int box_rows; };
inline int emu_encode_tile_map(CUtensorMap* m, const void* base, int d0, int d1, int d2,
                               int box_rows) {
  if (d0 * 2 != 64) return 1;  // the box's row is the swizzle's width
  *m = {static_cast<const char*>(base), {d0, d1, d2}, box_rows};
  return 0;
}
// the box lands in shared memory when issued, swizzled, and completes its bytes
inline void emu_tma_load_3d(void* dst, const CUtensorMap* m, int c0, int c1, int c2, uint64_t* bar) {
  char* sm = reinterpret_cast<char*>(emu_block->smem);
  const unsigned d = emu_smem_addr(dst);
  const int row_bytes = int(m->dims[0]) * 2;
  for (int r = 0; r < m->box_rows; ++r) {
    const long long y = c1 + r;
    const bool in = c0 == 0 && y < m->dims[1] && c2 < m->dims[2];
    for (int b = 0; b < row_bytes; ++b)
      sm[emu_swizzle64(d + r * row_bytes + b)] =
          in ? m->base[(c2 * m->dims[1] + y) * row_bytes + b] : 0;
  }
  emu_mbar_update(bar, 0, -int64_t(m->box_rows) * row_bytes);
}
inline void emu_bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  std::memcpy(dst, src, bytes);
  emu_mbar_update(bar, 0, -int64_t(bytes));
}

// the shared address of element (mn, k) of a k-step through a wgmma
// descriptor, K-major or MN-major, after the PTX ISA's canonical layouts
// with the 64-byte swizzle (layout type 2; any other type aborts)
inline unsigned emu_desc_addr(uint64_t desc, int mn, int k, bool mn_major) {
  const unsigned start = unsigned(desc & 0x3fff) << 4, lbo = unsigned((desc >> 16) & 0x3fff) << 4;
  const unsigned sbo = unsigned((desc >> 32) & 0x3fff) << 4;
  if ((desc >> 62) != 2) { std::fprintf(stderr, "emulation: a descriptor's swizzle is not 64-byte\n"); std::abort(); }
  const unsigned off =
      mn_major ? 2 * (mn % 32) + (mn / 32) * lbo + (k & 7) * 64 + (k >> 3) * sbo  // mn along 64-byte rows, atoms LBO apart; k rows, 8 a group
               : (mn & 7) * 64 + (mn >> 3) * sbo + 2 * k;                          // rows of mn, 8 a group SBO apart; k along the row
  return emu_swizzle64(start + off);
}
inline float emu_bf16(unsigned addr) { return __uint_as_float(unsigned(emu_smem_u16(addr)) << 16); }

// wgmma.mma_async m64nNk16 (bf16) or m64nNk32 (s8): a thread's part of
// the product (its D fragment), queued when issued and run at the
// wait_group that retires it
struct EmuWgmma {
  float* d; int n, trans_b, scale_d, row0; uint64_t db; float a[2][16];
  int* di = nullptr; uint64_t da = 0; bool a_in_smem = false; int8_t a8[2][32] = {};
};
inline thread_local std::vector<EmuWgmma> emu_wg_open;
inline thread_local std::vector<std::vector<EmuWgmma>> emu_wg_groups;
inline void emu_wgmma(float* d, int n, const unsigned* a, uint64_t db, int trans_b, int scale_d) {
  const int tid = threadIdx.x & 127, lane = tid & 31, warp = tid >> 5, g = lane >> 2;
  EmuWgmma op{d, n, trans_b, scale_d, warp * 16 + g, db, {}};
  // rows g, g + 8 of the warp's 16 from the lanes holding them (m16n8k16 A layout)
  std::barrier<>& bar = *emu_block->wg_bars.at(threadIdx.x >> 7);
  unsigned* buf = emu_block->wg_words.data() + (threadIdx.x >> 7) * 512;
  for (int i = 0; i < 4; ++i) buf[tid * 4 + i] = a[i];
  bar.arrive_and_wait();
  for (int r = 0; r < 2; ++r)
    for (int k = 0; k < 16; ++k) {
      const unsigned w = buf[(warp * 32 + g * 4 + (k & 7) / 2) * 4 + r + 2 * (k >> 3)];
      op.a[r][k] = __uint_as_float((k & 1) ? w & 0xffff0000u : w << 16);
    }
  bar.arrive_and_wait();
  emu_wg_open.push_back(op);
}
// byte k of K-major row mn of an s8 k-step through a descriptor: rows of
// 64 bytes, 8 a group SBO apart, the 64-byte swizzle (layout type 2)
inline int emu_desc_s8(uint64_t desc, int mn, int k) {
  const unsigned start = unsigned(desc & 0x3fff) << 4, sbo = unsigned((desc >> 32) & 0x3fff) << 4;
  if ((desc >> 62) != 2) { std::fprintf(stderr, "emulation: a descriptor's swizzle is not 64-byte\n"); std::abort(); }
  const unsigned addr = emu_swizzle64(start + (mn & 7) * 64 + (mn >> 3) * sbo + k);
  return int8_t(reinterpret_cast<const char*>(emu_block->smem)[addr]);
}
// wgmma.mma_async m64nNk32.s32.s8.s8: A from registers (gathered over the
// warpgroup when issued: byte k of row r of the warp's 16 in lane
// (r & 7) * 4 + (k & 15) / 4, register (r >> 3) + 2 (k >> 4), the PTX
// ISA's A fragment layout) or, a == nullptr, through descriptor da when run
inline void emu_wgmma_s8(int* d, int n, const unsigned* a, uint64_t da, uint64_t db, int scale_d) {
  const int tid = threadIdx.x & 127, lane = tid & 31, warp = tid >> 5, g = lane >> 2;
  EmuWgmma op{nullptr, n, 0, scale_d, warp * 16 + g, db, {}};
  op.di = d;
  op.da = da;
  op.a_in_smem = a == nullptr;
  if (a != nullptr) {
    std::barrier<>& bar = *emu_block->wg_bars.at(threadIdx.x >> 7);
    unsigned* buf = emu_block->wg_words.data() + (threadIdx.x >> 7) * 512;
    for (int i = 0; i < 4; ++i) buf[tid * 4 + i] = a[i];
    bar.arrive_and_wait();
    for (int r = 0; r < 2; ++r)
      for (int k = 0; k < 32; ++k) {
        const unsigned w = buf[(warp * 32 + g * 4 + (k & 15) / 4) * 4 + r + 2 * (k >> 4)];
        op.a8[r][k] = int8_t(uint8_t(w >> (8 * (k & 3))));
      }
    bar.arrive_and_wait();
  }
  emu_wg_open.push_back(op);
}
inline void emu_wgmma_run(const EmuWgmma& op) {
  const int t = (threadIdx.x & 127) & 3;
  if (op.di != nullptr) {  // s8
    for (int i = 0; i < op.n / 2; ++i) {
      const int r = (i >> 1) & 1, row = op.row0 + 8 * r, col = 8 * (i >> 2) + 2 * t + (i & 1);
      int acc = op.scale_d ? op.di[i] : 0;
      for (int k = 0; k < 32; ++k)
        acc += (op.a_in_smem ? emu_desc_s8(op.da, row, k) : int(op.a8[r][k])) *
               emu_desc_s8(op.db, col, k);
      op.di[i] = acc;
    }
    return;
  }
  for (int i = 0; i < op.n / 2; ++i) {
    const int r = (i >> 1) & 1, row = op.row0 + 8 * r, col = 8 * (i >> 2) + 2 * t + (i & 1);
    float acc = op.scale_d ? op.d[i] : 0.f;
    for (int k = 0; k < 16; ++k) {
      acc += op.a[r][k] * emu_bf16(emu_desc_addr(op.db, col, k, op.trans_b));
    }
    op.d[i] = acc;
  }
}
inline void emu_wgmma_commit() { emu_wg_groups.push_back(std::move(emu_wg_open)); emu_wg_open.clear(); }
inline void emu_wgmma_wait(int n) {
  while (static_cast<int>(emu_wg_groups.size()) > n) {
    for (const EmuWgmma& op : emu_wg_groups.front()) emu_wgmma_run(op);
    emu_wg_groups.erase(emu_wg_groups.begin());
  }
}

namespace cooperative_groups {
struct cluster_group {
  unsigned block_rank() const { return emu_block->rank; }
  unsigned num_blocks() const { return static_cast<unsigned>(emu_block->cluster->smem.size()); }
  void sync() const { emu_block->cluster->bar->arrive_and_wait(); }
  template <class T> T* map_shared_rank(T* p, unsigned r) const {
    const std::ptrdiff_t off = reinterpret_cast<char*>(p) - reinterpret_cast<char*>(emu_block->smem);
    return reinterpret_cast<T*>(reinterpret_cast<char*>(emu_block->cluster->smem[r]) + off);
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups

// the CTAs of each cluster of `csize` run together, one std::thread a CUDA thread
template <class F> void emu_launch_cluster(int grid, int block, size_t smem, int csize, F f) {
  for (int c0 = 0; c0 < grid; c0 += csize) {
    std::vector<std::vector<float>> sm(csize);
    std::barrier<> cbar(block * csize);
    EmuCluster cl;
    cl.bar = &cbar;
    std::vector<std::unique_ptr<std::barrier<>>> bars;
    std::vector<EmuBlock> eb(csize);
    for (int r = 0; r < csize; ++r) {
      sm[r].resize(smem / 4 + 4);
      std::memset(sm[r].data(), 0xff, sm[r].size() * 4);
      cl.smem.push_back(sm[r].data());
      bars.emplace_back(new std::barrier<>(block));
      eb[r].bar = bars.back().get();
      for (int w = 0; w < block / 32; ++w) eb[r].warp_bars.emplace_back(new std::barrier<>(32));
      eb[r].shfl.assign(block, 0.f);
      eb[r].words.assign(block * 6, 0u);
      eb[r].ptrs.assign(block, nullptr);
      for (int w = 0; w < block / 128; ++w) eb[r].wg_bars.emplace_back(new std::barrier<>(128));
      eb[r].wg_words.assign(block * 4, 0u);
      eb[r].smem = sm[r].data();
      eb[r].cluster = &cl;
      eb[r].rank = r;
    }
    std::vector<std::thread> ts;
    for (int r = 0; r < csize; ++r)
      for (int t = 0; t < block; ++t)
        ts.emplace_back([&, r, t] {
          threadIdx.x = t; blockIdx.x = c0 + r; gridDim.x = grid; emu_block = &eb[r]; f();
        });
    for (auto& th : ts) th.join();
  }
}
template <class F> void emu_launch(int grid, int block, size_t smem, F f) {
  emu_launch_cluster(grid, block, smem, 1, f);
}

struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
constexpr int cudaLaunchAttributeClusterDimension = 4;
struct cudaLaunchAttributeValue { struct { unsigned x, y, z; } clusterDim; };
struct cudaLaunchAttribute { int id; cudaLaunchAttributeValue val; };
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
inline int emu_cluster_size(const cudaLaunchConfig_t* cfg) {
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension) return cfg->attrs[i].val.clusterDim.x;
  return 1;
}
template <class... P, class... A> int cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*k)(P...), A... args) {
  if (cfg->dynamicSmemBytes > emu_smem_of(reinterpret_cast<const void*>(k))) return cudaErrorInvalidConfiguration;
  emu_launch_cluster(cfg->gridDim.x, cfg->blockDim.x, cfg->dynamicSmemBytes, emu_cluster_size(cfg),
                     [&] { k(static_cast<P>(args)...); });
  return 0;
}
// a CTA an SM where its dynamic shared memory fits the kernel's limit
template <class F> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F f, int, size_t smem) {
  *n = smem <= emu_smem_of(reinterpret_cast<const void*>(f)) ? 1 : 0;
  return 0;
}
// an H100 places clusters of up to 8 CTAs, and of 16 for a kernel that allows it
template <class F> int cudaOccupancyMaxActiveClusters(int* n, F f, const cudaLaunchConfig_t* cfg) {
  const int size = emu_cluster_size(cfg);
  const bool allowed = std::find(emu_nonportable.begin(), emu_nonportable.end(),
                                 reinterpret_cast<const void*>(f)) != emu_nonportable.end();
  const bool fits = cfg->dynamicSmemBytes <= emu_smem_of(reinterpret_cast<const void*>(f));
  *n = fits && (size <= 8 || (size <= 16 && allowed)) ? 1 : 0;
  return 0;
}
"""

_LAUNCH = re.compile(r"(\w+(?:<[\w, ]+>)?)<<<([\w *+()/-]+?), (\w+), (\w+), (\w+)>>>\((.*?)\);",
                     re.S)


def _build(out_dir, name, defines):
    src = (cuda_build.CSRC_DIR / f"{name}.cu").read_text()
    # a source that includes another (K3 includes K1's) is rewritten whole
    src = re.sub(r'#include "(\w+\.cu)"\n',
                 lambda m: (cuda_build.CSRC_DIR / m.group(1)).read_text(), src)
    src = src.replace("extern __shared__ __align__(16) float smem[];",
                      "float* smem = emu_block->smem;")
    src, n = _LAUNCH.subn(r"emu_launch(\2, \3, \4, [&] { \1(\6); });", src)
    # <<<...>>> launches (each rewritten), or a cluster launch through cudaLaunchKernelEx
    assert "<<<" not in src, f"{name}.cu: a kernel launch the emulation cannot rewrite"
    assert n + src.count("cudaLaunchKernelEx(") >= 1, f"{name}.cu: expected a kernel launch"
    tag = "_".join(d.replace("=", "") for d in defines)
    cpp, so = out_dir / f"{name}_{tag}.cpp", out_dir / f"{name}_{tag}.so"
    cpp.write_text(src)
    cmd = ["g++", "-std=c++20", "-O1", "-fno-strict-aliasing", "-shared", "-fPIC", "-pthread",
           f"-I{out_dir}", f"-I{cuda_build.CSRC_DIR}", "-DCALO_EMULATION",
           *(f"-D{d}" for d in defines), "-o", str(so), str(cpp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    if name in ONE_DTYPE_KERNELS:
        return (name, defines), ONE_DTYPE_KERNELS[name].bind(lib)
    return (name, defines), tattn.bind(lib, name)


def _emulation_dir(tmp_path_factory):
    """A directory holding the emulation header under the CUDA headers' names."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernels for the CPU emulation")
    out = tmp_path_factory.mktemp("cuda_emulation")
    for name in ("cuda_emu.h", "cuda_bf16.h", "cuda_runtime.h", "cooperative_groups.h",
                 "cuda.h"):
        (out / name).write_text(EMULATION_HEADER if name == "cuda_emu.h"
                                else '#include "cuda_emu.h"\n')
    return out


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Every (kernel, variant) of the ops modules compiled for the emulation."""
    out = _emulation_dir(tmp_path_factory)
    with ThreadPoolExecutor(4) as pool:
        return dict(pool.map(lambda job: _build(out, *job), JOBS))


# One warp computes a (16 x 16) (16 x 16) product through common.cuh's
# mma_bf16_16816 (two n-tiles of 8), its operands loaded either element by
# element after the PTX ISA's fragment layouts or by ldmatrix (A) and
# ldmatrix.trans (B) from row-major tiles in shared memory, as the kernels
# load them.
TILE_MMA_SOURCE = r"""
#include "common.cuh"
using namespace calo;
extern "C" void tile_mma(const uint16_t* a, const uint16_t* b, float* c, int via_ldmatrix) {
  emu_launch(1, 32, 2 * 256 * 2, [&] {
    const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
    unsigned af[4], bf[2][2];
    if (via_ldmatrix) {
      uint16_t* sa = reinterpret_cast<uint16_t*>(emu_block->smem);
      uint16_t* sb = sa + 256;
      for (int i = lane; i < 256; i += 32) { sa[i] = a[i]; sb[i] = b[i]; }
      __syncwarp();
      const int row = (lane & 7) + ((lane >> 3) & 1) * 8, col = (lane >> 4) * 8;
      unsigned r[4];
      ldmatrix_x4(af, sa + row * 16 + col);
      ldmatrix_x4_trans(r, sb + row * 16 + col);
      bf[0][0] = r[0]; bf[0][1] = r[1]; bf[1][0] = r[2]; bf[1][1] = r[3];
    } else {
      auto pk = [](uint16_t lo, uint16_t hi) { return unsigned(lo) | (unsigned(hi) << 16); };
      for (int i = 0; i < 4; ++i) {
        const int row = g + 8 * (i & 1), col = 2 * t + 8 * (i >> 1);
        af[i] = pk(a[row * 16 + col], a[row * 16 + col + 1]);
      }
      for (int n = 0; n < 2; ++n)
        for (int j = 0; j < 2; ++j) {
          const int k = 2 * t + 8 * j, col = n * 8 + g;
          bf[n][j] = pk(b[k * 16 + col], b[(k + 1) * 16 + col]);
        }
    }
    for (int n = 0; n < 2; ++n) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16_16816(d, af, bf[n][0], bf[n][1]);
      for (int i = 0; i < 4; ++i) c[(g + 8 * (i >> 1)) * 16 + n * 8 + 2 * t + (i & 1)] = d[i];
    }
  });
}
"""


@pytest.fixture(scope="module")
def tile_mma(tmp_path_factory):
    out = _emulation_dir(tmp_path_factory)
    cpp, so = out / "tile_mma.cpp", out / "tile_mma.so"
    cpp.write_text(TILE_MMA_SOURCE)
    cmd = ["g++", "-std=c++20", "-O1", "-fno-strict-aliasing", "-shared", "-fPIC", "-pthread",
           f"-I{out}", f"-I{cuda_build.CSRC_DIR}", "-DCALO_EMULATION", "-DCALO_BF16=1",
           "-o", str(so), str(cpp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    fn = ctypes.CDLL(str(so)).tile_mma
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    return fn


@pytest.mark.parametrize("via_ldmatrix", [False, True], ids=["fragments", "ldmatrix"])
def test_emulated_mma_matches_matmul(tile_mma, via_ldmatrix):
    """The emulated m16n8k16 bf16 mma (and ldmatrix) against torch.matmul on
    a random tile: the products of bf16 inputs are exact in f32, so only the
    order of 16 f32 sums differs."""
    rng = np.random.default_rng(7 + via_ldmatrix)
    a, b = (torch.from_numpy(rng.standard_normal((16, 16)).astype(np.float32)).bfloat16()
            for _ in range(2))
    c = torch.empty(16, 16)
    tile_mma(a.view(torch.int16).data_ptr(), b.view(torch.int16).data_ptr(), c.data_ptr(),
             int(via_ldmatrix))
    torch.testing.assert_close(c, a.float() @ b.float(), atol=1e-5, rtol=1e-6)


# One warpgroup computes A (64 x K) B (K x N) by hopper.cuh's wgmma
# m64nNk16, K / 16 k-steps, in the two forms K4's backward uses: A from
# registers (loaded after the A fragment layout), and B a tile of rows of
# 32 bf16 loaded by TMA with the 64-byte swizzle (one mbarrier, the tile's
# bytes), read through the kernel's descriptors.  K-major: B^T stored row
# by row, K = 32, N = the streamed tile's rows (S = Q K^T).  MN-major: B
# stored row by row (the transpose bit), N = 32, K = the tile's rows
# (dQ = dS K).  D is stored after the accumulator layout.
TILE_WGMMA_SOURCE = r"""
#include "hopper.cuh"
using namespace calo;
template <int N, int K, int MN>
void run(const uint16_t* a, const uint16_t* b_rows, float* c) {
  constexpr int S = SWIZZLE_BYTES, ROWS = MN ? K : N;  // the tile's rows of 32
  CUtensorMap mb;
  if (encode_tile_map(&mb, b_rows, 32, ROWS, 1, ROWS)) std::abort();
  emu_launch(1, 128, 1024 + ROWS * S + 8, [&] {
    char* tile = align_smem_1024(emu_block->smem);
    uint64_t* bar = reinterpret_cast<uint64_t*>(tile + ROWS * S);
    if (threadIdx.x == 0) {
      mbar_init(bar, 1);
      mbar_arrive_expect_tx(bar, ROWS * S);
      tma_load_3d(tile, &mb, 0, 0, 0, bar);
    }
    __syncthreads();
    mbar_wait(bar, 0);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    float d[N / 2];
    wgmma_fence();
    for (int kk = 0; kk < K / 16; ++kk) {
      const uint64_t db = MN ? smem_desc(tile + 16 * S * kk, 8 * S, 8 * S)
                             : smem_desc(tile + 32 * kk, 16, 8 * S);
      unsigned af[4];
      for (int i = 0; i < 4; ++i) {
        const int row = warp * 16 + g + 8 * (i & 1), col = 16 * kk + 8 * (i >> 1) + 2 * t;
        af[i] = unsigned(a[row * K + col]) | (unsigned(a[row * K + col + 1]) << 16);
      }
      Wgmma<N, MN>::rs(d, af, db, kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    for (int i = 0; i < N / 2; ++i)
      c[(warp * 16 + g + 8 * ((i >> 1) & 1)) * N + 8 * (i >> 2) + 2 * t + (i & 1)] = d[i];
  });
}
extern "C" void tile_wgmma(const uint16_t* a, const uint16_t* b_rows, float* c, int tile,
                           int mn_major) {
  if (mn_major) (tile == 64 ? run<32, 64, 1> : run<32, 128, 1>)(a, b_rows, c);
  else (tile == 64 ? run<64, 32, 0> : run<128, 32, 0>)(a, b_rows, c);
}
"""


@pytest.fixture(scope="module")
def tile_wgmma(tmp_path_factory):
    out = _emulation_dir(tmp_path_factory)
    cpp, so = out / "tile_wgmma.cpp", out / "tile_wgmma.so"
    cpp.write_text(TILE_WGMMA_SOURCE)
    cmd = ["g++", "-std=c++20", "-O1", "-fno-strict-aliasing", "-shared", "-fPIC", "-pthread",
           f"-I{out}", f"-I{cuda_build.CSRC_DIR}", "-DCALO_EMULATION", "-DCALO_BF16=1",
           "-o", str(so), str(cpp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    fn = ctypes.CDLL(str(so)).tile_wgmma
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    return fn


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("b_major", ["k", "mn"])
def test_emulated_wgmma_matches_matmul(tile_wgmma, b_major, tile):
    """The emulated wgmma (register A, B from TMA's 64-byte-swizzled tile
    and an mbarrier) against a float64 product on a random tile, in each
    form K4's backward uses at each tile of its plans: the products of bf16
    inputs are exact, so the f32 sums of K terms lie within K 2^-24 sum |a||b|."""
    k, n = (tile, 32) if b_major == "mn" else (32, tile)
    rng = np.random.default_rng(tile + (b_major == "mn"))
    a = torch.from_numpy(rng.standard_normal((64, k)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).bfloat16()
    b_rows = b if b_major == "mn" else b.t().contiguous()
    c = torch.full((64, n), float("nan"))
    tile_wgmma(a.view(torch.int16).data_ptr(), b_rows.view(torch.int16).data_ptr(), c.data_ptr(),
               tile, int(b_major == "mn"))
    want = a.double() @ b.double()
    bound = k * 2.0 ** -24 * (a.double().abs() @ b.double().abs())
    assert ((c.double() - want).abs() <= bound).all()


def _args(B, N, C, dtype, seed):
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to(dt).contiguous()

    return [t(rng.standard_normal((B, N, C)), dtype),
            t(1.0 + 0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C)),
            t(0.2 * rng.standard_normal((C, 96)), dtype),
            t(0.2 * rng.standard_normal((32, C)), dtype), t(0.1 * rng.standard_normal(C)),
            t(1.0 + 0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C))]


# one position, a partial tile, past a whole tile of 128 and 256, two samples;
# C = 16 and 96 (dataset 1's pion and photon widths): N under one warp's
# tile times the warps of a CTA (20, 28, as the ds1 U-Nets' deepest blocks)
# and past it
SHAPES = [(2, 1, 32), (2, 300, 32), (1, 257, 64), (2, 130, 64), (2, 20, 16), (1, 220, 16),
          (2, 28, 96), (1, 130, 96)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch and two BLAS threads: the Tier-1 run shares the cores
    between six workers."""
    from threadpoolctl import threadpool_limits

    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    with threadpool_limits(limits=2):
        yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("B,N,C", SHAPES)
def test_forward_kernel_matches_plain(libs, B, N, C, dtype):
    args = _args(B, N, C, dtype, seed=B + N + C)
    lib = libs[(tattn.FORWARD_KERNEL, tattn.variant(dtype, C))]
    got = tattn.launch_forward(lib, *args, 1e-5)
    want = tattn.attention_block_reference(*args)
    atol, rtol = K1_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("B,N,C", SHAPES)
def test_backward_kernel_matches_plain(libs, B, N, C, dtype):
    args = _args(B, N, C, dtype, seed=B + N + C + 1)
    g = torch.from_numpy(np.random.default_rng(N).standard_normal((B, N, C)).astype(np.float32))
    g = g.to(dtype)
    lib = libs[(tattn.BACKWARD_KERNEL, tattn.variant(dtype, C))]
    _check_backward(lib, args, g, dtype)


def _check_backward(lib, args, g, dtype, **launch):
    """K2's eight gradients against the plain backward, max-norm relative."""
    got = tattn.launch_backward(lib, *args[:7], g, 1e-5, **launch)
    want = tattn.attention_block_backward_reference(*args, g)
    for i, (a, w) in enumerate(zip(got, want)):
        assert a.shape == w.shape and a.dtype == w.dtype, i
        a, w = a.double(), w.double()
        err = ((a - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
        assert err <= K2_TOL[dtype], f"gradient {i}: max-norm relative error {err:.3g}"


def _grad_out(B, N, C, dtype):
    return torch.from_numpy(
        np.random.default_rng(N).standard_normal((B, N, C)).astype(np.float32)).to(dtype)


# (B, N, C, cluster): N split unevenly over G = 2 and 4 CTAs (the last
# CTA's share short of a whole tile), and G = 4 with an empty CTA (N = 40:
# 16 positions a CTA); C = 16 and 96 split over G = 2
CLUSTER_CASES = [(2, 100, 32, 2), (1, 130, 64, 4), (2, 40, 32, 4), (1, 257, 64, 2),
                 (1, 100, 16, 2), (1, 130, 96, 2)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("B,N,C,cluster", CLUSTER_CASES)
def test_forward_kernel_cluster_matches_plain(libs, B, N, C, cluster, dtype):
    """K1 with its sample split over a cluster of G CTAs, merged over the
    emulated distributed shared memory."""
    args = _args(B, N, C, dtype, seed=B + N + C + cluster)
    lib = libs[(tattn.FORWARD_KERNEL, tattn.variant(dtype, C))]
    plan = tattn.kernel_plan(lib, tattn.FORWARD_KERNEL, N, C, dtype, cluster)
    assert plan["G"] == cluster and plan["x_resident"] and plan["y_resident"]
    got = tattn.launch_forward(lib, *args, 1e-5, cluster=cluster)
    want = tattn.attention_block_reference(*args)
    atol, rtol = K1_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("resident", ["x", "none"])
def test_forward_kernel_off_chip_plans_match_plain(libs, resident, dtype):
    """Where a sample does not fit the cluster's shared memory (a smaller
    limit stands in for a large N here), y and then x too live in device
    memory: the same code on other pointers."""
    B, N, C, cluster = 1, 1400, 32, 2
    lib = libs[(tattn.FORWARD_KERNEL, tattn.variant(dtype, C))]
    K1 = tattn.FORWARD_KERNEL
    limit = tattn.kernel_plan(lib, K1, N, C, dtype, cluster)["smem_bytes"] - 16
    if resident == "none":
        limit = tattn.kernel_plan(lib, K1, N, C, dtype, cluster, smem_limit=limit)["smem_bytes"] - 16
    plan = tattn.kernel_plan(lib, K1, N, C, dtype, cluster, smem_limit=limit)
    assert (plan["x_resident"], plan["y_resident"]) == (resident == "x", False)
    args = _args(B, N, C, dtype, seed=N + len(resident))
    got = tattn.launch_forward(lib, *args, 1e-5, cluster=cluster, smem_limit=limit)
    want = tattn.attention_block_reference(*args)
    atol, rtol = K1_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_forward_plan_picks_the_smallest_cluster_that_holds_a_sample(libs):
    """Against a limit of 227 KB a block: ds2's three N in bf16 and f32."""
    for dtype, C, N, G, resident in ((torch.bfloat16, 32, 6480, 8, True),
                                     (torch.bfloat16, 64, 736, 2, True),
                                     (torch.bfloat16, 32, 736, 1, True),
                                     (torch.bfloat16, 64, 96, 1, True),
                                     (torch.float32, 32, 6480, 8, False),
                                     (torch.float32, 64, 736, 4, True),
                                     (torch.bfloat16, 32, 40500, 8, False)):
        plan = tattn.kernel_plan(libs[(tattn.FORWARD_KERNEL, tattn.variant(dtype, C))],
                                 tattn.FORWARD_KERNEL, N, C, dtype)
        assert (plan["G"], plan["y_resident"]) == (G, resident), (dtype, C, N, plan)
        assert plan["P"] % 16 == 0 and plan["G"] * plan["P"] >= N
        assert plan["smem_bytes"] <= 232448


# K2's cases: K1's in bf16 and f32, and in bf16 (whose plan may take G up to
# 16) G = 16, the non-portable cluster, with 13 CTAs that hold positions and
# 3 empty ones
BACKWARD_CLUSTER_CASES = (
    [(*case, dt) for case in CLUSTER_CASES for dt in (torch.bfloat16, torch.float32)]
    + [(1, 200, 32, 16, torch.bfloat16)])


@pytest.mark.parametrize("B,N,C,cluster,dtype", BACKWARD_CLUSTER_CASES)
def test_backward_kernel_cluster_matches_plain(libs, B, N, C, cluster, dtype):
    """K2 with its sample split over a cluster of G CTAs: every sum and the
    per-sample gradients merged over the emulated distributed shared memory."""
    args = _args(B, N, C, dtype, seed=B + N + C + cluster + 1)
    lib = libs[(tattn.BACKWARD_KERNEL, tattn.variant(dtype, C))]
    plan = tattn.kernel_plan(lib, tattn.BACKWARD_KERNEL, N, C, dtype, cluster)
    assert plan["G"] == cluster
    if dtype == torch.bfloat16:  # f32 at (257, 64) keeps y and dxn in device memory
        assert all(plan[f"{k}_resident"] for k in ("x", "g", "y", "dxn")), plan
    _check_backward(lib, args, _grad_out(B, N, C, dtype), dtype, cluster=cluster)


# what K2 keeps on chip as its shared memory shrinks: dxn leaves first, x last
BACKWARD_MODES = {"x_g_y": 1, "x_g": 2, "x": 3, "none": 4}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("resident", list(BACKWARD_MODES))
def test_backward_kernel_off_chip_plans_match_plain(libs, resident, dtype):
    """Where a sample does not fit the cluster's shared memory (a smaller
    limit stands in for a large N here), dxn, then y, then g, then x live in
    device memory: the same code on other pointers."""
    B, N, C, cluster = 1, 300, 32, 2
    lib = libs[(tattn.BACKWARD_KERNEL, tattn.variant(dtype, C))]
    plan, limit = tattn.kernel_plan(lib, tattn.BACKWARD_KERNEL, N, C, dtype, cluster), 0
    for _ in range(BACKWARD_MODES[resident]):
        limit = plan["smem_bytes"] - 16
        plan = tattn.kernel_plan(lib, tattn.BACKWARD_KERNEL, N, C, dtype, cluster,
                                 smem_limit=limit)
    kept = {k for k in ("x", "g", "y", "dxn") if plan[f"{k}_resident"]}
    assert plan["G"] == cluster and kept == (set(resident.split("_")) - {"none"}), plan
    args = _args(B, N, C, dtype, seed=N + len(resident))
    _check_backward(lib, args, _grad_out(B, N, C, dtype), dtype, cluster=cluster,
                    smem_limit=limit)


def test_backward_plan_picks_the_smallest_cluster_that_holds_a_sample(libs):
    """Against a limit of 227 KB a block: at ds2's (C, N) in bf16, x, g, y
    and dxn stay on chip (G = 16 at N = 6480); where they do not (f32 at
    ds2's largest shapes, ds3's N = 40,500), the largest G (16 bf16, 8 f32)
    keeps part of the sample in device memory."""
    keys = ("x", "g", "y", "dxn")
    for dtype, C, N, G, kept in ((torch.bfloat16, 32, 6480, 16, keys),
                                 (torch.bfloat16, 64, 736, 4, keys),
                                 (torch.bfloat16, 32, 736, 2, keys),
                                 (torch.bfloat16, 32, 96, 1, keys),
                                 (torch.bfloat16, 64, 96, 1, keys),
                                 (torch.float32, 32, 6480, 8, ("x",)),
                                 (torch.float32, 64, 736, 8, ("x", "g", "y")),
                                 (torch.float32, 32, 96, 1, keys),
                                 (torch.bfloat16, 32, 40500, 16, ("x",)),
                                 (torch.float32, 32, 40500, 8, ())):
        plan = tattn.kernel_plan(libs[(tattn.BACKWARD_KERNEL, tattn.variant(dtype, C))],
                                 tattn.BACKWARD_KERNEL, N, C, dtype)
        got = tuple(k for k in keys if plan[f"{k}_resident"])
        assert (plan["G"], got) == (G, kept), (dtype, C, N, plan)
        assert plan["P"] % 16 == 0 and plan["G"] * plan["P"] >= N
        assert plan["smem_bytes"] <= 232448


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("B,N,C,cluster", CLUSTER_CASES)
def test_linear_attention_kernel_cluster_matches_plain(libs, B, N, C, cluster, dtype):
    """K3 (K1's source without its GroupNorms) split over a cluster of G CTAs."""
    x, _, _, w_qkv, w_out, b_out, _, _ = _args(B, N, C, dtype, seed=B + N + C + cluster + 2)
    lib = libs[(tattn.LINEAR_KERNEL, tattn.variant(dtype, C))]
    plan = tattn.kernel_plan(lib, tattn.LINEAR_KERNEL, N, C, dtype, cluster)
    assert plan["G"] == cluster and plan["x_resident"] and not plan["y_resident"]
    got = tattn.launch_linear(lib, x, w_qkv, w_out, b_out, cluster=cluster)
    want = tattn.linear_attention_reference(x, w_qkv, w_out, b_out)
    atol, rtol = K3_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_linear_attention_kernel_off_chip_plan_matches_plain(libs, dtype):
    """K3 with x re-read from device memory (ds3's plan; a smaller limit
    stands in for N = 40,500)."""
    B, N, C, cluster = 1, 1400, 32, 2
    lib = libs[(tattn.LINEAR_KERNEL, tattn.variant(dtype, C))]
    limit = tattn.kernel_plan(lib, tattn.LINEAR_KERNEL, N, C, dtype, cluster)["smem_bytes"] - 16
    plan = tattn.kernel_plan(lib, tattn.LINEAR_KERNEL, N, C, dtype, cluster, smem_limit=limit)
    assert not plan["x_resident"] and not plan["y_resident"], plan
    x, _, _, w_qkv, w_out, b_out, _, _ = _args(B, N, C, dtype, seed=N + 3)
    got = tattn.launch_linear(lib, x, w_qkv, w_out, b_out, cluster=cluster, smem_limit=limit)
    want = tattn.linear_attention_reference(x, w_qkv, w_out, b_out)
    atol, rtol = K3_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_linear_attention_plan_picks_the_smallest_cluster_that_holds_x(libs):
    """Against 227 KB a block, K3 keeps only x: ds2's (C, N) on chip, ds3's
    N = 40,500 re-read from device memory at G = 8."""
    for dtype, C, N, G, resident in ((torch.bfloat16, 32, 6480, 4, True),
                                     (torch.bfloat16, 64, 736, 1, True),
                                     (torch.bfloat16, 32, 96, 1, True),
                                     (torch.float32, 32, 6480, 8, True),
                                     (torch.bfloat16, 32, 40500, 8, False),
                                     (torch.float32, 32, 40500, 8, False)):
        plan = tattn.kernel_plan(libs[(tattn.LINEAR_KERNEL, tattn.variant(dtype, C))],
                                 tattn.LINEAR_KERNEL, N, C, dtype)
        assert (plan["G"], plan["x_resident"], plan["y_resident"]) == (G, resident, 0), \
            (dtype, C, N, plan)
        assert plan["smem_bytes"] <= 232448


def test_a_library_refuses_another_variant(libs):
    """Each library holds one (dtype, C) instantiation and returns an error
    for any other, which the wrapper raises."""
    args = _args(1, 8, 32, torch.float32, seed=0)
    lib = libs[(tattn.FORWARD_KERNEL, tattn.variant(torch.bfloat16, 32))]
    with pytest.raises(RuntimeError, match="launch failed"):
        tattn.launch_forward(lib, *args, 1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("B,N,C", SHAPES)
def test_linear_attention_kernel_matches_plain(libs, B, N, C, dtype):
    x, _, _, w_qkv, w_out, b_out, _, _ = _args(B, N, C, dtype, seed=B + N + C + 2)
    got = tattn.launch_linear(libs[(tattn.LINEAR_KERNEL, tattn.variant(dtype, C))],
                              x, w_qkv, w_out, b_out)
    want = tattn.linear_attention_reference(x, w_qkv, w_out, b_out)
    assert got.dtype == dtype
    atol, rtol = K3_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def _qkv(B, H, N, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, H, N, 32)).astype(np.float32)).to(dtype)
            for _ in range(3)]


# one key; under one query tile of 128 and one key tile of 64; both ragged
# over two query tiles; several (b, h)
ATTN_SHAPES = [(1, 2, 1), (2, 1, 100), (1, 1, 200), (2, 2, 130), (1, 1, 13)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("B,H,N", ATTN_SHAPES)
def test_blockwise_attention_kernel_matches_plain(libs, B, H, N, dtype):
    q, k, v = _qkv(B, H, N, dtype, seed=B + H + N)
    got = tatt.launch(libs[_job(tatt, dtype)], q, k, v)
    want = tatt.dense_attention(q, k, v)
    assert got.dtype == dtype
    atol, rtol = K4_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("B,H,N", [(1, 1, 13), (1, 2, 200), (2, 1, 130)])
def test_blockwise_attention_kernel_peaked_matches_plain(libs, B, H, N, dtype):
    """q scaled by 8: a peaked softmax, where a few keys carry most of the
    weight and one bf16 rounding of P would show."""
    q, k, v = _qkv(B, H, N, dtype, seed=B + H + N + 1)
    q = (q.float() * 8).to(dtype)
    got = tatt.launch(libs[_job(tatt, dtype)], q, k, v)
    want = tatt.dense_attention(q, k, v)
    atol, rtol = K4_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


# C = 96 (ds1 photon / HGCal widths), ds2-like level shapes, 4 groups, no SiLU
GN_CASES = [((2, 5, 4, 3, 96), 8, True), ((2, 9, 4, 3, 32), 8, True),
            ((3, 7, 7, 32), 4, True), ((1, 23, 64), 8, False)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("shape,groups,silu", GN_CASES)
def test_groupnorm_silu_kernel_matches_plain(libs, shape, groups, silu, dtype):
    rng = np.random.default_rng(len(shape) + shape[-1])
    x = torch.from_numpy((2.0 + rng.standard_normal(shape)).astype(np.float32)).to(dtype)
    C = shape[-1]
    scale = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.standard_normal(C)).astype(np.float32))
    got = tgn.launch(libs[_job(tgn, dtype)], x, scale, bias, groups, 1e-5, silu)
    want = tgn.gn_silu_reference(x, scale, bias, groups, 1e-5, silu)
    assert got.dtype == dtype
    atol, rtol = K5_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_k4_k5_libraries_refuse_what_they_do_not_take(libs):
    """K4 takes only its build's dtype and D = 32; K5 only its build's dtype
    and C divisible by the groups: the C entries return an error, which the
    launch functions raise."""
    q, k, v = _qkv(1, 1, 8, torch.float32, seed=0)
    with pytest.raises(RuntimeError, match="launch failed"):
        tatt.launch(libs[_job(tatt, torch.bfloat16)], q, k, v)
    q16 = torch.zeros(1, 1, 8, 16)
    with pytest.raises(RuntimeError, match="launch failed"):
        tatt.launch(libs[_job(tatt, torch.float32)], q16, q16, q16)
    x, ones = torch.zeros(1, 4, 32), torch.ones(32)
    with pytest.raises(RuntimeError, match="launch failed"):
        tgn.launch(libs[_job(tgn, torch.float32)], x, ones, ones, 5, 1e-5, True)


# ---------------------------------------------------------------------------
# K4's log-sum-exp and its backward kernel; K5's chunked statistics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("B,H,N", [(1, 2, 1), (2, 1, 100), (1, 1, 200)])
def test_blockwise_attention_lse_matches_logsumexp(libs, B, H, N, dtype):
    """K4's forward with the rows' log-sum-exp asked for: the output is the
    one without it, and lse is torch.logsumexp of the scaled f32 scores
    (the log of a sum of at most 200 f32 terms taken in another order: 1e-5
    absolute at |lse| < 10)."""
    q, k, v = _qkv(B, H, N, dtype, seed=B + H + N + 2)
    lib = libs[_job(tatt, dtype)]
    out, lse = tatt.launch(lib, q, k, v, with_lse=True)
    assert lse.shape == (B, H, N) and lse.dtype == torch.float32
    assert torch.equal(out, tatt.launch(lib, q, k, v))
    torch.testing.assert_close(lse, tatt.attention_lse_reference(q, k), atol=1e-5, rtol=0)


def _attention_backward(libs, q, k, v, dout):
    out, lse = tatt.launch(libs[_job(tatt, q.dtype)], q, k, v, with_lse=True)
    return tatt.launch_backward(libs[_job(tatt, q.dtype, "BACKWARD_KERNEL")], q, k, v, out, lse,
                                dout)


# one key; N short of one 64-row tile; N past two tiles of 64 and one of
# 128, with B*H = 2; q x 8 (a peaked softmax, where dS cancels) at N = 63 and
# 130; N = 129 and 257, a CTA of one row or one row past two streamed
# tiles, a ring stage holding one row before TMA's zeros.  The bf16 kernel's
# large-grid plan (192-row CTAs, 64-row tiles) runs where B*H*ceil(N/192)
# >= 4 on the emulation's card of one SM: N = 257 and (2, 2, 200).
K4B_CASES = [(1, 1, 1, 1), (1, 1, 63, 1), (2, 1, 130, 1), (1, 2, 63, 8), (1, 1, 130, 8),
             (1, 1, 129, 1), (1, 2, 257, 1), (2, 2, 200, 8)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("B,H,N,gain", K4B_CASES)
def test_blockwise_attention_backward_kernel_matches_plain(libs, B, H, N, gain, dtype):
    """dq, dk, dv of K4's backward (its forward's out and lse) against
    autograd of dense_attention, max-norm relative, within K4B_TOL."""
    q, k, v, dout = (*_qkv(B, H, N, dtype, seed=B + H + N + gain),
                     _qkv(B, H, N, dtype, seed=N + 99)[0])
    q = (q.float() * gain).to(dtype)
    got = _attention_backward(libs, q, k, v, dout)
    want = tatt.attention_backward_reference(q, k, v, dout)
    # where the plain gradient is zero (N = 1: a softmax over one key does not
    # depend on q or k), the error is taken relative to dv's largest entry
    floor = want[2].double().abs().max()
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape and a.dtype == w.dtype == dtype, name
        a, w = a.double(), w.double()
        scale = w.abs().max()
        err = ((a - w).abs().max() / (scale if scale > 0 else floor)).item()
        assert err <= K4B_TOL[dtype], f"{name}: max-norm relative error {err:.3g}"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_blockwise_attention_backward_is_deterministic_and_refuses_a_bad_scratch(libs, dtype):
    """Two calls give the same gradients bit for bit; a library refuses the
    other dtype and a scratch shorter than N rounded up to 128 rows."""
    q, k, v = _qkv(1, 2, 130, dtype, seed=5)
    dout = _qkv(1, 2, 130, dtype, seed=6)[0]
    first, second = (_attention_backward(libs, q, k, v, dout) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    lib = libs[_job(tatt, dtype, "BACKWARD_KERNEL")]
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    qo = q.to(other)
    lse = torch.zeros(1, 2, 130)
    with pytest.raises(RuntimeError, match="launch failed"):
        tatt.launch_backward(lib, qo, qo, qo, qo, lse, qo)
    stats = torch.empty(2, 2, 130)
    rc = lib.calo_blockwise_attention_backward(
        *(t.data_ptr() for t in (q, k, v, q, dout, lse, q.clone(), k.clone(), v.clone(), stats)),
        2, 130, 130, 32, int(dtype == torch.bfloat16), 32 ** -0.5, None)
    assert rc != 0


# (shape, groups, SiLU, steps): chunks of 1-8 rows a thread, so a sample
# spans one to seven chunks (the last one short); C = 16, 32, 64 and 96,
# groups of 2, 4, 16 and 12 channels against 16-byte vectors of 8 bf16 or
# 4 f32 channels (a vector straddles two to four groups, or a group two
# vectors; at C = 96 a warp does not hold whole rows); one position
GN_CHUNK_CASES = [((2, 300, 32), 8, True, 1), ((1, 500, 16), 8, False, 2),
                  ((2, 130, 64), 4, True, 4), ((1, 7, 11, 96), 8, True, 1),
                  ((1, 900, 32), 8, True, 8), ((2, 1, 16), 8, True, 0)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("shape,groups,silu,steps", GN_CHUNK_CASES)
def test_groupnorm_silu_kernel_chunks_match_plain(libs, shape, groups, silu, steps, dtype):
    """K5's statistics over chunks of a sample, merged in a fixed order,
    against the two-pass plain version; the same output bit for bit from two
    calls."""
    rng = np.random.default_rng(sum(shape) + steps)
    x = torch.from_numpy((2.0 + rng.standard_normal(shape)).astype(np.float32)).to(dtype)
    C = shape[-1]
    scale = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.standard_normal(C)).astype(np.float32))
    lib = libs[_job(tgn, dtype)]
    S = int(np.prod(shape[1:-1]))
    chunks = lib.calo_groupnorm_silu_chunks(S, C, steps)
    assert chunks >= (1 if S < 200 else 2), chunks
    got = tgn.launch(lib, x, scale, bias, groups, 1e-5, silu, steps)
    assert torch.equal(got, tgn.launch(lib, x, scale, bias, groups, 1e-5, silu, steps))
    want = tgn.gn_silu_reference(x, scale, bias, groups, 1e-5, silu)
    atol, rtol = K5_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# Q1, the int8 convolution: its s8 mma and wgmma, and the kernels
# ---------------------------------------------------------------------------

# One warp computes a (16 x 32) (32 x 16) int8 product through common.cuh's
# mma_s8_16832 (two n-tiles of 8), its operands packed 4 int8 to a register
# after the PTX ISA's m16n8k32 fragment layouts, as Q1 reads them from its
# shared-memory tiles.
TILE_MMA_S8_SOURCE = r"""
#include "common.cuh"
using namespace calo;
extern "C" void tile_mma_s8(const int8_t* a, const int8_t* b, int* c) {
  emu_launch(1, 32, 16, [&] {
    const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
    auto pk = [](const int8_t* p, int stride) {
      unsigned w = 0;
      for (int i = 0; i < 4; ++i) w |= unsigned(uint8_t(p[i * stride])) << (8 * i);
      return w;
    };
    unsigned af[4], bf[2][2];
    for (int r = 0; r < 4; ++r) af[r] = pk(a + (g + 8 * (r & 1)) * 32 + 4 * t + 16 * (r >> 1), 1);
    for (int n = 0; n < 2; ++n)
      for (int j = 0; j < 2; ++j) bf[n][j] = pk(b + (4 * t + 16 * j) * 16 + n * 8 + g, 16);
    for (int n = 0; n < 2; ++n) {
      int d[4] = {0, 0, 0, 0};
      mma_s8_16832(d, af, bf[n][0], bf[n][1]);
      for (int i = 0; i < 4; ++i) c[(g + 8 * (i >> 1)) * 16 + n * 8 + 2 * t + (i & 1)] = d[i];
    }
  });
}
"""


@pytest.fixture(scope="module")
def tile_mma_s8(tmp_path_factory):
    out = _emulation_dir(tmp_path_factory)
    cpp, so = out / "tile_mma_s8.cpp", out / "tile_mma_s8.so"
    cpp.write_text(TILE_MMA_S8_SOURCE)
    cmd = ["g++", "-std=c++20", "-O1", "-fno-strict-aliasing", "-shared", "-fPIC", "-pthread",
           f"-I{out}", f"-I{cuda_build.CSRC_DIR}", "-DCALO_EMULATION", "-DCALO_BF16=1",
           "-o", str(so), str(cpp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    fn = ctypes.CDLL(str(so)).tile_mma_s8
    fn.argtypes = [ctypes.c_void_p] * 3
    return fn


@pytest.mark.parametrize("seed", [0, 1])
def test_emulated_mma_s8_matches_matmul(tile_mma_s8, seed):
    """The emulated m16n8k32 s8 mma against an int64 product on a random
    tile, the extremes -127 and 127 among its entries: equal."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.integers(-127, 128, (16, 32), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (32, 16), dtype=np.int8))
    a[0, :] = 127
    b[:, 0] = -127
    c = torch.full((16, 16), -1, dtype=torch.int32)
    tile_mma_s8(a.data_ptr(), b.data_ptr(), c.data_ptr())
    assert torch.equal(c.long(), a.long() @ b.long())


# One warpgroup computes A (64 x K) B^T (B: N x K) by hopper.cuh's s8
# wgmma m64nNk32 (s32 sums), K / 32 k-steps, the first with scale_d 0.  B
# (the weights) in K-major rows of 64 bytes with the 64-byte swizzle, as
# Q1 keeps them.  A either in Q1's A ring (rows of 32 bytes with the
# 32-byte swizzle, one slab of rows a 32-byte k-step), its rows read by
# ldmatrix from row `shift` on into registers, or from shared memory
# through a descriptor, laid out as B.  D is stored after the accumulator
# layout.
TILE_WGMMA_S8_SOURCE = r"""
#include "hopper.cuh"
using namespace calo;
template <int N>
void run(const int8_t* a, const int8_t* b, int* c, int K, int a_desc, int shift) {
  const int rows = 64 + shift;
  const size_t slabs = (K + 63) / 64;  // 64-byte rows of K
  const size_t b_bytes = slabs * N * 64;
  const size_t a_bytes = a_desc ? slabs * 64 * 64 : size_t(K / 32) * rows * 32;
  emu_launch(1, 128, 1024 + b_bytes + a_bytes, [&] {
    char* sb = align_smem_1024(emu_block->smem);
    char* sa = sb + b_bytes;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    for (int i = tid; i < N * K; i += 128) {
      const int n = i / K, k = i % K;
      sb[swizzle64((k >> 6) * N * 64 + n * 64 + (k & 63))] = b[i];
    }
    for (int i = tid; i < 64 * K; i += 128) {
      const int m = i / K, k = i % K;
      if (a_desc) sa[swizzle64((k >> 6) * 64 * 64 + m * 64 + (k & 63))] = a[i];
      else sa[(k >> 5) * rows * 32 + ring32_offset(m + shift, (k >> 4) & 1) + (k & 15)] = a[i];
    }
    __syncthreads();
    int d[N / 2];
    wgmma_fence();
    for (int ks = 0; ks < K / 32; ++ks) {
      const uint64_t db = smem_desc(sb + (ks >> 1) * N * 64 + 32 * (ks & 1), 16, 512);
      if (a_desc) {
        WgmmaS8<N>::ss(d, smem_desc(sa + (ks >> 1) * 64 * 64 + 32 * (ks & 1), 16, 512), db, ks);
      } else {
        unsigned af[4];
        const int row = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1) + shift;
        ldmatrix_x4(af, sa + ks * rows * 32 + ring32_offset(row, lane >> 4));
        WgmmaS8<N>::rs(d, af, db, ks);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    for (int i = 0; i < N / 2; ++i)
      c[(16 * warp + g + 8 * ((i >> 1) & 1)) * N + 8 * (i >> 2) + 2 * t + (i & 1)] = d[i];
  });
}
extern "C" void tile_wgmma_s8(const int8_t* a, const int8_t* b, int* c, int n, int k,
                              int a_desc, int shift) {
  (n == 32 ? run<32> : n == 64 ? run<64> : run<128>)(a, b, c, k, a_desc, shift);
}
"""


@pytest.fixture(scope="module")
def tile_wgmma_s8(tmp_path_factory):
    out = _emulation_dir(tmp_path_factory)
    cpp, so = out / "tile_wgmma_s8.cpp", out / "tile_wgmma_s8.so"
    cpp.write_text(TILE_WGMMA_S8_SOURCE)
    cmd = ["g++", "-std=c++20", "-O1", "-fno-strict-aliasing", "-shared", "-fPIC", "-pthread",
           f"-I{out}", f"-I{cuda_build.CSRC_DIR}", "-DCALO_EMULATION", "-DCALO_BF16=1",
           "-o", str(so), str(cpp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    fn = ctypes.CDLL(str(so)).tile_wgmma_s8
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
    return fn


@pytest.mark.parametrize("n,k,a_from,shift", [(32, 64, "ring", 0), (32, 96, "ring", 5),
                                              (64, 64, "ring", 3), (128, 128, "ring", 1),
                                              (32, 64, "descriptor", 0),
                                              (128, 128, "descriptor", 0)])
def test_emulated_wgmma_s8_matches_matmul(tile_wgmma_s8, n, k, a_from, shift):
    """The emulated s8 wgmma (A from Q1's ring by ldmatrix at a row shift,
    or through a descriptor; B from 64-byte-swizzled K-major rows) against
    an int64 product, -127 and 127 among the entries: equal."""
    rng = np.random.default_rng(n + k + shift)
    a = torch.from_numpy(rng.integers(-127, 128, (64, k), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8))
    a[0, :] = 127
    b[0, :] = -127
    b[1, :] = 127
    c = torch.full((64, n), -1, dtype=torch.int32)
    tile_wgmma_s8(a.data_ptr(), b.data_ptr(), c.data_ptr(), n, k, int(a_from == "descriptor"),
                  shift)
    assert torch.equal(c.long(), a.long() @ b.long().t())


# (B, Cin, Cout, (Z, A, R), kernel, stride, padding, cylindrical): ds2's
# kinds at small sizes: 3x3x3 with the phi wrap, Cin a multiple of 32 and
# not (K = 216 leaves a ragged step); 1x1 residuals, Cout past one tile of
# 32; the (3, 4, 4) stride-2 downsample wrapping phi on an axis of 8; a
# plain zero-padded 3x3x3; a subpixel core (kernel 2, pads 1, Cout' = 8
# Cout); rows past the last whole tile of 128 in each
Q1_CASES = [
    (2, 32, 32, (5, 8, 6), (3, 3, 3), 1, 1, True),
    (2, 8, 16, (5, 8, 6), (3, 3, 3), 1, 1, True),
    (2, 16, 40, (4, 6, 5), (1, 1, 1), 1, 0, True),
    (1, 64, 32, (3, 4, 2), (1, 1, 1), 1, 0, False),
    (2, 16, 16, (5, 8, 6), (3, 4, 4), (2, 2, 2), 1, True),
    (1, 8, 8, (5, 8, 6), (3, 3, 3), 1, 1, False),
    (1, 8, 64, (4, 6, 5), (2, 2, 2), 1, 1, False),
]


def _q1_args(B, Cin, Cout, spatial, kernel, dtype, seed):
    """x with a tail that saturates the int8 range (inv_sx 127 / 2.5), int8
    weights, an f32 scale and bias."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, Cin, *spatial)).astype(np.float32)).to(dtype)
    wq = torch.from_numpy(rng.integers(-127, 128, (Cout, Cin, *kernel), dtype=np.int8))
    scale = torch.from_numpy((1e-4 * (1 + rng.random(Cout))).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.standard_normal(Cout)).astype(np.float32))
    return x, wq, scale, bias, float(np.float32(127 / 2.5))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("B,Cin,Cout,spatial,kernel,stride,padding,cyl", Q1_CASES)
def test_int8_conv3d_kernel_matches_plain(libs, B, Cin, Cout, spatial, kernel, stride, padding,
                                         cyl, dtype):
    """Q1 against int8_conv3d_reference, bit for bit: the s32 sums are exact
    on both sides and the dequantization rounds alike; without a bias too."""
    x, wq, scale, bias, inv = _q1_args(B, Cin, Cout, spatial, kernel, dtype, seed=Cin + Cout)
    lib = libs[_job(tq1, dtype)]
    for b in (bias, None):
        got = tq1.launch(lib, x, wq, scale, b, inv, stride, padding, cyl)
        want = tq1.int8_conv3d_reference(x, wq, scale, b, inv, stride, padding, cyl)
        assert got.dtype == dtype and got.shape == want.shape
        assert torch.equal(got, want), (got.float() - want.float()).abs().max()


def test_int8_conv3d_library_refuses_what_it_does_not_take(libs):
    """A library takes only its build's activation dtype and a phi wrap no
    wider than the axis: the C entry returns an error, which launch raises."""
    x, wq, scale, bias, inv = _q1_args(1, 8, 8, (3, 4, 3), (3, 3, 3), torch.float32, seed=0)
    with pytest.raises(RuntimeError, match="launch failed"):
        tq1.launch(libs[_job(tq1, torch.bfloat16)], x, wq, scale, bias, inv, 1, 1, True)
    with pytest.raises(RuntimeError, match="launch failed"):
        tq1.launch(libs[_job(tq1, torch.float32)], x, wq, scale, bias, inv, 1, (1, 5, 1), True)


# Q1's GEMM plans forced on small shapes, each on a card of 3 SMs (several
# persistent CTAs a channel tile): the window (stride 1), the per-tap
# gather with the weights resident and streamed.  An M of several tiles
# with a ragged last one (1742 window rows: 7 tiles of 256); Cin 128 (four
# 32-byte slabs a tap); the stride-2 (3, 4, 4) downsample wrapping phi at
# Cin 32; a transpose core, Cout' = 8 Cout = 256 (two channel tiles of 128)
Q1_PLAN_CASES = [
    (3, 32, 32, (6, 8, 6), (3, 3, 3), 1, 1, True),
    (1, 128, 32, (3, 4, 3), (3, 3, 3), 1, 1, True),
    (1, 32, 32, (5, 8, 5), (3, 4, 4), (2, 2, 2), 1, True),
    (1, 32, 256, (3, 6, 2), (2, 2, 2), 1, 1, False),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("B,Cin,Cout,spatial,kernel,stride,padding,cyl", Q1_PLAN_CASES)
def test_int8_conv3d_plans_match_plain(libs, monkeypatch, B, Cin, Cout, spatial, kernel, stride,
                                       padding, cyl, dtype):
    """Each plan of Q1's GEMM that the stride allows, against
    int8_conv3d_reference bit for bit, with a bias and without."""
    monkeypatch.setenv("CALO_EMU_SMS", "3")
    x, wq, scale, bias, inv = _q1_args(B, Cin, Cout, spatial, kernel, dtype, seed=Cin + Cout + 1)
    lib = libs[_job(tq1, dtype)]
    plans = ["gather", "stream"] if stride != 1 else ["window", "gather", "stream"]
    for plan in plans:
        for b in (bias, None):
            got = tq1.launch(lib, x, wq, scale, b, inv, stride, padding, cyl, plan=plan)
            want = tq1.int8_conv3d_reference(x, wq, scale, b, inv, stride, padding, cyl)
            assert got.dtype == dtype and got.shape == want.shape
            assert torch.equal(got, want), (plan, (got.float() - want.float()).abs().max())


# (x shape, w shape, stride, padding, the mode Q1 picks on a card of 3
# SMs): a 3x3x3 level, a 1x1x1 residual (no halo: the window reads as many
# rows as the gather), the stride-2 downsample, and a 3x3x3 whose weights
# (64 x 27 x 192 bytes) cannot stay resident
Q1_PLAN_QUERIES = [
    ((2, 32, 5, 8, 6), (32, 32, 3, 3, 3), 1, 1, "window"),
    ((2, 32, 5, 8, 6), (64, 32, 1, 1, 1), 1, 0, "gather"),
    ((1, 32, 5, 8, 6), (32, 32, 3, 4, 4), (2, 2, 2), 1, "gather"),
    ((1, 192, 3, 4, 3), (64, 192, 3, 3, 3), 1, 1, "stream"),
]


@pytest.mark.parametrize("x_shape,w_shape,stride,padding,mode", Q1_PLAN_QUERIES)
def test_int8_conv3d_plan_query_names_the_plan_it_launches(libs, monkeypatch, x_shape, w_shape,
                                                           stride, padding, mode):
    """Q1's plan entry (nothing launched) names the mode its launch takes
    by shape; a forced mode is echoed; each mode it names launches and
    equals the plain version bit for bit."""
    monkeypatch.setenv("CALO_EMU_SMS", "3")
    lib = libs[_job(tq1, torch.float32)]
    plan = tq1.kernel_plan(lib, x_shape, w_shape, stride, padding, True)
    assert plan["mode"] == mode and plan["smem_bytes"] <= 232448, plan
    assert tq1.kernel_plan(lib, x_shape, w_shape, stride, padding, True, plan="stream")["mode"] \
        == "stream"
    x, wq, scale, bias, inv = _q1_args(x_shape[0], x_shape[1], w_shape[0], x_shape[2:],
                                       w_shape[2:], torch.float32, seed=5)
    got = tq1.launch(lib, x, wq, scale, bias, inv, stride, padding, True, plan=mode)
    assert torch.equal(got, tq1.int8_conv3d_reference(x, wq, scale, bias, inv, stride, padding,
                                                      True))


@pytest.mark.parametrize("cyl", [True, False], ids=["phi_wrap", "zero_pad"])
@pytest.mark.parametrize("layout", ["ncdhw", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_int8_quantize_pass_matches_plain(libs, dtype, layout, cyl):
    """Q1's first kernel alone: x, contiguous or a channels_last_3d view,
    quantized into (B, Zp, Ap, Rp, Cp) equals quantize_act with phi wrapped
    (or zero-padded), Z and R zero-padded and the channels past Cin zero."""
    x, *_, inv = _q1_args(2, 40, 8, (4, 6, 5), (1, 1, 1), dtype, seed=3)
    if layout == "channels_last":
        x = x.to(memory_format=torch.channels_last_3d)
    pz, pa, pr = 1, 2, 1
    got = tq1.launch_quantize(libs[_job(tq1, dtype)], x, inv, (pz, pa, pr), cyl)
    q = tq1.quantize_act(x, inv)
    if cyl:
        q = torch.nn.functional.pad(q, (0, 0, pa, pa, 0, 0), mode="circular")
        q = torch.nn.functional.pad(q, (pr, pr, 0, 0, pz, pz))
    else:
        q = torch.nn.functional.pad(q, (pr, pr, pa, pa, pz, pz))
    want = torch.nn.functional.pad(q.permute(0, 2, 3, 4, 1), (0, 64 - 40))
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_int8_conv3d_kernel_takes_channels_last(libs, dtype):
    """Q1 reads x in its strides: a channels_last_3d view (K1's output
    layout) gives the contiguous input's result, the plain version's."""
    x, wq, scale, bias, inv = _q1_args(2, 32, 32, (5, 8, 6), (3, 3, 3), dtype, seed=5)
    lib = libs[_job(tq1, dtype)]
    got = tq1.launch(lib, x.to(memory_format=torch.channels_last_3d), wq, scale, bias, inv, 1, 1,
                     True)
    assert torch.equal(got, tq1.launch(lib, x, wq, scale, bias, inv, 1, 1, True))
    assert torch.equal(got, tq1.int8_conv3d_reference(x, wq, scale, bias, inv, 1, 1, True))


def test_int8_conv3d_refuses_a_window_on_a_strided_conv(libs):
    """The window plan reads taps at fixed row offsets, so it takes stride 1
    only: forcing it on the stride-2 downsample returns an error, raised."""
    x, wq, scale, bias, inv = _q1_args(1, 16, 16, (5, 8, 6), (3, 4, 4), torch.float32, seed=0)
    with pytest.raises(RuntimeError, match="launch failed"):
        tq1.launch(libs[_job(tq1, torch.float32)], x, wq, scale, bias, inv, 2, 1, True,
                   plan="window")
