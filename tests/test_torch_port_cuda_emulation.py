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
functions with CPU tensors: K1/K2/K3 (``ops/linear_attention.py``), K4
(``ops/attention.py``), K5 (``ops/groupnorm.py``).  This checks the
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
from calodiffusion_tpu_torch.ops import linear_attention as tattn
from calodiffusion_tpu_torch.ops.tolerances import K1_TOL, K2_TOL, K3_TOL, K4_TOL, K5_TOL

# every (kernel, variant) of the three ops modules
JOBS = tattn.BUILDS + tatt.KERNEL.builds + tgn.KERNEL.builds
ONE_DTYPE_KERNELS = {k.name: k for k in (tatt.KERNEL, tgn.KERNEL)}  # one library a dtype


def _job(module, dtype):
    """The (kernel, variant) of K4's or K5's library for ``dtype``."""
    return module.KERNEL.name, cuda_build.dtype_variant(dtype)


EMULATION_HEADER = r"""
// CPU emulation of the CUDA subset the attention kernels use: one std::thread
// per CUDA thread, std::barrier for __syncthreads/__syncwarp, shuffles via a
// per-warp buffer.  Shared memory is poisoned with NaN.
#pragma once
#include <math.h>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstddef>
#include <barrier>
#include <thread>
#include <vector>
#include <memory>
#include <algorithm>
using std::min; using std::max;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)

struct EmuDim { int x = 0, y = 0, z = 0; };
inline thread_local EmuDim threadIdx, blockIdx;

struct uint4 { unsigned x, y, z, w; };
struct float4 { float x, y, z, w; };
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
inline float rsqrtf(float v) { return 1.0f / std::sqrt(v); }

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 0;
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }

struct EmuBlock {
  std::barrier<>* bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
  std::vector<float> shfl;
  float* smem;
};
inline thread_local EmuBlock* emu_block;
inline void __syncthreads() { emu_block->bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_block->warp_bars[threadIdx.x >> 5]->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int o) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  float* buf = emu_block->shfl.data() + w * 32;
  buf[lane] = v;
  __syncwarp();
  const float r = buf[lane ^ o];
  __syncwarp();
  return r;
}

template <class F> void emu_launch(int grid, int block, size_t smem, F f) {
  for (int b = 0; b < grid; ++b) {
    std::vector<float> sm(smem / 4 + 4, NAN);
    std::barrier<> bar(block);
    EmuBlock eb;
    eb.bar = &bar;
    for (int w = 0; w < block / 32; ++w) eb.warp_bars.emplace_back(new std::barrier<>(32));
    eb.shfl.assign(block, 0.f);
    eb.smem = sm.data();
    std::vector<std::thread> ts;
    for (int t = 0; t < block; ++t)
      ts.emplace_back([&, t] { threadIdx.x = t; blockIdx.x = b; emu_block = &eb; f(); });
    for (auto& th : ts) th.join();
  }
}
"""

_LAUNCH = re.compile(r"(\w+(?:<[\w, ]+>)?)<<<([\w *+()/-]+?), (\w+), (\w+), (\w+)>>>\((.*?)\);",
                     re.S)


def _build(out_dir, name, defines):
    src = (cuda_build.CSRC_DIR / f"{name}.cu").read_text()
    src = src.replace("extern __shared__ __align__(16) float smem[];",
                      "float* smem = emu_block->smem;")
    src, n = _LAUNCH.subn(r"emu_launch(\2, \3, \4, [&] { \1(\6); });", src)
    assert n == 1, f"{name}.cu: expected one kernel launch, found {n}"
    tag = "_".join(d.replace("=", "") for d in defines)
    cpp, so = out_dir / f"{name}_{tag}.cpp", out_dir / f"{name}_{tag}.so"
    cpp.write_text(src)
    cmd = ["g++", "-std=c++20", "-O1", "-fno-strict-aliasing", "-shared", "-fPIC", "-pthread",
           f"-I{out_dir}", f"-I{cuda_build.CSRC_DIR}", *(f"-D{d}" for d in defines),
           "-o", str(so), str(cpp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    if name in ONE_DTYPE_KERNELS:
        return (name, defines), ONE_DTYPE_KERNELS[name].bind(lib)
    return (name, defines), tattn.bind(lib, name)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Every (kernel, variant) of the ops modules compiled for the emulation."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernels for the CPU emulation")
    out = tmp_path_factory.mktemp("cuda_emulation")
    for name in ("cuda_emu.h", "cuda_bf16.h", "cuda_runtime.h"):
        (out / name).write_text(EMULATION_HEADER if name == "cuda_emu.h"
                                else '#include "cuda_emu.h"\n')
    with ThreadPoolExecutor(4) as pool:
        return dict(pool.map(lambda job: _build(out, *job), JOBS))


def _args(B, N, C, dtype, seed):
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to(dt).contiguous()

    return [t(rng.standard_normal((B, N, C)), dtype),
            t(1.0 + 0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C)),
            t(0.2 * rng.standard_normal((C, 96)), dtype),
            t(0.2 * rng.standard_normal((32, C)), dtype), t(0.1 * rng.standard_normal(C)),
            t(1.0 + 0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C))]


# one position, a partial tile, past a whole tile of 128 and 256, two samples
SHAPES = [(2, 1, 32), (2, 300, 32), (1, 257, 64), (2, 130, 64)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
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
    got = tattn.launch_backward(lib, *args[:7], g, 1e-5)
    want = tattn.attention_block_backward_reference(*args, g)
    for i, (a, w) in enumerate(zip(got, want)):
        assert a.shape == w.shape and a.dtype == w.dtype, i
        a, w = a.double(), w.double()
        err = ((a - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
        assert err <= K2_TOL[dtype], f"gradient {i}: max-norm relative error {err:.3g}"


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
ATTN_SHAPES = [(1, 2, 1), (2, 1, 100), (1, 1, 200), (2, 2, 130)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("B,H,N", ATTN_SHAPES)
def test_blockwise_attention_kernel_matches_plain(libs, B, H, N, dtype):
    q, k, v = _qkv(B, H, N, dtype, seed=B + H + N)
    got = tatt.launch(libs[_job(tatt, dtype)], q, k, v)
    want = tatt.dense_attention(q, k, v)
    assert got.dtype == dtype
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
