"""calodiffusion_tpu_torch's CUDA kernels run on the CPU under emulation,
against their plain versions.

There is no CUDA compiler here, so each ``csrc/*.cu`` variant is compiled
with the host C++ compiler against ``EMULATION_HEADER`` below: every CUDA
thread of a block is a std::thread, ``__syncthreads``/``__syncwarp`` are
std::barriers, warp shuffles go through a per-warp buffer, shared memory is
filled with NaN so a read before a write shows.  The kernel launch
``kernel<<<grid, block, smem, stream>>>(args)`` is rewritten into a call
that runs the block's threads.  The libraries expose the same C entries as
the nvcc builds and are called through ``ops/linear_attention.py``'s
``launch_forward``/``launch_backward`` with CPU tensors.  This checks the
kernels' arithmetic, indexing, masking and barriers; it says nothing about
their speed, and the card's own compiler may still refuse what g++ takes.
Tolerances are the on-card ones of chip_smoke.py.
"""

import ctypes
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from calodiffusion_tpu_torch.ops import cuda_build
from calodiffusion_tpu_torch.ops import linear_attention as tattn

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

# K1: |kernel - plain| <= atol + rtol |plain|; K2: max-norm relative error
K1_TOL = {torch.bfloat16: (0.0625, 2.0**-6), torch.float32: (1e-4, 0.0)}
K2_TOL = {torch.bfloat16: 5e-2, torch.float32: 1e-4}
_LAUNCH = re.compile(r"(\w+<\w+, \w+>)<<<(\w+), (\w+), (\w+), (\w+)>>>\((.*?)\);", re.S)


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
    return (name, defines), tattn.bind(ctypes.CDLL(str(so)), name)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Every (kernel, variant) of tattn.BUILDS compiled for the emulation."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernels for the CPU emulation")
    out = tmp_path_factory.mktemp("cuda_emulation")
    for name in ("cuda_emu.h", "cuda_bf16.h", "cuda_runtime.h"):
        (out / name).write_text(EMULATION_HEADER if name == "cuda_emu.h"
                                else '#include "cuda_emu.h"\n')
    with ThreadPoolExecutor(4) as pool:
        return dict(pool.map(lambda job: _build(out, *job), tattn.BUILDS))


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
