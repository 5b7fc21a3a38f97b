// Hopper's asynchronous machinery for the kernels of csrc/ (sm_90a): the
// Tensor Memory Accelerator (TMA) with its tensor maps, mbarriers, the
// warpgroup matrix product (wgmma) with its shared-memory descriptors, and
// setmaxnreg.  One PTX instruction a helper, as common.cuh's mma.sync and
// cp.async helpers, so that the tests' CPU emulation (CALO_EMULATION) can
// supply counterparts that follow the PTX ISA: a TMA tile lands swizzled
// when issued and completes its bytes on the mbarrier; an mbarrier counts
// arrivals and transaction bytes and flips its phase; a wgmma gathers the
// warpgroup's register A fragments when issued and runs at the
// wait_group that retires its group, reading B through its descriptor then.
//
// Layouts (bf16, the PTX ISA's "matrix descriptor" and "register fragment"
// sections):
//   wgmma m64nNk16, a warpgroup of 4 warps; warp w owns rows 16w..16w+15.
//   A fragment (registers): the m16n8k16 A layout of common.cuh within a
//     warp's 16 rows: a0 (g, 2t..), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..).
//   D fragment (f32, N/2 a thread): d[i] is (row g + 8 ((i >> 1) & 1),
//     column 8 (i >> 2) + 2t + (i & 1)) of the warp's rows.
//   B from shared memory, with the 64-byte swizzle (S = 64 bytes, the row of
//   D = 32 bf16 the kernels stream; T = 8 elements):
//     K-major  ((8, m), (T, 2)) : ((S, SBO), (1, T))   rows of S bytes, 8-row groups SBO apart
//     MN-major ((T, S/16, m), (8, k)) : ((1, T, LBO), (S, SBO))   S bytes along MN, 8 K rows S apart
//   the address then XORed in bits [4, 6) with bits [7, 9): tiles start on
//   a 1024-byte boundary, so the pattern is the absolute one TMA writes
//   with the same swizzle.  A k-step of 16 advances a K-major descriptor by
//   32 bytes along its rows and an MN-major one by 16 rows.
#pragma once

#include <stdint.h>

#include "common.cuh"

#if !defined(CALO_EMULATION)
#include <cuda.h>
#endif

namespace calo {

// the one swizzle the kernels use, and its layout type in a descriptor
constexpr int SWIZZLE_BYTES = 64;
constexpr uint64_t SWIZZLE_64B_MODE = 2;

// a wgmma shared-memory matrix descriptor of a 64-byte-swizzled tile:
// start address, leading and stride byte offsets (multiples of 16)
__device__ __forceinline__ uint64_t smem_desc(const void* p, unsigned lbo, unsigned sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3ffffu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3fffu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3fffu) << 32) | (SWIZZLE_64B_MODE << 62);
}

// p rounded up to the next 1024-byte boundary of the shared window
__device__ __forceinline__ char* align_smem_1024(void* p) {
  char* c = static_cast<char*>(p);
  return c + ((1024u - (smem_addr(c) & 1023u)) & 1023u);
}

template <int N, int TRANS_B> struct Wgmma;

#if defined(CALO_EMULATION)
// the emulation header defines the emu_* counterparts and CUtensorMap

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) { emu_mbar_init(bar, count); }
__device__ __forceinline__ void mbar_fence_init() {}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) { emu_mbar_update(bar, 1, 0); }
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  emu_mbar_update(bar, 1, bytes);
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) { emu_mbar_wait(bar, parity); }
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  emu_tma_load_3d(dst, map, c0, c1, c2, bar);
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  emu_bulk_load(dst, src, bytes, bar);
}
__device__ __forceinline__ void wgmma_fence() {}
__device__ __forceinline__ void wgmma_commit() { emu_wgmma_commit(); }
template <int N> __device__ __forceinline__ void wgmma_wait() { emu_wgmma_wait(N); }
template <int N> __device__ __forceinline__ void fence_operands(float (&)[N]) {}
template <int R> __device__ __forceinline__ void reg_alloc() {}
template <int R> __device__ __forceinline__ void reg_dealloc() {}

template <int N, int TRANS_B> struct Wgmma {
  static void rs(float (&d)[N / 2], const unsigned (&a)[4], uint64_t db, int scale_d) {
    emu_wgmma(d, N, a, db, TRANS_B, scale_d);
  }
};

// a 3-D bf16 tensor (dims innermost first, row pitch dim0 elements) as
// tiles of box_rows rows of dim0, 64-byte swizzled
inline int encode_tile_map(CUtensorMap* map, const void* base, int dim0, int dim1, int dim2,
                           int box_rows) {
  return emu_encode_tile_map(map, base, dim0, dim1, dim2, box_rows);
}

#else

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// the barriers' initialisation visible to the async proxy (TMA) and the other threads
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// arrive, and expect `bytes` more of asynchronous copies in this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// wait until the phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}
// one box of a tensor map into shared memory at (c0, c1, c2), completing on bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}
// `bytes` (a multiple of 16, 16-byte aligned) global -> shared, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of the warpgroup's committed groups are in flight
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accesses to an accumulator across a wait
template <int N> __device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// a warpgroup's registers a thread: raise (consumers) or lower (producer)
template <int R> __device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R> __device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
// m64nNk16, bf16 in, f32 sums; TRANS_B 1 reads B MN-major
template <int TRANS_B> struct Wgmma<32, TRANS_B> {
  // d (+)= a b, a from registers
  static __device__ __forceinline__ void rs(float (&d)[16], const unsigned (&a)[4], uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TRANS_B));
  }
};

template <int TRANS_B> struct Wgmma<64, TRANS_B> {
  // d (+)= a b, a from registers
  static __device__ __forceinline__ void rs(float (&d)[32], const unsigned (&a)[4], uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TRANS_B));
  }
};

template <int TRANS_B> struct Wgmma<128, TRANS_B> {
  // d (+)= a b, a from registers
  static __device__ __forceinline__ void rs(float (&d)[64], const unsigned (&a)[4], uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TRANS_B));
  }
};

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t rc =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a 3-D bf16 tensor (dims innermost first, rows of dim0 contiguous) as
// boxes of box_rows rows of dim0, 64-byte swizzled (a row of dim0 is the
// swizzle's width); rows past dim1 read as zeros.  Returns a CUDA error code.
inline int encode_tile_map(CUtensorMap* map, const void* base, int dim0, int dim1, int dim2,
                           int box_rows) {
  if (dim0 * 2 != SWIZZLE_BYTES) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiledFn fn = encode_tiled_fn();
  if (!fn) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(dim0), static_cast<cuuint64_t>(dim1),
                              static_cast<cuuint64_t>(dim2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(dim0) * 2,
                                 static_cast<cuuint64_t>(dim0) * dim1 * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(dim0), static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult rc = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                         strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_64B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

#endif

}  // namespace calo
