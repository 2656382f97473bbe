// Hopper (sm_90a) building blocks shared by the hand-written kernels:
// cp.async with zero fill, mbarriers, TMA tensor loads and stores, the
// 128-byte shared-memory swizzle, wgmma descriptors and products, ldmatrix
// and mma.sync, the SFU's exp2, and the host-side tensor-map encoder (cuTensorMapEncodeTiled, looked up at run
// time through the CUDA runtime, so the library needs no -lcuda).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <math.h>

#include "common.cuh"

namespace fp {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- cp.async (Ampere and later): 16 bytes, zero-filled when !valid. ----------
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// --- mbarriers. ----------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Spins until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Named barrier over `count` threads (id 0 is __syncthreads).
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// Makes this thread's generic-proxy shared stores visible to TMA and wgmma.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- TMA. ------------------------------------------------------------------------
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                            int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void tma_store_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// Waits until all but the newest N committed store groups have read their
// shared memory.
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Waits until the committed stores have completed.
__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// --- The 128-byte swizzle of TMA and wgmma. ----------------------------------------
// Byte offset (from a 1024-byte aligned base) of byte `col` of row `row` in a
// tile of 128-byte rows: the 16-byte chunk index is XORed with row % 8.
__host__ __device__ __forceinline__ uint32_t swizzle128(uint32_t row, uint32_t col) {
  return row * 128 + ((((col >> 4) ^ row) & 7) << 4) + (col & 15);
}

// --- wgmma. ----------------------------------------------------------------------
// Descriptor of a K-major operand in 128-byte swizzled atoms of 8 rows x 128
// bytes (rows 1024 bytes apart per 8): start address, stride byte offset
// 1024, layout 128B. A step of k within the 128-byte row adds bytes >> 4.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define FP_WG_8(c, b) c(d[b]), c(d[b + 1]), c(d[b + 2]), c(d[b + 3]), \
  c(d[b + 4]), c(d[b + 5]), c(d[b + 6]), c(d[b + 7])
#define FP_WG_64(c) FP_WG_8(c, 0), FP_WG_8(c, 8), FP_WG_8(c, 16), FP_WG_8(c, 24), \
  FP_WG_8(c, 32), FP_WG_8(c, 40), FP_WG_8(c, 48), FP_WG_8(c, 56)
#define FP_WG_D64                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "        \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], bf16 in, f32 out, both operands
// K-major in shared memory; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16_bf16(float* d, uint64_t da, uint64_t db,
                                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FP_WG_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : FP_WG_64("+f")
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 32] . B[32 x 128], s8 in, s32 out, K-major.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int* d, uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " FP_WG_D64 ", %64, %65, p;\n}\n"
      : FP_WG_64("+r")
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef FP_WG_D64
#undef FP_WG_64
#undef FP_WG_8

// --- Warp-level tensor-core products (mma.sync m16n8k16, bf16 -> f32). --------------
// Lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8 of an accumulator
// fragment c[4], columns 2t and 2t + 1 (c[0..1] row g, c[2..3] row g + 8).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// Two floats rounded to bf16 and packed (lo in the low half), as an A
// fragment register wants them.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// 2^x by the SFU (relative error below 2^-22; -inf gives 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S [16 x 16] = Q K^T of one warp: Q as A fragments in registers (KSTEPS
// steps of 16), K's rows 16np .. 16np + 15 of a shared tile with LD
// elements a row. s[0][.] and s[1][.] are key blocks 2np and 2np + 1.
template <int KSTEPS, int LD>
__device__ __forceinline__ void logits_pair(float (*s)[4], const uint32_t (*qf)[4], const bf16* Ks,
                                            int np, int lane) {
  s[0][0] = s[0][1] = s[0][2] = s[0][3] = s[1][0] = s[1][1] = s[1][2] = s[1][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    uint32_t b[4];
    ldmatrix_x4(b, Ks + (16 * np + lane % 8 + 8 * (lane / 16)) * LD + 16 * kk + 8 * ((lane / 8) % 2));
    mma_bf16(s[0], qf[kk], b[0], b[1]);
    mma_bf16(s[1], qf[kk], b[2], b[3]);
  }
}

// Masks keys at or past seq_len to -inf in NB key blocks starting at k0.
template <int NB>
__device__ __forceinline__ void mask_keys(float (*s)[4], int k0, int t, int seq_len) {
  if (k0 + 8 * NB <= seq_len) return;
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (k0 + 8 * n + 2 * t + (e & 1) >= seq_len) s[n][e] = -INFINITY;
}

// --- Host: tensor maps. -------------------------------------------------------------
// A 2D row-major tensor [rows, cols] of `esize`-byte elements with a box of
// [box_rows, box_cols]; 0 on success.
inline int encode_tensor_map_2d(CUtensorMap* map, const void* base, CUtensorMapDataType dtype,
                                int esize, uint64_t rows, uint64_t cols, uint32_t box_rows,
                                uint32_t box_cols, CUtensorMapSwizzle swizzle) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess ||
        found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * esize};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = encode(map, dtype, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace fp
