// The int8-versus-bf16 GEMM probe on Hopper: C[M, N] = A[M, K] . W[K, N]
// with bf16 inputs and f32 output, or int8 inputs and int32 output.
//
// Replaces: benchmarks/micro_int8.py:pallas_mm.kern (the Pallas kernel the
// TPU probe timed: one image's [T, D] x [D, H] product per grid step, bf16
// -> f32 and int8 -> int32, to see whether the chip's int8 matmul mode ran
// at twice the bf16 rate).
//
// What bounds it on the H100: at the probe's shapes (64 images x 912
// tokens, D 384, H 1536) the product is 68.9 GFLOP (int8: TOP), 70 us at
// the 989 TFLOP/s bf16 peak and 35 us at the 1,979 TOP/s int8 peak, but the
// [58368, 1536] 4-byte output alone is 358 MB: ~0.12 ms at 3.35 TB/s. The
// probe is bound by writing its output, in both types, so the design's job
// is to keep that store streaming while the products run.
//
// What the design does about it: a persistent TMA + wgmma GEMM.
// - One block per SM. The 128-column panels of W are dealt out to the
//   blocks (block b takes panel b % (N / 128)), and each block walks the
//   128-row tiles of A for its panel. W is small (1.2 MB) and K short (384),
//   so a block transposes its whole [K, 128] panel ONCE into shared memory
//   as K-major 128-byte swizzled rows (the layout 8-bit wgmma demands for
//   B, used for bf16 too), zero-padded past K.
// - A producer warp streams A in [128 rows x 128 bytes] slices by TMA
//   (128-byte swizzle, zero fill past K) through an mbarrier ring, running
//   ahead across tile boundaries. The ring takes the shared memory the W
//   panel leaves (6 stages in bf16, 8 in int8 at K = 384): with the output
//   store saturating memory the loads see long latencies, and the bf16
//   tile needs twice the A bytes of the int8 one.
// - Two consumer warpgroups, 64 rows each, run wgmma m64n128k16 (bf16 ->
//   f32) or m64n128k32 (s8 -> s32) straight from shared memory, one slice's
//   group in flight while the next is issued.
// - Epilogue: registers -> 128-byte swizzled shared staging (conflict-free
//   8-byte stores) -> TMA stores of [64 x 32] subtiles, two staging buffers
//   per warpgroup in turn. No store is waited for before the next tile's
//   products: a buffer is refilled once the store before last has read it,
//   so one tile's stores overlap the next tile's loads and products.
#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int BM = 128, BN = 128, MAX_STAGES = 8;
constexpr int SLICE_BYTES = BM * 128;  // one [128 rows x 128 bytes] slice
constexpr int MAX_NKC = 6;             // W panel of at most 6 slices (96 KB)
constexpr int CONSUMERS = 256, THREADS = CONSUMERS + 32;
constexpr int C_BUF_BYTES = 64 * 128;  // one [64 rows x 32] 4-byte output subtile
constexpr size_t MAX_SMEM = 232448;    // dynamic shared memory a block may use

template <typename T> struct Types;
template <> struct Types<bf16> {
  typedef float Acc;
  typedef float2 Acc2;
  static constexpr CUtensorMapDataType in = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr CUtensorMapDataType out = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <> struct Types<signed char> {
  typedef int Acc;
  typedef int2 Acc2;
  static constexpr CUtensorMapDataType in = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr CUtensorMapDataType out = CU_TENSOR_MAP_DATA_TYPE_INT32;
};

__device__ __forceinline__ void wgmma_k(float* acc, uint64_t da, uint64_t db, int accumulate) {
  fp::wgmma_m64n128k16_bf16(acc, da, db, accumulate);
}
__device__ __forceinline__ void wgmma_k(int* acc, uint64_t da, uint64_t db, int accumulate) {
  fp::wgmma_m64n128k32_s8(acc, da, db, accumulate);
}

// Shared memory besides the A ring: alignment slack, barriers, the W panel,
// two output subtiles per warpgroup.
size_t fixed_smem_bytes(int nkc) {
  return 1024 + 2 * MAX_STAGES * sizeof(uint64_t) + static_cast<size_t>(nkc) * SLICE_BYTES +
         4 * C_BUF_BYTES;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    micro_mm_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_c,
                    const T* __restrict__ w, int M, int N, int K, int stages) {
  typedef typename Types<T>::Acc Acc;
  typedef typename Types<T>::Acc2 Acc2;
  constexpr int KS = 128 / sizeof(T);  // k per 128-byte slice
  constexpr int VEC = 16 / sizeof(T);
  const int nkc = (K + KS - 1) / KS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Wp = smem;                    // [nkc][128 n][128 bytes], swizzled
  unsigned char* Cs = Wp + nkc * SLICE_BYTES;  // [2 warpgroups][2][64][128 bytes]
  unsigned char* As = Cs + 4 * C_BUF_BYTES;    // [stages][128 m][128 bytes], swizzled
  uint64_t* full = reinterpret_cast<uint64_t*>(As + stages * SLICE_BYTES);
  uint64_t* empty = full + MAX_STAGES;

  const int panels = N / BN, panel = blockIdx.x % panels;
  const int first = blockIdx.x / panels, step = gridDim.x / panels, mtiles = M / BM;
  const int n0 = panel * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      fp::mbar_init(&full[s], 1);
      fp::mbar_init(&empty[s], CONSUMERS / 32);  // one arrival per consumer warp
    }
    fp::mbar_init_fence();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {  // producer warp: A slices by TMA
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int mt = first; mt < mtiles; mt += step)
        for (int s = 0; s < nkc; ++s) {
          fp::mbar_wait(&empty[stage], phase ^ 1);
          fp::mbar_expect_tx(&full[stage], SLICE_BYTES);
          fp::tma_load_2d(As + stage * SLICE_BYTES, &tm_a, &full[stage], s * KS, mt * BM);
          if (++stage == stages) stage = 0, phase ^= 1;
        }
    }
    return;
  }

  // The W panel, transposed once: thread i takes k = i % kpad (lanes on
  // neighbouring k, so each row's stores are contiguous) and VEC columns.
  const int kpad = nkc * KS;
  for (int i = threadIdx.x; i < kpad * (BN / VEC); i += CONSUMERS) {
    const int k = i % kpad, nc = (i / kpad) * VEC;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (k < K) raw = *reinterpret_cast<const uint4*>(w + static_cast<size_t>(k) * N + n0 + nc);
    const T* vals = reinterpret_cast<const T*>(&raw);
    unsigned char* slice = Wp + (k / KS) * SLICE_BYTES;
    const uint32_t col = (k % KS) * sizeof(T);
#pragma unroll
    for (int e = 0; e < VEC; ++e) *reinterpret_cast<T*>(slice + fp::swizzle128(nc + e, col)) = vals[e];
  }
  fp::fence_async_smem();
  fp::named_sync(1, CONSUMERS);

  const int wg = warp / 4, lt = threadIdx.x % 128;
  const int r0 = 16 * (warp % 4) + lane / 4;  // accumulator rows r0 and r0 + 8
  unsigned char* Cw = Cs + wg * 2 * C_BUF_BYTES;
  Acc acc[64];
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int mt = first; mt < mtiles; mt += step) {
    // One wgmma group per slice; a slice's stage is released once the next
    // slice's group is issued and its own has completed.
    for (int s = 0; s < nkc; ++s) {
      fp::mbar_wait(&full[stage], phase);
      fp::wgmma_fence();
      const uint64_t da = fp::wgmma_desc_sw128(As + stage * SLICE_BYTES + wg * (SLICE_BYTES / 2));
      const uint64_t db = fp::wgmma_desc_sw128(Wp + s * SLICE_BYTES);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_k(acc, da + 2 * kk, db + 2 * kk, s > 0 || kk > 0);
      fp::wgmma_commit();
      if (s > 0) {
        fp::wgmma_wait<1>();
        if (lane == 0) fp::mbar_arrive(&empty[prev]);
      }
      prev = stage;
      if (++stage == stages) stage = 0, phase ^= 1;
    }
    fp::wgmma_wait<0>();
    if (lane == 0) fp::mbar_arrive(&empty[prev]);
    // Epilogue: the four [64 x 32] subtiles of this warpgroup's rows go
    // through two swizzled staging buffers, each stored by TMA without
    // waiting; a buffer is refilled once its store before last has read it.
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      unsigned char* buf = Cw + (c % 2) * C_BUF_BYTES;
      if (lt == 0) fp::tma_store_wait_read<1>();
      fp::named_sync(2 + wg, 128);
#pragma unroll
      for (int j = 4 * c; j < 4 * c + 4; ++j) {
        const uint32_t col = ((j % 4) * 8 + 2 * (lane % 4)) * 4;
        *reinterpret_cast<Acc2*>(buf + fp::swizzle128(r0, col)) = Acc2{acc[4 * j], acc[4 * j + 1]};
        *reinterpret_cast<Acc2*>(buf + fp::swizzle128(r0 + 8, col)) = Acc2{acc[4 * j + 2], acc[4 * j + 3]};
      }
      fp::fence_async_smem();
      fp::named_sync(2 + wg, 128);
      if (lt == 0) {
        fp::tma_store_2d(&tm_c, buf, n0 + 32 * c, mt * BM + 64 * wg);
        fp::tma_store_commit();
      }
    }
  }
  if (lt == 0) fp::tma_store_wait_all();
}

template <typename T>
int launch(const void* a, const void* w, void* c, int M, int N, int K, void* stream_ptr) {
  constexpr int ES = sizeof(T), KS = 128 / ES;
  const int nkc = (K + KS - 1) / KS;
  if (M < 1 || N < 1 || K < 1 || M % BM || N % BN || (K * ES) % 16 || nkc > MAX_NKC)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_a, tm_c;
  int rc = fp::encode_tensor_map_2d(&tm_a, a, Types<T>::in, ES, M, K, BM, KS,
                                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  rc = fp::encode_tensor_map_2d(&tm_c, c, Types<T>::out, 4, M, N, 64, 32, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int panels = N / BN;
  const int per_panel = std::max(1, std::min(M / BM, sms / panels));
  // The A ring takes what shared memory the W panel leaves: 6 stages at the
  // probe's bf16 shapes, 8 in int8.
  const int stages = static_cast<int>(
      std::min<size_t>(MAX_STAGES, (MAX_SMEM - fixed_smem_bytes(nkc)) / SLICE_BYTES));
  const size_t smem = fixed_smem_bytes(nkc) + static_cast<size_t>(stages) * SLICE_BYTES;
  cudaFuncSetAttribute(micro_mm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  micro_mm_kernel<T><<<panels * per_panel, THREADS, smem, static_cast<cudaStream_t>(stream_ptr)>>>(
      tm_a, tm_c, static_cast<const T*>(w), M, N, K, stages);
  return fp::launch_status();
}

}  // namespace

// a [M, K], w [K, N] row-major bf16 -> c [M, N] f32.
FP_EXPORT int fp_mm_bf16(const void* a, const void* w, void* c, int M, int N, int K,
                         void* stream_ptr) {
  return launch<bf16>(a, w, c, M, N, K, stream_ptr);
}

// a [M, K], w [K, N] row-major int8 -> c [M, N] int32.
FP_EXPORT int fp_mm_int8(const void* a, const void* w, void* c, int M, int N, int K,
                         void* stream_ptr) {
  return launch<signed char>(a, w, c, M, N, K, stream_ptr);
}
