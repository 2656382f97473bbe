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
// probe is bound by writing its output, in both types.
//
// What the design does about it: the simple form of a tensor-core GEMM.
// One block per 128 x 128 output tile (8 warps, each 32 x 64 through
// nvcuda::wmma 16x16x16, bf16 -> f32 or s8 -> s32), 32-deep K slices staged
// through shared memory, and the accumulators stored straight to device
// memory. Shared tiles are laid out [K / 16][128][16] (A row-major, W
// column-major) so every fragment pointer is 32-byte aligned for 1-byte
// elements too. No TMA, wgmma or pipelining yet.
#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int TM = 128, TN = 128, TK = 32, KB = 16, MM_THREADS = 256;

template <typename T, typename Acc>
__global__ void __launch_bounds__(MM_THREADS)
    micro_mm_kernel(const T* __restrict__ a, const T* __restrict__ w, Acc* __restrict__ c,
                    int M, int N, int K) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  __shared__ __align__(128) T As[TK / KB][TM][KB];
  __shared__ __align__(128) T Ws[TK / KB][TN][KB];  // column-major: [n][k]
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 64;

  wmma::fragment<wmma::accumulator, 16, 16, KB, Acc> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], Acc(0));

  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int i = threadIdx.x; i < TM * TK / VEC; i += MM_THREADS) {
      const int r = i / (TK / VEC), kc = (i % (TK / VEC)) * VEC;
      *reinterpret_cast<uint4*>(&As[kc / KB][r][kc % KB]) =
          *reinterpret_cast<const uint4*>(a + static_cast<size_t>(m0 + r) * K + k0 + kc);
    }
    for (int i = threadIdx.x; i < TK * TN / VEC; i += MM_THREADS) {
      const int kr = i / (TN / VEC), nc = (i % (TN / VEC)) * VEC;
      const uint4 raw =
          *reinterpret_cast<const uint4*>(w + static_cast<size_t>(k0 + kr) * N + n0 + nc);
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < VEC; ++e) Ws[kr / KB][nc + e][kr % KB] = vals[e];
    }
    __syncthreads();
#pragma unroll
    for (int kb = 0; kb < TK / KB; ++kb) {
      wmma::fragment<wmma::matrix_a, 16, 16, KB, T, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, KB, T, wmma::col_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], &As[kb][wm + 16 * i][0], KB);
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::load_matrix_sync(fb[j], &Ws[kb][wn + 16 * j][0], KB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(c + static_cast<size_t>(m0 + wm + 16 * i) * N + n0 + wn + 16 * j,
                              acc[i][j], N, wmma::mem_row_major);
}

template <typename T, typename Acc>
int launch(const void* a, const void* w, void* c, int M, int N, int K, void* stream_ptr) {
  if (M < 1 || N < 1 || K < 1 || M % TM || N % TN || K % TK)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(N / TN, M / TM);
  micro_mm_kernel<T, Acc><<<grid, MM_THREADS, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const T*>(a), static_cast<const T*>(w), static_cast<Acc*>(c), M, N, K);
  return fp::launch_status();
}

}  // namespace

// a [M, K], w [K, N] row-major bf16 -> c [M, N] f32.
FP_EXPORT int fp_mm_bf16(const void* a, const void* w, void* c, int M, int N, int K,
                         void* stream_ptr) {
  return launch<bf16, float>(a, w, c, M, N, K, stream_ptr);
}

// a [M, K], w [K, N] row-major int8 -> c [M, N] int32.
FP_EXPORT int fp_mm_int8(const void* a, const void* w, void* c, int M, int N, int K,
                         void* stream_ptr) {
  return launch<signed char, int>(a, w, c, M, N, K, stream_ptr);
}
