// RANSAC's hypotheses on Hopper: for every correspondence set and every
// hypothesis, the minimal sample its six raw draws pick and the pose the
// DLT solves from that sample, with the finite fix.
//
// Replaces no TPU kernel: the JAX package leaves the sampling and the
// minimal solves (foundpose_tpu/pose/pnp.py: ransac_pnp's sampling at :456,
// _dlt_pose_many at :242) to XLA, which fuses them inside one jitted
// program. Their eager PyTorch form (pose/pnp.py: sample_counts,
// _dlt_pose_many and the finite fix, kept as the plain twin) launches
// ~1,100 device kernels for one batch of sets, each over S x H lanes, and
// the card waits while the host issues them.
//
// What bounds it on the H100: neither bytes nor operations. 640 sets x 200
// hypotheses read 6 MB of int64 draws and 2.7 MB of points and write 6 MB
// of poses (~4.5 us at 3.35 TB/s), and do ~0.4 GFLOP of f32 (~6 us at 67
// TFLOP/s); what is left is the latency of one hypothesis's serial chain:
// a 12x12 Cholesky with its 12 square roots and 78 divisions, four
// inverse-iteration solves, eight 3x3 Newton polar steps.
//
// What the design does about it: one launch for the whole batch, a block
// of 64 threads per (set, tile of 64 hypotheses), so the chains of 128,000
// hypotheses run side by side, one a thread. The block first walks the
// set's points in index order (any N): the valid points' coordinate sums
// (Hartley's mu, folded in a fixed order: warp shuffles, then the warps'
// partials in order, so every thread holds the same totals), then their
// mean distance from mu, and, from a ballot of each chunk's valid mask, the
// rank-to-point map of the valid points in shared memory (4 bytes a point:
// N up to 57,344 in the 224 KB a block may take). Each thread then reduces
// its six draws modulo the set's valid count (torch's %, which takes the
// divisor's sign), looks the picked points up by rank (a repeated draw is
// added again, as the twin's counts do), sums their 40 features and solves.
//
// Registers: a thread holds one hypothesis's 40 sums, then the 78 entries
// of the 12x12 system's lower triangle (the sums die as it is built), and
// the 12-vectors of the inverse iteration; fully unrolled with constant
// indices, all stay in registers. The block of 64 threads leaves the
// compiler up to 255 registers a thread; ptxas gives it 115 and no spill
// and no stack frame (PERF.md records the build's line).
//
// Non-finite padding: the twin multiplies every point's features by its
// 0/1 count and mu by the 0/1 mask, so one non-finite entry anywhere in a
// set (a coordinate of pts3d, a ray of pts2d, valid or not) makes every
// hypothesis of the set non-finite, and the finite fix gives each R = I,
// t = (0, 0, 1). The kernel keeps that outcome with an explicit per-set
// flag, since a thread sums only its six picked points: mu, the Hartley
// scale and a sum of 0 * ray over every point are finite, or the whole set
// takes the fix.
//
// The arithmetic is the twin's, in float32 (csrc/dlt.cuh, shared with the
// LO refits of csrc/refine.cu): rays (q - c) / f, xh = ((p - mu) s, 1), the
// 40 distinct sums of the 64 features, then dlt_solve. The sums run over
// six points in another order than the twin's einsum over N, so results
// agree within rounding, which the 12x12 solve amplifies where the sample
// is near degenerate; not bit for bit.
#include "dlt.cuh"

namespace {

constexpr int HTHREADS = 64;  // hypotheses per block, one per thread
constexpr int HWARPS = HTHREADS / 32;
constexpr int SAMPLE = 6;     // points of a minimal sample
constexpr int STATS = 5;      // x, y, z sums over the valid points, their count, the rays' 0 sum
// Dynamic shared memory a block may take: the rank map's 4 bytes a point
// (the H100's 227 KB less room for the static buffers).
constexpr size_t MAX_SMEM = 224 * 1024;

// Block-wide sums of acc[0..K) into acc in every thread: each warp folds by
// shuffles, then every thread adds the warps' partials in order.
template <int K>
__device__ __forceinline__ void block_totals(float (&acc)[K], float (*red)[STATS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float v = fp::warp_sum(acc[k]);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    acc[k] = red[0][k];
#pragma unroll
    for (int w = 1; w < HWARPS; ++w) acc[k] += red[w][k];
  }
  __syncthreads();  // red is written again by the next call
}

__global__ void __launch_bounds__(HTHREADS)
    hypotheses_kernel(const float* __restrict__ pts2d, const float* __restrict__ pts3d,
                      const unsigned char* __restrict__ valid, const float* __restrict__ k_f,
                      const float* __restrict__ k_c, const long long* __restrict__ draws,
                      float* __restrict__ rs, float* __restrict__ ts, int N, int H) {
  extern __shared__ int rank_point[];  // [N]: the index of the valid point of each rank
  __shared__ float red[HWARPS][STATS];
  __shared__ int warp_valid[HWARPS];
  const int s = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* p2 = pts2d + static_cast<size_t>(s) * N * 2;
  const float* p3 = pts3d + static_cast<size_t>(s) * N * 3;
  const unsigned char* vm = valid + static_cast<size_t>(s) * N;
  const float fx = k_f[2 * s], fy = k_f[2 * s + 1], kx = k_c[2 * s], ky = k_c[2 * s + 1];

  // The valid points' sums, the rays' 0 sum (NaN once a ray is not
  // finite) and the rank map, a chunk of 64 points at a time.
  float acc[STATS] = {0.f, 0.f, 0.f, 0.f, 0.f};
  int count = 0;  // valid points of the chunks so far, the same in every thread
  for (int base = 0; base < N; base += HTHREADS) {
    const int n = base + tid;
    const bool v = n < N && vm[n] != 0;
    if (n < N) {
      const float w = v ? 1.f : 0.f;
      acc[0] += p3[3 * n] * w, acc[1] += p3[3 * n + 1] * w, acc[2] += p3[3 * n + 2] * w;
      acc[3] += w;
      acc[4] += 0.f * ((p2[2 * n] - kx) / fx) + 0.f * ((p2[2 * n + 1] - ky) / fy);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, v);
    if (lane == 0) warp_valid[warp] = __popc(ballot);
    __syncthreads();
    int rank = count + __popc(ballot & ((1u << lane) - 1u));
#pragma unroll
    for (int w = 0; w < HWARPS; ++w) {
      if (w < warp) rank += warp_valid[w];
      count += warp_valid[w];
    }
    if (v) rank_point[rank] = n;
    __syncthreads();  // the map is whole, and warp_valid free, before it is read or written
  }
  block_totals<STATS>(acc, red);
  const float cnt = fp::clamp_min(acc[3], 1.f);
  const float mu[3] = {acc[0] / cnt, acc[1] / cnt, acc[2] / cnt};
  float spread[1] = {0.f};
  for (int n = tid; n < N; n += HTHREADS) {
    const float dx = p3[3 * n] - mu[0], dy = p3[3 * n + 1] - mu[1], dz = p3[3 * n + 2] - mu[2];
    spread[0] += sqrtf(dx * dx + dy * dy + dz * dz) * (vm[n] ? 1.f : 0.f);
  }
  block_totals<1>(spread, red);
  const float hs = fp::SQRT3 / fp::clamp_min(spread[0] / cnt, 1e-12f);
  const bool poisoned = !(isfinite(acc[4]) && isfinite(mu[0]) && isfinite(mu[1]) &&
                          isfinite(mu[2]) && isfinite(hs));

  const int h = blockIdx.y * HTHREADS + tid;
  if (h >= H) return;
  const size_t hyp = static_cast<size_t>(s) * H + h;
  float pose[12] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 1.f};  // the fix
  if (!poisoned) {
    const long long m = count > 0 ? count : 1;  // sample_counts' clamp
    float f[fp::DLT_SUMS];
#pragma unroll
    for (int k = 0; k < fp::DLT_SUMS; ++k) f[k] = 0.f;
#pragma unroll
    for (int j = 0; j < SAMPLE; ++j) {
      long long r = draws[hyp * SAMPLE + j] % m;
      if (r < 0) r += m;
      if (count == 0) continue;  // no valid point: the twin's sample is empty
      const int n = rank_point[r];
      const float qx = p2[2 * n], qy = p2[2 * n + 1];
      const float u = (qx - kx) / fx, v = (qy - ky) / fy, uv = u * u + v * v;
      const float xh[4] = {(p3[3 * n] - mu[0]) * hs, (p3[3 * n + 1] - mu[1]) * hs,
                           (p3[3 * n + 2] - mu[2]) * hs, 1.f};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = a; b < 4; ++b) {
          const float o = xh[a] * xh[b];
          const int p = fp::pair_index(a, b);
          f[p] += o;
          f[10 + p] += o * u;
          f[20 + p] += o * v;
          f[30 + p] += o * uv;
        }
      }
    }
    float solved[12];
    fp::dlt_solve(f, mu, hs, solved);
    if (fp::all_finite(solved)) {
#pragma unroll
      for (int k = 0; k < 12; ++k) pose[k] = solved[k];
    }
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) rs[hyp * 9 + k] = pose[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) ts[hyp * 3 + k] = pose[9 + k];
}

}  // namespace

// pts2d [S, N, 2], pts3d [S, N, 3], k_f / k_c [S, 2] contiguous f32; valid
// [S, N] contiguous bool (one byte, 0/1); draws [S, H, 6] contiguous int64
// -> rs [S, H, 3, 3], ts [S, H, 3] contiguous f32.
FP_EXPORT int fp_dlt_hypotheses(const void* pts2d, const void* pts3d, const void* valid,
                                const void* k_f, const void* k_c, const void* draws, void* rs,
                                void* ts, int sets, int N, int H, void* stream_ptr) {
  const size_t smem = static_cast<size_t>(N) * sizeof(int);
  if (sets < 1 || N < 1 || H < 1 || smem > MAX_SMEM || (H + HTHREADS - 1) / HTHREADS > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      hypotheses_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(MAX_SMEM));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(sets, (H + HTHREADS - 1) / HTHREADS);
  hypotheses_kernel<<<grid, HTHREADS, smem, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const float*>(pts2d), static_cast<const float*>(pts3d),
      static_cast<const unsigned char*>(valid), static_cast<const float*>(k_f),
      static_cast<const float*>(k_c), static_cast<const long long*>(draws),
      static_cast<float*>(rs), static_cast<float*>(ts), N, H);
  return fp::launch_status();
}
