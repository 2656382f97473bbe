// RANSAC hypothesis scoring on Hopper: the masked inlier count of every
// pose hypothesis of a correspondence set.
//
// Replaces: foundpose_tpu/pose/pnp.py:_score_kernel (one Pallas call per
// correspondence set, the [N, H] projections kept in VMEM).
//
// What bounds it on the H100: nothing the card is short of. A batch of 16
// crops x 5 templates is 80 sets x 300 points x 200 hypotheses = 4.8 M
// point tests (~0.1 GFLOP) on ~0.8 MB of inputs, so the kernel is bound by
// its launch and by the latency of one block's walk over its points.
//
// What the design does about it: one launch scores every set of the batch
// (one block per set, one thread per hypothesis). A block stages its set's
// points in shared memory once; each thread keeps its 12 pose coefficients
// in registers and loops over the points, so no [N, H] intermediate exists
// anywhere.
//
// The test is the TPU kernel's division-free form: with focal / threshold
// folded into A and 1 / threshold into duv, e = cam_xy + duv * cam_z and a
// point is an inlier iff |e|^2 < cam_z^2 and cam_z > 0. Every product and
// sum is rounded in the order the plain PyTorch twin evaluates it
// (pose/pnp.py:score_hypotheses_plain), so the two agree bit for bit.
#include "common.cuh"

namespace {

constexpr int STHREADS = 256;

__device__ __forceinline__ float dot4(float x, float y, float z, float w,
                                      const float* a) {
  float s = __fmul_rn(x, a[0]);
  s = __fadd_rn(s, __fmul_rn(y, a[1]));
  s = __fadd_rn(s, __fmul_rn(z, a[2]));
  return __fadd_rn(s, __fmul_rn(w, a[3]));
}

__global__ void __launch_bounds__(STHREADS)
    score_kernel(const float* __restrict__ pts4, const float* __restrict__ duv,
                 const float* __restrict__ valid, const float* __restrict__ A,
                 float* __restrict__ counts, int N, int H) {
  extern __shared__ float sm[];
  float* P = sm;          // [N, 4]
  float* U = sm + 4 * N;  // [N, 2]
  float* V = U + 2 * N;   // [N]
  const int s = blockIdx.x;
  for (int i = threadIdx.x; i < 4 * N; i += blockDim.x)
    P[i] = pts4[static_cast<size_t>(s) * 4 * N + i];
  for (int i = threadIdx.x; i < 2 * N; i += blockDim.x)
    U[i] = duv[static_cast<size_t>(s) * 2 * N + i];
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    V[i] = valid[static_cast<size_t>(s) * N + i];
  __syncthreads();

  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    float a[12];
#pragma unroll
    for (int r = 0; r < 12; ++r) a[r] = A[(static_cast<size_t>(s) * 12 + r) * H + h];
    float cnt = 0.f;
    for (int n = 0; n < N; ++n) {
      const float x = P[4 * n], y = P[4 * n + 1], z = P[4 * n + 2], w = P[4 * n + 3];
      const float camx = dot4(x, y, z, w, a);
      const float camy = dot4(x, y, z, w, a + 4);
      const float camz = dot4(x, y, z, w, a + 8);
      const float ex = __fadd_rn(camx, __fmul_rn(U[2 * n], camz));
      const float ey = __fadd_rn(camy, __fmul_rn(U[2 * n + 1], camz));
      const bool inl = __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)) <
                           __fmul_rn(camz, camz) &&
                       camz > 0.f;
      if (inl) cnt = __fadd_rn(cnt, V[n]);
    }
    counts[static_cast<size_t>(s) * H + h] = cnt;
  }
}

}  // namespace

// pts4 [S, N, 4], duv [S, N, 2], valid [S, N], A [S, 12, H] (all f32)
// -> counts [S, H] f32.
FP_EXPORT int fp_score_hypotheses(const void* pts4, const void* duv,
                                  const void* valid, const void* A,
                                  void* counts, int sets, int N, int H,
                                  void* stream_ptr) {
  if (sets < 1 || N < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * 7 * static_cast<size_t>(N);
  cudaFuncSetAttribute(score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  score_kernel<<<sets, STHREADS, smem, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const float*>(pts4), static_cast<const float*>(duv),
      static_cast<const float*>(valid), static_cast<const float*>(A),
      static_cast<float*>(counts), N, H);
  return fp::launch_status();
}
