// The winners' LO refits and Levenberg-Marquardt refinement on Hopper: for
// every correspondence set, `lo_iters` overdetermined DLT refits on the
// current pose's inliers (threshold 2x, then 1x) accepted by inlier count,
// then `lm_iters` damped Gauss-Newton steps on the inliers' reprojection
// error, keeping the LM's input pose where the refined one is not finite.
//
// Replaces no TPU kernel: the JAX package leaves LO and LM
// (foundpose_tpu/pose/pnp.py: lo_refine, refine_pose_lm) to XLA, which
// fuses them inside one jitted program. Its eager PyTorch form
// (pose/pnp.py: lo_refine, then refine_pose_lm_guarded, kept as the plain
// twin) issued ~4,400 host launches for one batch of winners, and the card
// sat idle while the host issued them: 73-100 ms of every step.
//
// What bounds it on the H100: neither bytes nor operations. A batch of 128
// sets x 300 points reads ~0.9 MB (well under a microsecond at 3.35 TB/s)
// and does ~20 passes of a few dozen flops a point. What is left is the
// latency of ~20 dependent block-wide reductions, each followed by a small
// serial solve (a 12x12 Cholesky and four inverse-iteration solves for a
// refit, a 6x6 one for an LM step): tens of microseconds.
//
// What the design does about it: one launch for the whole batch, one block
// of 128 threads per set, so the sets run side by side on the SMs. The
// block walks the set's points in strides of 128 (any N), each thread
// always the same points, and every sum is folded in a fixed order (warp
// shuffles, then the four warps' partials by thread 0), so a quantity
// recomputed at the same pose is the same bit for bit: the final inlier
// mask is recomputed from the final pose rather than kept, and each LM
// step's candidate pass also yields the next step's J^T J, J^T r and cost,
// so an LM step is one pass over the points, not two. Thread 0 runs the
// small solves in registers and publishes poses through shared memory.
//
// The arithmetic is the twin's, in float32: the Hartley normalisation over
// the valid points, the 40 distinct sums of the 64 DLT features, the trace
// normalisation and +1e-9 I, the lane-major Cholesky with its pivot floored
// at 1e-30, four inverse iterations from cos(0.7 i + 0.3), the sign and
// cube-root scale, eight Newton polar steps (csrc/dlt.cuh, shared with
// RANSAC's minimal solves in csrc/hypotheses.cu); the closed-form Jacobian,
// Rodrigues and the left-multiplied update, the accept on new_cost < cost
// and lambda x0.3 / x3 clamped to [1e-9, 1e6]. Clamps keep NaN as torch's
// do, and masked terms are multiplied by their 0/1 weight, not skipped, so
// a non-finite padding entry poisons a sum as it does in the twin. Only the
// order of the sums differs, and the compiler may contract products and
// sums into FMAs.
#include "dlt.cuh"

namespace {

constexpr int RTHREADS = 128;
constexpr int RWARPS = RTHREADS / 32;
constexpr int LM_SUMS = 28;   // cost, J^T J (21, lower triangle), J^T r (6)

// Index of J^T J's entry (i, j), i >= j, in the 21 lower-triangle sums.
__host__ __device__ constexpr int tri_index(int i, int j) { return i * (i + 1) / 2 + j; }

// Block-wide sums of acc[0..K): each warp folds by shuffles, thread 0 then
// adds the warps' partials in order; only thread 0's `out` is set.
template <int K>
__device__ __forceinline__ void block_sums(const float (&acc)[K], float (*red)[fp::DLT_SUMS],
                                           float (&out)[K]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float v = fp::warp_sum(acc[k]);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float s = red[0][k];
#pragma unroll
      for (int w = 1; w < RWARPS; ++w) s += red[w][k];
      out[k] = s;
    }
  }
}

// Pose as 12 floats: R row-major, then t.
__device__ __forceinline__ void camera_point(const float* pose, float x, float y, float z,
                                             float& cx, float& cy, float& cz) {
  cx = pose[0] * x + pose[1] * y + pose[2] * z + pose[9];
  cy = pose[3] * x + pose[4] * y + pose[5] * z + pose[10];
  cz = pose[6] * x + pose[7] * y + pose[8] * z + pose[11];
}

// pnp._project's depth: |z| < 1e-9 becomes 1e-9.
__device__ __forceinline__ float safe_depth(float z) { return fabsf(z) < 1e-9f ? 1e-9f : z; }

// pnp._inliers for one point.
__device__ __forceinline__ bool is_inlier(const float* pose, float x, float y, float z, float qx,
                                          float qy, bool valid, float fx, float fy, float kx,
                                          float ky, float thr2) {
  float cx, cy, cz;
  camera_point(pose, x, y, z, cx, cy, cz);
  const float d = safe_depth(cz);
  const float ex = cx / d * fx + kx - qx;
  const float ey = cy / d * fy + ky - qy;
  return ex * ex + ey * ey < thr2 && valid && cz > 0.f;
}

// One point's share of refine_pose_lm's cost, J^T J and J^T r at `pose`
// under weight w (0 or 1).
__device__ __forceinline__ void lm_point(const float* pose, float x, float y, float z, float qx,
                                         float qy, float w, float fx, float fy, float kx,
                                         float ky, float (&acc)[LM_SUMS]) {
  float cx, cy, cz;
  camera_point(pose, x, y, z, cx, cy, cz);
  const float d = safe_depth(cz);
  const float ru = (cx / d * fx + kx - qx) * w;
  const float rv = (cy / d * fy + ky - qy) * w;
  acc[0] += ru * ru + rv * rv;
  const float iz = 1.f / d;
  const float a = cx * iz, b = cy * iz;
  const float wfx = w * fx, wfy = w * fy;
  const float ju[6] = {-wfx * a * b, wfx * (1.f + a * a), -wfx * b, wfx * iz, 0.f,
                       -wfx * a * iz};
  const float jv[6] = {-wfy * (1.f + b * b), wfy * a * b, wfy * a, 0.f, wfy * iz,
                       -wfy * b * iz};
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) acc[1 + tri_index(i, j)] += ju[i] * ju[j] + jv[i] * jv[j];
    acc[22 + i] += ju[i] * ru + jv[i] * rv;
  }
}

// geometry.rodrigues, then the left-multiplied update of pnp.refine_pose_lm:
// R' = dR R, t' = dR t + dt, with (dw, dt) = -delta.
__device__ __forceinline__ void lm_update(const float* pose, const float (&delta)[6],
                                          float* out) {
  const float w[3] = {-delta[0], -delta[1], -delta[2]};
  const float theta = sqrtf(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]);
  float dr[9];
  if (theta < 1e-8f) {  // I + [w]x
    dr[0] = 1.f, dr[1] = -w[2], dr[2] = w[1];
    dr[3] = w[2], dr[4] = 1.f, dr[5] = -w[0];
    dr[6] = -w[1], dr[7] = w[0], dr[8] = 1.f;
  } else {  // I + sin(theta) K + (1 - cos(theta)) K K, K = [w / theta]x
    const float x = w[0] / theta, y = w[1] / theta, z = w[2] / theta;
    const float k[9] = {0.f, -z, y, z, 0.f, -x, -y, x, 0.f};
    const float s = sinf(theta), c1 = 1.f - cosf(theta);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float kk = k[3 * i] * k[j] + k[3 * i + 1] * k[3 + j] + k[3 * i + 2] * k[6 + j];
        dr[3 * i + j] = (i == j ? 1.f : 0.f) + s * k[3 * i + j] + c1 * kk;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[3 * i + j] = dr[3 * i] * pose[j] + dr[3 * i + 1] * pose[3 + j] + dr[3 * i + 2] * pose[6 + j];
    out[9 + i] = dr[3 * i] * pose[9] + dr[3 * i + 1] * pose[10] + dr[3 * i + 2] * pose[11] -
                 delta[3 + i];
  }
}

// The damped step of pnp.refine_pose_lm from the current sums and lambda.
__device__ __forceinline__ void lm_step(const float* pose, const float (&sums)[LM_SUMS],
                                        float lam, float* out) {
  float a[6][6];
  float b[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) a[i][j] = sums[1 + tri_index(i, j)] + (i == j ? lam : 0.f);
    b[i] = sums[22 + i];
  }
  fp::cholesky<6>(a);
  float delta[6];
  fp::cho_solve<6>(a, b, delta);
  lm_update(pose, delta, out);
}

__global__ void __launch_bounds__(RTHREADS)
    refine_kernel(const float* __restrict__ pts2d, const float* __restrict__ pts3d,
                  const unsigned char* __restrict__ valid, const float* __restrict__ k_f,
                  const float* __restrict__ k_c, const float* __restrict__ r_in,
                  const float* __restrict__ t_in, const unsigned char* __restrict__ inl_in,
                  const float* __restrict__ cnt_in, float thr2, float thr2_wide, int lo_iters,
                  int lm_iters, float* __restrict__ r_out, float* __restrict__ t_out,
                  unsigned char* __restrict__ inl_out, float* __restrict__ cnt_out, int N) {
  __shared__ float red[RWARPS][fp::DLT_SUMS];
  __shared__ float pose[12];  // the current best pose (LO), read by every thread
  __shared__ float cand[12];  // a refit or an LM candidate
  __shared__ float hart[4];   // mu, then the Hartley scale
  __shared__ int go, accepted;
  const int s = blockIdx.x, tid = threadIdx.x;
  const float* p2 = pts2d + static_cast<size_t>(s) * N * 2;
  const float* p3 = pts3d + static_cast<size_t>(s) * N * 3;
  const unsigned char* vm = valid + static_cast<size_t>(s) * N;
  const unsigned char* im = inl_in + static_cast<size_t>(s) * N;
  unsigned char* om = inl_out + static_cast<size_t>(s) * N;
  const float fx = k_f[2 * s], fy = k_f[2 * s + 1], kx = k_c[2 * s], ky = k_c[2 * s + 1];

  float count = 0.f;  // thread 0's: the base-threshold inlier count
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) pose[k] = r_in[9 * s + k];
#pragma unroll
    for (int k = 0; k < 3; ++k) pose[9 + k] = t_in[3 * s + k];
    count = cnt_in[s];
    accepted = 0;
  }
  __syncthreads();

  if (lo_iters > 0) {
    // Hartley statistics over the valid points: mu, then the mean distance.
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int n = tid; n < N; n += RTHREADS) {
      const float v = vm[n] ? 1.f : 0.f;
      acc[0] += p3[3 * n] * v, acc[1] += p3[3 * n + 1] * v, acc[2] += p3[3 * n + 2] * v;
      acc[3] += v;
    }
    float tot[4];
    block_sums<4>(acc, red, tot);
    float cnt = 1.f;  // thread 0's
    if (tid == 0) {
      cnt = fp::clamp_min(tot[3], 1.f);
      for (int k = 0; k < 3; ++k) hart[k] = tot[k] / cnt;
    }
    __syncthreads();
    const float mx = hart[0], my = hart[1], mz = hart[2];
    float sp[1] = {0.f};
    for (int n = tid; n < N; n += RTHREADS) {
      const float dx = p3[3 * n] - mx, dy = p3[3 * n + 1] - my, dz = p3[3 * n + 2] - mz;
      sp[0] += sqrtf(dx * dx + dy * dy + dz * dz) * (vm[n] ? 1.f : 0.f);
    }
    float spread[1];
    block_sums<1>(sp, red, spread);
    if (tid == 0) hart[3] = fp::SQRT3 / fp::clamp_min(spread[0] / cnt, 1e-12f);
    __syncthreads();
    const float hs = hart[3];

    for (int li = 0; li < lo_iters; ++li) {
      // The refit on the inliers at the widened threshold.
      const float fit_thr2 = li == 0 ? thr2_wide : thr2;
      float f[fp::DLT_SUMS];
#pragma unroll
      for (int k = 0; k < fp::DLT_SUMS; ++k) f[k] = 0.f;
      for (int n = tid; n < N; n += RTHREADS) {
        const float x = p3[3 * n], y = p3[3 * n + 1], z = p3[3 * n + 2];
        const float qx = p2[2 * n], qy = p2[2 * n + 1];
        const float c = is_inlier(pose, x, y, z, qx, qy, vm[n], fx, fy, kx, ky, fit_thr2)
                            ? 1.f : 0.f;
        const float u = (qx - kx) / fx, v = (qy - ky) / fy, uv = u * u + v * v;
        const float xh[4] = {(x - mx) * hs, (y - my) * hs, (z - mz) * hs, 1.f};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = i; j < 4; ++j) {
            const float o = xh[i] * xh[j];
            const int p = fp::pair_index(i, j);
            f[p] += c * o;
            f[10 + p] += c * (o * u);
            f[20 + p] += c * (o * v);
            f[30 + p] += c * (o * uv);
          }
        }
      }
      float sums[fp::DLT_SUMS];
      block_sums<fp::DLT_SUMS>(f, red, sums);
      if (tid == 0) {
        const float mu[3] = {mx, my, mz};
        float lo[12];
        fp::dlt_solve(sums, mu, hs, lo);
        go = fp::all_finite(lo);
#pragma unroll
        for (int k = 0; k < 12; ++k) cand[k] = lo[k];
      }
      __syncthreads();
      if (go) {
        // Accepted where the refit keeps at least as many base-threshold inliers.
        float in[1] = {0.f};
        for (int n = tid; n < N; n += RTHREADS)
          in[0] += is_inlier(cand, p3[3 * n], p3[3 * n + 1], p3[3 * n + 2], p2[2 * n],
                             p2[2 * n + 1], vm[n], fx, fy, kx, ky, thr2) ? 1.f : 0.f;
        float cnt_lo[1];
        block_sums<1>(in, red, cnt_lo);
        if (tid == 0 && cnt_lo[0] >= count) {
#pragma unroll
          for (int k = 0; k < 12; ++k) pose[k] = cand[k];
          count = cnt_lo[0];
          accepted = 1;
        }
        __syncthreads();
      }
    }
  }

  // The final inliers: those of the accepted refit (recomputed at its pose,
  // which reproduces its count's mask) or the input's; they weight the LM.
  // With LM on, the same pass sums the LM's terms at the post-LO pose.
  float acc[LM_SUMS];
#pragma unroll
  for (int k = 0; k < LM_SUMS; ++k) acc[k] = 0.f;
  const bool refit = accepted;
  for (int n = tid; n < N; n += RTHREADS) {
    const float x = p3[3 * n], y = p3[3 * n + 1], z = p3[3 * n + 2];
    const float qx = p2[2 * n], qy = p2[2 * n + 1];
    const bool w = refit ? is_inlier(pose, x, y, z, qx, qy, vm[n], fx, fy, kx, ky, thr2)
                         : im[n] != 0;
    om[n] = w;
    if (lm_iters > 0) lm_point(pose, x, y, z, qx, qy, w ? 1.f : 0.f, fx, fy, kx, ky, acc);
  }

  float cur[12];  // thread 0's: the LM's pose
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < 12; ++k) cur[k] = pose[k];
  }
  if (lm_iters > 0) {
    float sums[LM_SUMS];
    block_sums<LM_SUMS>(acc, red, sums);
    float lam = 1e-3f;
    for (int it = 0; it < lm_iters; ++it) {
      if (tid == 0) lm_step(cur, sums, lam, cand);
      __syncthreads();
      // The candidate's cost, and its J^T J and J^T r for the next step
      // should it be accepted (the twin recomputes them at the same pose).
#pragma unroll
      for (int k = 0; k < LM_SUMS; ++k) acc[k] = 0.f;
      for (int n = tid; n < N; n += RTHREADS)
        lm_point(cand, p3[3 * n], p3[3 * n + 1], p3[3 * n + 2], p2[2 * n], p2[2 * n + 1],
                 om[n] ? 1.f : 0.f, fx, fy, kx, ky, acc);
      float next[LM_SUMS];
      block_sums<LM_SUMS>(acc, red, next);
      if (tid == 0) {
        const bool improved = next[0] < sums[0];
        if (improved) {
#pragma unroll
          for (int k = 0; k < 12; ++k) cur[k] = cand[k];
#pragma unroll
          for (int k = 0; k < LM_SUMS; ++k) sums[k] = next[k];
        }
        lam = improved ? lam * 0.3f : lam * 3.f;
        lam = lam < 1e-9f ? 1e-9f : (lam > 1e6f ? 1e6f : lam);
      }
    }
  }

  if (tid == 0) {
    // refine_pose_lm_guarded: keep the LM's input pose where the result is
    // not finite.
    const bool ok = fp::all_finite(cur);
#pragma unroll
    for (int k = 0; k < 9; ++k) r_out[9 * s + k] = ok ? cur[k] : pose[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) t_out[3 * s + k] = ok ? cur[9 + k] : pose[9 + k];
    cnt_out[s] = count;
  }
}

}  // namespace

// pts2d [S, N, 2], pts3d [S, N, 3], k_f / k_c [S, 2], r [S, 3, 3], t [S, 3],
// count [S] contiguous f32; valid and inliers [S, N] contiguous bool (one
// byte, 0/1); thr2 and thr2_wide the squared base and widened thresholds
// -> r_out, t_out, inliers_out (bool), count_out of the same shapes.
FP_EXPORT int fp_refine_lo_lm(const void* pts2d, const void* pts3d, const void* valid,
                              const void* k_f, const void* k_c, const void* r, const void* t,
                              const void* inliers, const void* count, float thr2,
                              float thr2_wide, int lo_iters, int lm_iters, void* r_out,
                              void* t_out, void* inliers_out, void* count_out, int sets, int N,
                              void* stream_ptr) {
  if (sets < 1 || N < 1 || lo_iters < 0 || lm_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  refine_kernel<<<sets, RTHREADS, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const float*>(pts2d), static_cast<const float*>(pts3d),
      static_cast<const unsigned char*>(valid), static_cast<const float*>(k_f),
      static_cast<const float*>(k_c), static_cast<const float*>(r), static_cast<const float*>(t),
      static_cast<const unsigned char*>(inliers), static_cast<const float*>(count), thr2,
      thr2_wide, lo_iters, lm_iters, static_cast<float*>(r_out), static_cast<float*>(t_out),
      static_cast<unsigned char*>(inliers_out), static_cast<float*>(count_out), N);
  return fp::launch_status();
}
