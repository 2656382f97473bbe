// The DLT's small dense algebra, shared by the kernels that solve poses
// from the 40 weighted feature sums (csrc/refine.cu: the LO refits;
// csrc/hypotheses.cu: RANSAC's minimal samples): the float32 forms of
// pose/pnp.py's lane-major Cholesky, cho_solve, Newton polar iteration and
// _dlt_pose_many at H = 1, in the twin's order of operations.
#pragma once

#include "common.cuh"

namespace fp {

constexpr int DLT_SUMS = 40;  // the 10 distinct products of (x, y, z, 1) x {1, u, v, u^2 + v^2}
constexpr float SQRT3 = 1.7320508075688772f;

// torch.clamp_min: NaN stays NaN (fmaxf would drop it).
__device__ __forceinline__ float clamp_min(float v, float lo) { return v < lo ? lo : v; }

// Index of the product x_i x_j (i <= j) among the 10 distinct ones.
__host__ __device__ constexpr int pair_index(int i, int j) {
  return i <= j ? i * 4 - i * (i - 1) / 2 + (j - i) : j * 4 - j * (j - 1) / 2 + (i - j);
}

// pnp._cholesky_lane_major in place on the lower triangle of a.
template <int n>
__device__ __forceinline__ void cholesky(float (&a)[n][n]) {
#pragma unroll
  for (int j = 0; j < n; ++j) {
    float s[n];
#pragma unroll
    for (int i = j; i < n; ++i) {
      float dot = 0.f;
#pragma unroll
      for (int k = 0; k < j; ++k) dot += a[i][k] * a[j][k];
      s[i] = a[i][j] - dot;
    }
    const float d = sqrtf(clamp_min(s[j], 1e-30f));
#pragma unroll
    for (int i = j; i < n; ++i) a[i][j] = s[i] / d;
  }
}

// pnp._cho_solve_lane_major: (L L^T) x = b.
template <int n>
__device__ __forceinline__ void cho_solve(const float (&l)[n][n], const float (&b)[n],
                                          float (&x)[n]) {
  float y[n];
#pragma unroll
  for (int i = 0; i < n; ++i) {
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < i; ++k) dot += l[i][k] * y[k];
    y[i] = (b[i] - dot) / l[i][i];
  }
#pragma unroll
  for (int i = n - 1; i >= 0; --i) {
    float dot = 0.f;
#pragma unroll
    for (int k = i + 1; k < n; ++k) dot += l[k][i] * x[k];
    x[i] = (y[i] - dot) / l[i][i];
  }
}

// pnp._polar_rotation_lane_major: the Newton polar iteration, 8 steps.
__device__ __forceinline__ void polar_rotation(float (&m)[9]) {
  float nrm = 0.f;
#pragma unroll
  for (int i = 0; i < 9; ++i) nrm += m[i] * m[i];
  const float sc = SQRT3 / clamp_min(sqrtf(nrm), 1e-30f);
#pragma unroll
  for (int i = 0; i < 9; ++i) m[i] *= sc;
#pragma unroll
  for (int it = 0; it < 8; ++it) {
    const float a = m[0], b = m[1], c = m[2], d = m[3], e = m[4], f = m[5], g = m[6], h = m[7],
                i = m[8];
    const float co_a = e * i - f * h, co_b = -(d * i - f * g), co_c = d * h - e * g;
    const float det = a * co_a + b * co_b + c * co_c;
    const float inv_det = 1.f / (fabsf(det) < 1e-30f ? 1e-30f : det);
    // The inverse is adj * inv_det; x + inv^T takes its transpose.
    const float inv_t[9] = {co_a, co_b, co_c,
                            -(b * i - c * h), a * i - c * g, -(a * h - b * g),
                            b * f - c * e, -(a * f - c * d), a * e - b * d};
#pragma unroll
    for (int k = 0; k < 9; ++k) m[k] = 0.5f * (m[k] + inv_t[k] * inv_det);
  }
}

// pnp._dlt_pose_many at H = 1 from the 40 weighted feature sums, with the
// Hartley statistics mu (3) and scale hs. Writes the pose (12 floats).
__device__ __forceinline__ void dlt_solve(const float (&sums)[DLT_SUMS], const float* mu,
                                          float hs, float* pose) {
  // Blocks of the normal matrix: S (sums 0-9), Su (10-19), Sv (20-29), Sw (30-39).
  const float trace = 2.f * (sums[pair_index(0, 0)] + sums[pair_index(1, 1)] +
                             sums[pair_index(2, 2)] + sums[pair_index(3, 3)]) +
                      sums[30 + pair_index(0, 0)] + sums[30 + pair_index(1, 1)] +
                      sums[30 + pair_index(2, 2)] + sums[30 + pair_index(3, 3)];
  const float tr = clamp_min(trace, 1e-30f);
  float a[12][12];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      const int rb = i / 4, cb = j / 4, p = pair_index(i % 4, j % 4);
      float v;
      if (rb == cb) v = sums[(rb == 2 ? 30 : 0) + p];  // S, S, Sw
      else if (rb == 1) v = 0.f;                       // the zero block
      else v = -sums[(cb == 0 ? 10 : 20) + p];         // -Su, -Sv
      a[i][j] = v / tr + (i == j ? 1e-9f : 0.f);
    }
  }
  cholesky<12>(a);
  float vec[12];
  float nrm = 0.f;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    vec[i] = cosf(static_cast<float>(i) * 0.7f + 0.3f);
    nrm += vec[i] * vec[i];
  }
  nrm = sqrtf(nrm);
#pragma unroll
  for (int i = 0; i < 12; ++i) vec[i] /= nrm;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    float w[12];
    cho_solve<12>(a, vec, w);
    float ww = 0.f;
#pragma unroll
    for (int i = 0; i < 12; ++i) ww += w[i] * w[i];
    const float den = clamp_min(sqrtf(ww), 1e-30f);
#pragma unroll
    for (int i = 0; i < 12; ++i) vec[i] = w[i] / den;
  }
  // vec = [R | t] row by row, up to scale and sign.
  const float* p = vec;
  const float det = p[0] * (p[5] * p[10] - p[6] * p[9]) - p[1] * (p[4] * p[10] - p[6] * p[8]) +
                    p[2] * (p[4] * p[9] - p[5] * p[8]);
  const float sign = det < 0.f ? -1.f : 1.f;
  const float scale = sign / powf(fabsf(det) + 1e-30f, 1.f / 3.f);
  float rot[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) rot[3 * i + j] = p[4 * i + j] * scale;
  }
  polar_rotation(rot);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float r_mu = rot[3 * i] * mu[0] + rot[3 * i + 1] * mu[1] + rot[3 * i + 2] * mu[2];
    pose[9 + i] = p[4 * i + 3] * scale / hs - r_mu;
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) pose[k] = rot[k];
}

__device__ __forceinline__ bool all_finite(const float* pose) {
  bool ok = true;
#pragma unroll
  for (int k = 0; k < 12; ++k) ok = ok && isfinite(pose[k]);
  return ok;
}

}  // namespace fp
