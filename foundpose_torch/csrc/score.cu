// RANSAC hypothesis scoring on Hopper: the masked inlier count of every
// pose hypothesis of every correspondence set, from the raw operands.
//
// Replaces: foundpose_tpu/pose/pnp.py:_score_kernel (:35) and the folding
// of its wrapper score_hypotheses_fused (:63): one Pallas call per
// correspondence set, the [N, H] projections kept in VMEM.
//
// What bounds it on the H100: a batch of 16 crops x 5 templates at
// lmo.json is 80 sets x 300 points x 200 hypotheses = 4.8 M point tests on
// ~0.8 MB of inputs. The operations bound (30 f32 operations a test at the
// data sheet's 67 TFLOP/s, which counts an FMA as two) is 0.00215 ms. The
// test must stay uncontracted (below), so each operation is an instruction
// of its own: about 25 a test is an issue floor of ~3.6 us (4.8 M x 25
// over 132 SMs x 128 lanes at 1.98 GHz); the compiled loop issues ~32 (29
// f32, two broadcast shared loads, the loop). Nothing else is scarce: the
// launch, the staging and the fold take ~1.5 us of the whole.
//
// What the design does about it: one launch covers the whole batch, with a
// block per (set, tile of 32 hypotheses): 560 blocks at H = 200 and 1040 at
// H = 400, so every SM has work. Lane l of each of the 8 warps scores
// hypothesis tile * 32 + l; warp w takes every 8th staged point, so no
// thread walks more than ~N / 8 points, and the warps' partial counts fold
// through shared memory. A thread issues all of its global loads (its
// point of the first chunk, its hypothesis's raw coefficients) before it
// uses any, folds the 12 coefficients itself and keeps them in registers,
// and loads its point of the next chunk while the block tests the current
// one. Only valid points are staged in shared memory, as (x, y, z, valid)
// and the folded pixel offsets; all lanes of a warp read the same point,
// so every shared load is a broadcast. No [S, N, H] intermediate and no
// folded operand exists in device memory.
//
// The test is the TPU kernel's division-free form: with focal / threshold
// folded into A and 1 / threshold into duv, e = cam_xy + duv * cam_z and a
// point is an inlier iff |e|^2 < cam_z^2 and cam_z > 0. The folding and
// every product and sum are rounded in the order the plain PyTorch twin
// evaluates them (pose/pnp.py:_score_inputs, score_hypotheses_plain), with
// IEEE division and no contraction into FMA, so the two agree bit for bit.
// The mask must be 0/1: skipping its zeros is then exact, every partial
// count is an exact small integer in f32, and neither the order in which
// points are staged nor the order of the fold matters.
#include "common.cuh"

namespace {

constexpr int STHREADS = 256;
constexpr int STILE = 32;                   // hypotheses per block, one per lane
constexpr int SGROUPS = STHREADS / STILE;   // warps, each taking every 8th point
constexpr int SCHUNK = STHREADS;            // points staged at a time, one per thread

struct Strides4 {
  long long s0, s1, s2, s3;
};

// ((x a0 + y a1) + z a2) + a3, rounded term by term (the twin's w = 1
// multiplies a3 by one, which is exact).
__device__ __forceinline__ float dot_h(float x, float y, float z, const float* a) {
  float s = __fadd_rn(__fmul_rn(x, a[0]), __fmul_rn(y, a[1]));
  s = __fadd_rn(s, __fmul_rn(z, a[2]));
  return __fadd_rn(s, a[3]);
}

__global__ void __launch_bounds__(STHREADS)
    score_kernel(const float* __restrict__ pts2d, const float* __restrict__ pts3d,
                 const float* __restrict__ validf, const float* __restrict__ rs,
                 const float* __restrict__ ts, const float* __restrict__ k_f,
                 const float* __restrict__ k_c, float thr, float* __restrict__ counts,
                 int N, int H, Strides4 rst, Strides4 tst) {
  __shared__ float4 P[SCHUNK];  // x, y, z, valid
  __shared__ float2 U[SCHUNK];  // (c - uv) / thr
  __shared__ float part[SGROUPS][STILE];
  __shared__ int kept;
  const int s = blockIdx.y;
  const int lane = threadIdx.x % STILE, group = threadIdx.x / STILE;
  const int h = blockIdx.x * STILE + lane;
  const bool active = h < H;
  const float* p2 = pts2d + static_cast<size_t>(s) * N * 2;
  const float* p3 = pts3d + static_cast<size_t>(s) * N * 3;
  const float* vm = validf + static_cast<size_t>(s) * N;

  // Every global load of the block is issued before any is used: the first
  // chunk's point of this thread, then the hypothesis's raw coefficients.
  float px = 0.f, py = 0.f, pz = 0.f, pv = 0.f, qx = 0.f, qy = 0.f;
  auto load_point = [&](int n) {
    if (n < N) {
      px = p3[3 * n], py = p3[3 * n + 1], pz = p3[3 * n + 2];
      pv = vm[n], qx = p2[2 * n], qy = p2[2 * n + 1];
    }
  };
  load_point(threadIdx.x);
  float a[12];
  if (active) {
    const float* r = rs + s * rst.s0 + h * rst.s1;
    const float* t = ts + s * tst.s0 + h * tst.s1;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) a[4 * i + j] = r[i * rst.s2 + j * rst.s3];
      a[4 * i + 3] = t[i * tst.s2];
    }
  }
  const float cx = k_c[2 * s], cy = k_c[2 * s + 1];
  const float fx = __fdiv_rn(k_f[2 * s], thr), fy = __fdiv_rn(k_f[2 * s + 1], thr);
  // The x and y rows with focal / threshold folded in, as the twin:
  // R_ij * (f_i / thr), t_i * (f_i / thr); the z row as it is.
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j] = __fmul_rn(a[j], fx);
    a[4 + j] = __fmul_rn(a[4 + j], fy);
  }
  if (threadIdx.x == 0) kept = 0;
  __syncthreads();

  float cnt = 0.f;
  int done = 0;  // points of earlier chunks kept
  for (int base = 0; base < N; base += SCHUNK) {
    // Only valid points are staged: a 0 in the mask adds nothing.
    if (base + threadIdx.x < N && pv != 0.f) {
      const int k = atomicAdd(&kept, 1) - done;
      P[k] = make_float4(px, py, pz, pv);
      U[k] = make_float2(__fdiv_rn(__fsub_rn(cx, qx), thr), __fdiv_rn(__fsub_rn(cy, qy), thr));
    }
    __syncthreads();
    const int len = kept - done;
    load_point(base + SCHUNK + threadIdx.x);  // the next chunk, in flight below
    if (active) {
#pragma unroll 4
      for (int i = group; i < len; i += SGROUPS) {
        const float4 p = P[i];
        const float2 u = U[i];
        const float camx = dot_h(p.x, p.y, p.z, a);
        const float camy = dot_h(p.x, p.y, p.z, a + 4);
        const float camz = dot_h(p.x, p.y, p.z, a + 8);
        const float ex = __fadd_rn(camx, __fmul_rn(u.x, camz));
        const float ey = __fadd_rn(camy, __fmul_rn(u.y, camz));
        const bool inl = __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)) <
                             __fmul_rn(camz, camz) &&
                         camz > 0.f;
        if (inl) cnt = __fadd_rn(cnt, p.w);
      }
    }
    done += len;
    __syncthreads();
  }

  part[group][lane] = cnt;
  __syncthreads();
  if (group == 0 && active) {
    float total = part[0][lane];
#pragma unroll
    for (int g = 1; g < SGROUPS; ++g) total = __fadd_rn(total, part[g][lane]);
    counts[static_cast<size_t>(s) * H + h] = total;
  }
}

}  // namespace

// pts2d [S, N, 2], pts3d [S, N, 3], validf [S, N] (0/1), k_f [S, 2],
// k_c [S, 2] contiguous f32; rs [S, H, 3, 3] and ts [S, H, 3] f32 with the
// given element strides; thr the pixel threshold -> counts [S, H] f32.
FP_EXPORT int fp_score_hypotheses(const void* pts2d, const void* pts3d, const void* validf,
                                  const void* rs, const void* ts, const void* k_f,
                                  const void* k_c, float thr, void* counts, int sets,
                                  int N, int H, long long rs0, long long rs1, long long rs2,
                                  long long rs3, long long ts0, long long ts1, long long ts2,
                                  void* stream_ptr) {
  if (sets < 1 || sets > 65535 || N < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((H + STILE - 1) / STILE, sets);
  score_kernel<<<grid, STHREADS, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const float*>(pts2d), static_cast<const float*>(pts3d),
      static_cast<const float*>(validf), static_cast<const float*>(rs),
      static_cast<const float*>(ts), static_cast<const float*>(k_f),
      static_cast<const float*>(k_c), thr, static_cast<float*>(counts), N, H,
      Strides4{rs0, rs1, rs2, rs3}, Strides4{ts0, ts1, ts2, 0});
  return fp::launch_status();
}
