// Cyclic-buddy cycle distances on Hopper: masked squared-L2 distances
// between a crop's query features and one retrieved template's bank, dual
// argmin by keyed minimum, cycle landing by gather, per-query cycle
// distance.
//
// Replaces: foundpose_tpu/ops/buddies_kernel.py:_buddies_kernel (one Pallas
// grid step per (crop, template) pair, the whole [Q, F] distance matrix in
// VMEM, the cycle composed by one-hot matmuls).
//
// What bounds it on the H100: the cross term is ~0.24 GFLOP per pair (19
// GFLOP for the 80 pairs of a batch of 16 at Q 900, F 512, D 256),
// tensor-core work on bf16 inputs, with the row and column minima as the
// reductions around it. Device-memory traffic is small (~21 MB of bf16
// banks per batch), and the distances [Q, F] never need to leave the chip.
//
// What the design does about it: three launches.
// 1. Squared norms of every query and bank row, one warp a row, into an f32
//    workspace (so no block of launch 2 recomputes a bank's norms).
// 2. One block per (128-query tile, pair): 640 blocks at the shapes above,
//    16 warps in a 4 x 4 grid, each warp a 32-query x 32-bank-row tile of
//    the block's 128 x 128 (256 bytes of shared memory read per mma), 207
//    KB of shared memory at D 256, one block per SM. The block's query tile
//    stays in shared memory; the pair's bank streams through in 128-row
//    tiles by a cp.async double buffer, re-read from L2 by each query tile.
//    The cross term runs on mma.sync m16n8k16 (bf16 in, f32 out). Latency
//    set the pace: with 8 warps per SM (128 x 64 block tiles) a call took
//    0.211 ms on an H100, with 16 warps 0.167 ms, while a 4-stage ring in
//    place of 2 changed nothing (PERF.md). Each distance and both of its
//    int32 keys are formed once, in registers, from the accumulator
//    fragment, in 5 f32 operations (the masks' 1e30 terms are precomputed
//    per row and per column). Row keys are kept in registers across the
//    bank and reduced by shuffles and shared memory at the end, when the
//    row minimum (q2o) is final and is written. Column keys are reduced
//    over a warp's rows by shuffles, across the 4 warps of a column in
//    shared memory, then folded into an int32 [pairs, F] workspace by one
//    global atomicMin per column per block.
// 3. The landing, once every column minimum is final: one thread per
//    (pair, query) reads q2o, the column key of that bank row and the two
//    query points, and writes the cycle distance. The gather returns the
//    TPU kernel's one-hot matmuls' f32 values exactly.
// A keyed minimum does not depend on the order in which keys meet, and the
// norms are summed in the single-block kernel's order, so the outputs are
// bit-identical to that kernel's, ties included.
//
// Contract kept from the TPU kernel:
//  - norms are f32 sums of the squared bf16 inputs; d = max(q2 + b2 - 2 *
//    cross, 0); a masked query or bank row adds 1e30 (both: 2e30);
//  - keys are (bits(d) & ~(2^f_bits - 1)) | f for the row minimum and
//    (bits(d) & ~(2^q_bits - 1)) | q for the column minimum, so ties within
//    a key bucket go to the lowest index;
//  - masked queries get cycle distance 1e30 (INVALID_SENTINEL).
#include <climits>

#include "hopper.cuh"

namespace {

using fp::bf2f;

constexpr int BQ = 128, BF = 128, BWARPS = 16, BTHREADS = 32 * BWARPS;
constexpr int WM = 4;  // warps along the queries (32 each); BWARPS / WM along the bank (32 each)
constexpr int NST = 2;  // bank tiles in shared memory, NST - 1 of them loading ahead
constexpr size_t MAX_SMEM = 232448;  // dynamic shared memory a block may use
constexpr float kBig = 1e30f;

// The contract's d = max(q2 + b2 - 2 cross, 0) + (1 - qm) 1e30 + (1 - bm)
// 1e30, with the mask terms qt, bt precomputed (each 0 or 1e30, exactly).
// fma(-2, cross, s) is s - 2 cross rounded once, as 2 cross is exact.
__device__ __forceinline__ float masked_dist(float cross, float q2, float b2, float qt, float bt) {
  const float d = fmaxf(__fmaf_rn(-2.f, cross, __fadd_rn(q2, b2)), 0.f);
  return __fadd_rn(__fadd_rn(d, qt), bt);
}

// Shared memory of one block; tiles hold D + 8 bf16 a row, so the 8 rows of
// an ldmatrix land in distinct banks. Per query row its norm and mask term,
// per bank row of the tile the same, per (query warp row, column) a key.
struct BuddiesSmem {
  size_t qtile, ftile, q2, qterm, b2, bterm, ck, total;
  __host__ __device__ explicit BuddiesSmem(int D) {
    const size_t ld = D + 8;
    qtile = 0;
    ftile = qtile + fp::align128(sizeof(bf16) * BQ * ld);
    q2 = ftile + fp::align128(sizeof(bf16) * NST * BF * ld);
    qterm = q2 + fp::align128(sizeof(float) * BQ);
    b2 = qterm + fp::align128(sizeof(float) * BQ);
    bterm = b2 + fp::align128(sizeof(float) * BF);
    ck = bterm + fp::align128(sizeof(float) * BF);
    total = ck + fp::align128(sizeof(int) * WM * BF);
  }
};
static_assert((BWARPS / WM) * BQ <= WM * BF, "the row-minimum exchange fits the column keys");

// Rows [r0, r0 + rows) of a [*, D] bf16 matrix into a shared tile by
// cp.async; rows at or past `limit` are zero.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src, int D, int r0,
                                          int rows, int limit) {
  const int chunks = D / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += BTHREADS) {
    const int r = i / chunks, c = (i % chunks) * 8;
    const bool ok = r0 + r < limit;
    fp::cp_async16(dst + r * (D + 8) + c, ok ? src + static_cast<size_t>(r0 + r) * D + c : src, ok);
  }
}

// Squared norms of the rows of two [*, D] bf16 matrices (nq rows of a,
// then nb of b), one warp a row, summed lane-strided and then by a
// butterfly, as the single-block kernel did.
__global__ void norms_kernel(const bf16* __restrict__ a, int nq, const bf16* __restrict__ b,
                             int nb, int D, float* __restrict__ out) {
  const int row = blockIdx.x * BWARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= nq + nb) return;
  const bf16* x = row < nq ? a + static_cast<size_t>(row) * D : b + static_cast<size_t>(row - nq) * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float v = bf2f(x[d]);
    s += v * v;
  }
  s = fp::warp_sum(s);
  if (lane == 0) out[row] = s;
}

__global__ void __launch_bounds__(BTHREADS)
    buddies_kernel(const bf16* __restrict__ qf, const bf16* __restrict__ bankf,
                   const float* __restrict__ qmask, const float* __restrict__ bmask,
                   const float* __restrict__ qnorm, const float* __restrict__ bnorm,
                   int* __restrict__ q2o, int* __restrict__ colkeys, int Q, int F, int D, int TN,
                   int f_bits, int q_bits) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BuddiesSmem L(D);
  bf16* Qt = reinterpret_cast<bf16*>(smem + L.qtile);
  bf16* Ft = reinterpret_cast<bf16*>(smem + L.ftile);
  float* q2 = reinterpret_cast<float*>(smem + L.q2);
  float* qterm = reinterpret_cast<float*>(smem + L.qterm);
  float* b2 = reinterpret_cast<float*>(smem + L.b2);
  float* bterm = reinterpret_cast<float*>(smem + L.bterm);
  int* ck = reinterpret_cast<int*>(smem + L.ck);

  const int ld = D + 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wm = warp % WM, wn = warp / WM;  // rows 32 wm.., columns 32 wn.. of the tile
  const int q0 = blockIdx.x * BQ, pair = blockIdx.y, b = pair / TN;
  const bf16* qfb = qf + static_cast<size_t>(b) * Q * D;
  const bf16* bfb = bankf + static_cast<size_t>(pair) * F * D;
  const int ntiles = (F + BF - 1) / BF;
  const int f_lo = (1 << f_bits) - 1, q_lo = (1 << q_bits) - 1;

  load_rows(Qt, qfb, D, q0, BQ, Q);
  for (int s = 0; s < NST - 1; ++s) {  // the query tile and bank tile 0 in one group
    if (s < ntiles) load_rows(Ft + s * BF * ld, bfb, D, s * BF, BF, F);
    fp::cp_async_commit();
  }
  for (int r = threadIdx.x; r < BQ; r += BTHREADS) {
    const size_t o = static_cast<size_t>(b) * Q + q0 + r;
    const bool ok = q0 + r < Q;
    q2[r] = ok ? qnorm[o] : 0.f;
    qterm[r] = ok ? __fmul_rn(__fsub_rn(1.f, qmask[o]), kBig) : 0.f;
  }

  // This lane's query rows: 32 wm + 16 m + g + 8 hh (local), and their
  // running row keys.
  int rk[2][2] = {{INT_MAX, INT_MAX}, {INT_MAX, INT_MAX}};
  for (int it = 0; it < ntiles; ++it) {
    const int f0 = it * BF;
    const bf16* cur = Ft + (it % NST) * BF * ld;
    // Tile it + NST - 1 into the buffer that tile it - 1 left at the barrier
    // before its column reduction.
    const int ahead = it + NST - 1;
    if (ahead < ntiles) load_rows(Ft + (ahead % NST) * BF * ld, bfb, D, ahead * BF, BF, F);
    fp::cp_async_commit();
    for (int c = threadIdx.x; c < BF; c += BTHREADS) {
      const size_t o = static_cast<size_t>(pair) * F + f0 + c;
      const bool ok = f0 + c < F;
      b2[c] = ok ? bnorm[o] : 0.f;
      bterm[c] = ok ? __fmul_rn(__fsub_rn(1.f, bmask[o]), kBig) : 0.f;
    }
    fp::cp_async_wait<NST - 1>();
    __syncthreads();  // tile it (at it == 0 also the query tile) has landed

    // Cross term of the warp's 32 x 32 tile: 2 row blocks x 4 column blocks.
    float acc[2][4][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[2][4], bb[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
        fp::ldmatrix_x4(a[m], Qt + (32 * wm + 16 * m + lane % 16) * ld + 16 * kk + 8 * (lane / 16));
#pragma unroll
      for (int np = 0; np < 2; ++np)
        fp::ldmatrix_x4(bb[np], cur + (32 * wn + 16 * np + lane % 8 + 8 * (lane / 16)) * ld +
                                    16 * kk + 8 * ((lane / 8) % 2));
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          fp::mma_bf16(acc[m][2 * np], a[m], bb[np][0], bb[np][1]);
          fp::mma_bf16(acc[m][2 * np + 1], a[m], bb[np][2], bb[np][3]);
        }
    }

    // Each distance once: its row key into rk, its column key into the
    // column minimum (4 rows here, then over g by shuffles).
    float rq2[2][2], rqt[2][2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        rq2[m][hh] = q2[32 * wm + 16 * m + g + 8 * hh];
        rqt[m][hh] = qterm[32 * wm + 16 * m + g + 8 * hh];
      }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 32 * wn + 8 * n + 2 * t + c, f = f0 + col;
        const float cb2 = b2[col], cbt = bterm[col];
        int cmin = INT_MAX;
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int q = q0 + 32 * wm + 16 * m + g + 8 * hh;
            if (q < Q && f < F) {
              const int bits = __float_as_int(
                  masked_dist(acc[m][n][2 * hh + c], rq2[m][hh], cb2, rqt[m][hh], cbt));
              rk[m][hh] = min(rk[m][hh], (bits & ~f_lo) | f);
              cmin = min(cmin, (bits & ~q_lo) | q);
            }
          }
        cmin = min(cmin, __shfl_xor_sync(0xffffffffu, cmin, 4));
        cmin = min(cmin, __shfl_xor_sync(0xffffffffu, cmin, 8));
        cmin = min(cmin, __shfl_xor_sync(0xffffffffu, cmin, 16));
        if (g == 0) ck[wm * BF + col] = cmin;
      }
    __syncthreads();  // every warp's column minima are in; tile it is consumed
    if (threadIdx.x < BF) {
      int mn = INT_MAX;
#pragma unroll
      for (int w = 0; w < WM; ++w) mn = min(mn, ck[w * BF + threadIdx.x]);
      const int f = f0 + threadIdx.x;
      if (f < F && mn != INT_MAX) atomicMin(&colkeys[static_cast<size_t>(pair) * F + f], mn);
    }
  }

  // Row minima over the bank: this lane's 8 columns of each tile, the quad's
  // 32, then the other column warp's 32 through shared memory.
  int* rmin = ck;  // [BWARPS / WM][BQ], free after the last column reduction
  __syncthreads();
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      int v = rk[m][hh];
      v = min(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = min(v, __shfl_xor_sync(0xffffffffu, v, 2));
      if (t == 0) rmin[wn * BQ + 32 * wm + 16 * m + g + 8 * hh] = v;
    }
  __syncthreads();
  for (int r = threadIdx.x; r < BQ; r += BTHREADS) {
    int v = rmin[r];
#pragma unroll
    for (int w = 1; w < BWARPS / WM; ++w) v = min(v, rmin[w * BQ + r]);
    if (q0 + r < Q) q2o[static_cast<size_t>(pair) * Q + q0 + r] = v & f_lo;
  }
}

// One thread per (pair, query): the cycle's landing qpts[o2q[q2o[q]]] and
// the distance to it, once every column minimum is final.
__global__ void landing_kernel(const float* __restrict__ qmask, const float* __restrict__ qpts,
                               const int* __restrict__ q2o, const int* __restrict__ colkeys,
                               float* __restrict__ cd, int Q, int F, int TN, int pairs, int q_bits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pairs * Q) return;
  const int pair = i / Q, q = i % Q, b = pair / TN;
  const int f = q2o[i];
  const int oq = colkeys[static_cast<size_t>(pair) * F + f] & ((1 << q_bits) - 1);
  const float dx = __fsub_rn(qpts[2 * q], qpts[2 * oq]);
  const float dy = __fsub_rn(qpts[2 * q + 1], qpts[2 * oq + 1]);
  const float dist = sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
  cd[i] = qmask[static_cast<size_t>(b) * Q + q] > 0.f ? dist : kBig;
}

}  // namespace

// qf [B, Q, D] bf16; bankf [B, TN, F, D] bf16; qmask [B, Q] f32; bmask
// [B, TN, F] f32; qpts [Q, 2] f32 -> cd [B, TN, Q] f32, q2o [B, TN, Q] int32.
// Workspaces: colkeys [B, TN, F] int32, filled with INT_MAX by the caller;
// norms [B * Q + B * TN * F] f32.
FP_EXPORT int fp_cycle_distances(const void* qf, const void* bankf,
                                 const void* qmask, const void* bmask,
                                 const void* qpts, void* cd, void* q2o, void* colkeys,
                                 void* norms, int batch, int tn, int Q, int F, int D,
                                 int f_bits, int q_bits, void* stream_ptr) {
  const BuddiesSmem L(D);
  const int pairs = batch * tn;
  if (D % 16 != 0 || D < 16 || Q < 1 || F < 1 || Q > (1 << q_bits) || F > (1 << f_bits) ||
      pairs < 1 || pairs > 65535 || L.total > MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  // Once per process: shared memory past 48 KB (the launch asks for L.total).
  static const cudaError_t attr = cudaFuncSetAttribute(
      buddies_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(MAX_SMEM));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bf16* q = static_cast<const bf16*>(qf);
  const bf16* bank = static_cast<const bf16*>(bankf);
  float* qnorm = static_cast<float*>(norms);
  float* bnorm = qnorm + static_cast<size_t>(batch) * Q;
  const int rows = batch * Q + pairs * F;
  norms_kernel<<<(rows + BWARPS - 1) / BWARPS, BTHREADS, 0, stream>>>(q, batch * Q, bank,
                                                                       pairs * F, D, qnorm);
  int rc = fp::launch_status();
  if (rc) return rc;
  const dim3 grid((Q + BQ - 1) / BQ, pairs);
  buddies_kernel<<<grid, BTHREADS, L.total, stream>>>(
      q, bank, static_cast<const float*>(qmask), static_cast<const float*>(bmask), qnorm, bnorm,
      static_cast<int*>(q2o), static_cast<int*>(colkeys), Q, F, D, tn, f_bits, q_bits);
  if ((rc = fp::launch_status())) return rc;
  constexpr int kLandThreads = 256;
  landing_kernel<<<(pairs * Q + kLandThreads - 1) / kLandThreads, kLandThreads, 0, stream>>>(
      static_cast<const float*>(qmask), static_cast<const float*>(qpts), static_cast<const int*>(q2o),
      static_cast<const int*>(colkeys), static_cast<float*>(cd), Q, F, tn, pairs, q_bits);
  return fp::launch_status();
}
