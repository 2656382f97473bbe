// Cyclic-buddy cycle distances on Hopper: masked squared-L2 distances
// between a crop's query features and one retrieved template's bank, dual
// argmin by keyed minimum, cycle landing by gather, per-query cycle
// distance.
//
// Replaces: foundpose_tpu/ops/buddies_kernel.py:_buddies_kernel (one Pallas
// grid step per (crop, template) pair, the whole [Q, F] distance matrix in
// VMEM, the cycle composed by one-hot matmuls).
//
// What bounds it on the H100: the [Q, F] = [900, 512] f32 distance tile
// (1.8 MB) does not fit in shared memory, and the cross term is ~0.24 GFLOP
// per pair (19 GFLOP for the 80 pairs of a batch of 16): tensor-core work
// on bf16 inputs, with the row and column minima as the reductions around
// it. Device-memory traffic is small (~21 MB of bf16 banks per batch).
//
// What the design does about it: one block per pair walks the [Q, F] matrix
// in 64x64 tiles. Each tile's cross term is a bf16 tensor-core product with
// f32 accumulation (nvcuda::wmma); the tile never leaves shared memory. Row
// and column minima are kept as int32 keys in shared memory and updated
// with shared-memory atomicMin, so nothing is written to device memory until
// the per-query results. The cycle landing qpts[o2q[q2o[q]]] is a gather:
// gathers are cheap on this card, so the TPU kernel's one-hot matmuls are
// not needed; the gather returns the same f32 values exactly.
//
// Contract kept from the TPU kernel:
//  - norms are f32 sums of the squared bf16 inputs; d = max(q2 + b2 - 2 *
//    cross, 0); a masked query or bank row adds 1e30 (both: 2e30);
//  - keys are (bits(d) & ~(2^f_bits - 1)) | f for the row minimum and
//    (bits(d) & ~(2^q_bits - 1)) | q for the column minimum, so ties within
//    a key bucket go to the lowest index;
//  - masked queries get cycle distance 1e30 (INVALID_SENTINEL).
#include <climits>

#include "common.cuh"

namespace {

using namespace nvcuda;
using fp::bf2f;

constexpr int BQ = 64, BF = 64, SLD = BF + 4, BTHREADS = 128;
constexpr float kBig = 1e30f;

__device__ __forceinline__ float masked_dist(float cross, float q2, float b2,
                                             float qm, float bm) {
  float d = __fsub_rn(__fadd_rn(q2, b2), __fmul_rn(2.f, cross));
  d = fmaxf(d, 0.f);
  d = __fadd_rn(d, __fmul_rn(__fsub_rn(1.f, qm), kBig));
  return __fadd_rn(d, __fmul_rn(__fsub_rn(1.f, bm), kBig));
}

struct BuddiesSmem {
  size_t qt, ft, s, q2, b2, qm, bm, rmin, cmin, total;
  __host__ __device__ BuddiesSmem(int Q, int F, int D) {
    const int ld = D + 8;
    qt = 0;
    ft = qt + fp::align128(sizeof(bf16) * BQ * ld);
    s = ft + fp::align128(sizeof(bf16) * BF * ld);
    q2 = s + fp::align128(sizeof(float) * (BTHREADS / 32) * 16 * SLD);
    b2 = q2 + fp::align128(sizeof(float) * Q);
    qm = b2 + fp::align128(sizeof(float) * F);
    bm = qm + fp::align128(sizeof(float) * Q);
    rmin = bm + fp::align128(sizeof(float) * F);
    cmin = rmin + fp::align128(sizeof(int) * Q);
    total = cmin + fp::align128(sizeof(int) * F);
  }
};

__global__ void __launch_bounds__(BTHREADS)
    buddies_kernel(const bf16* __restrict__ qf, const bf16* __restrict__ bankf,
                   const float* __restrict__ qmask, const float* __restrict__ bmask,
                   const float* __restrict__ qpts, float* __restrict__ cd,
                   int* __restrict__ q2o, int Q, int F, int D, int TN,
                   int f_bits, int q_bits) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BuddiesSmem L(Q, F, D);
  bf16* Qt = reinterpret_cast<bf16*>(smem + L.qt);
  bf16* Ft = reinterpret_cast<bf16*>(smem + L.ft);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  float* q2 = reinterpret_cast<float*>(smem + L.q2);
  float* b2 = reinterpret_cast<float*>(smem + L.b2);
  float* qm = reinterpret_cast<float*>(smem + L.qm);
  float* bm = reinterpret_cast<float*>(smem + L.bm);
  int* rmin = reinterpret_cast<int*>(smem + L.rmin);
  int* cmin = reinterpret_cast<int*>(smem + L.cmin);

  const int ld = D + 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, pair = b * TN + blockIdx.x;
  const bf16* qfb = qf + static_cast<size_t>(b) * Q * D;
  const bf16* bfb = bankf + static_cast<size_t>(pair) * F * D;

  for (int row = warp; row < Q; row += BTHREADS / 32) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float v = bf2f(qfb[static_cast<size_t>(row) * D + d]);
      s += v * v;
    }
    s = fp::warp_sum(s);
    if (lane == 0) {
      q2[row] = s;
      qm[row] = qmask[static_cast<size_t>(b) * Q + row];
      rmin[row] = INT_MAX;
    }
  }
  for (int row = warp; row < F; row += BTHREADS / 32) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float v = bf2f(bfb[static_cast<size_t>(row) * D + d]);
      s += v * v;
    }
    s = fp::warp_sum(s);
    if (lane == 0) {
      b2[row] = s;
      bm[row] = bmask[static_cast<size_t>(pair) * F + row];
      cmin[row] = INT_MAX;
    }
  }

  const int f_lo = (1 << f_bits) - 1, q_lo = (1 << q_bits) - 1;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  float* S = Ss + warp * 16 * SLD;
  const int chunks = D / 8;

  for (int q0 = 0; q0 < Q; q0 += BQ) {
    __syncthreads();  // previous Qt fully consumed (and the init above done)
    for (int c = tid; c < BQ * chunks; c += BTHREADS) {
      const int r = c / chunks, col = (c % chunks) * 8;
      uint4 v = zero;
      if (q0 + r < Q)
        v = *reinterpret_cast<const uint4*>(qfb + static_cast<size_t>(q0 + r) * D + col);
      *reinterpret_cast<uint4*>(Qt + r * ld + col) = v;
    }
    for (int f0 = 0; f0 < F; f0 += BF) {
      for (int c = tid; c < BF * chunks; c += BTHREADS) {
        const int r = c / chunks, col = (c % chunks) * 8;
        uint4 v = zero;
        if (f0 + r < F)
          v = *reinterpret_cast<const uint4*>(bfb + static_cast<size_t>(f0 + r) * D + col);
        *reinterpret_cast<uint4*>(Ft + r * ld + col) = v;
      }
      __syncthreads();

      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BF / 16];
#pragma unroll
      for (int j = 0; j < BF / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
      for (int k = 0; k < D; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Qt + warp * 16 * ld + k, ld);
#pragma unroll
        for (int j = 0; j < BF / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bb;
          wmma::load_matrix_sync(bb, Ft + j * 16 * ld + k, ld);
          wmma::mma_sync(acc[j], a, bb, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BF / 16; ++j)
        wmma::store_matrix_sync(S + j * 16, acc[j], SLD, wmma::mem_row_major);
      __syncwarp();

      // Row minima: lane owns half a row (32 columns) of the warp's 16 rows.
      {
        const int r = lane >> 1, c0 = (lane & 1) * 32, q = q0 + warp * 16 + r;
        int kmin = INT_MAX;
        if (q < Q) {
          for (int c = c0; c < c0 + 32; ++c) {
            const int f = f0 + c;
            if (f >= F) break;
            const float d = masked_dist(S[r * SLD + c], q2[q], b2[f], qm[q], bm[f]);
            kmin = min(kmin, (__float_as_int(d) & ~f_lo) | f);
          }
        }
        kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, 1));
        if ((lane & 1) == 0 && q < Q) atomicMin(&rmin[q], kmin);
      }
      // Column minima: lane owns columns lane and lane + 32 of the tile.
      for (int c = lane; c < BF; c += 32) {
        const int f = f0 + c;
        if (f >= F) break;
        int kmin = INT_MAX;
        for (int r = 0; r < 16; ++r) {
          const int q = q0 + warp * 16 + r;
          if (q >= Q) break;
          const float d = masked_dist(S[r * SLD + c], q2[q], b2[f], qm[q], bm[f]);
          kmin = min(kmin, (__float_as_int(d) & ~q_lo) | q);
        }
        if (kmin != INT_MAX) atomicMin(&cmin[f], kmin);
      }
      __syncthreads();  // Ft and S are reused by the next tile
    }
  }
  __syncthreads();

  for (int q = tid; q < Q; q += BTHREADS) {
    const int f = rmin[q] & f_lo;
    const int oq = cmin[f] & q_lo;
    const float dx = __fsub_rn(qpts[2 * q], qpts[2 * oq]);
    const float dy = __fsub_rn(qpts[2 * q + 1], qpts[2 * oq + 1]);
    const float dist = sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
    const size_t o = static_cast<size_t>(pair) * Q + q;
    cd[o] = qm[q] > 0.f ? dist : kBig;
    q2o[o] = f;
  }
}

}  // namespace

// qf [B, Q, D] bf16; bankf [B, TN, F, D] bf16; qmask [B, Q] f32; bmask
// [B, TN, F] f32; qpts [Q, 2] f32 -> cd [B, TN, Q] f32, q2o [B, TN, Q] int32.
FP_EXPORT int fp_cycle_distances(const void* qf, const void* bankf,
                                 const void* qmask, const void* bmask,
                                 const void* qpts, void* cd, void* q2o,
                                 int batch, int tn, int Q, int F, int D,
                                 int f_bits, int q_bits, void* stream_ptr) {
  if (D % 16 != 0 || Q < 1 || F < 1 || Q > (1 << q_bits) || F > (1 << f_bits))
    return static_cast<int>(cudaErrorInvalidValue);
  const BuddiesSmem L(Q, F, D);
  cudaFuncSetAttribute(buddies_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(L.total));
  const dim3 grid(tn, batch);
  buddies_kernel<<<grid, BTHREADS, L.total, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const bf16*>(qf), static_cast<const bf16*>(bankf),
      static_cast<const float*>(qmask), static_cast<const float*>(bmask),
      static_cast<const float*>(qpts), static_cast<float*>(cd),
      static_cast<int*>(q2o), Q, F, D, tn, f_bits, q_bits);
  return fp::launch_status();
}
