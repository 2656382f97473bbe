// Multi-head softmax attention on Hopper, for the unfused ViT block.
//
// Replaces: foundpose_tpu/ops/attention.py:_attention_kernel (one Pallas
// call per (batch * head, query block) with the whole [T_pad, Dh] K and V
// and the [T_pad, BLK_Q] logits resident in VMEM).
//
// What it computes, for q, k, v [BH, T, 64] and each query row:
//   l_j = (q . k_j) * Dh^-0.5 in f32 for keys j < seq_len (the rest masked),
//   p_j = exp(l_j - max_j l_j) (base e), s = sum_j p_j in f32,
//   w_j = p_j / s cast to the input dtype, out = sum_j w_j v_j in f32, cast.
//
// What bounds it on the H100: at the unfused ViT-S path (16 crops x 6
// heads, 905 tokens, Dh 64) one layer is 2 x 96 x 905^2 x 64 x 2 = 20.1
// GFLOP on 89 MB of f32 q, k, v and output. In f32, which the exact
// configuration runs, the tensor cores are off limits (TF32 would round
// the inputs to 10 mantissa bits), so the bound is the 67 TFLOP/s of f32
// FMA: ~0.30 ms. In bf16 the tensor cores bound it at ~20 us.
//
// What the design does about it. Neither kernel keeps logits resident, so
// T is not limited by shared memory, and both stream K and V in 64-key
// tiles through a double-buffered cp.async ring (zero fill past seq_len
// and T), loading the next tile while the current one is multiplied.
//
// f32 (SIMT FMA, 64 queries x 128 threads, 3 blocks per SM): one pass with
// an online softmax. Each thread owns a 4 x 8 register tile of logits (4
// rows, keys tx + 8j so neighbouring threads read neighbouring keys) fed by
// float4 shared loads along Dh, keeps a running row max and sum, rescales
// its 4 x 8 output tile by exp(m_old - m_new), and divides by the sum once
// at the end. The weights go through shared memory transposed, so the
// value product reads one float4 of weights and two of V per 32 FMAs.
// Dividing after the value product keeps the contract in f32: there the
// cast of p / s to the input dtype is the identity, so (sum_j p_j v_j) / s
// and sum_j (p_j / s) v_j differ in rounding order only, like a different
// summation order (the twin's relative L2 bound, 1e-5, holds).
//
// bf16 (mma.sync m16n8k16, 64 queries x 4 warps, 37 KB of shared memory, 6
// blocks per SM):
// the contract casts the weights p / s to bf16 BEFORE the value product,
// which an online rescale would not reproduce, so the kernel makes two
// passes over K. Pass 1: S = Q K^T on the tensor cores, a running row max
// and sum. Pass 2, 16 keys at a time: S again, w = bf16(exp(s - m) * (1 /
// s)) in registers (within one f32 ulp of p / s before the cast), and O +=
// w V, with the accumulator fragments of S repacked as the A fragments of
// the value product, so the weights never touch shared memory. 1.5x the
// products of one pass. The kernel is bound by issuing instructions and by
// latency, not by the tensor cores, so the softmax is kept to one FFMA and
// one SFU ex2 per logit (the scale is folded with log2 e into the FFMA),
// and registers and shared memory are kept low enough for 6 blocks per SM
// (the passes are separate loops, so O and a whole tile of S are never
// live together; the query tile is staged in a V buffer pass 1 leaves
// free).
//
// Both kernels take exp from the SFU's ex2 (relative error about 2^-22);
// in f32 the argument is (s - m) * log2 e, the twin's exact difference
// rounded once more.
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int DH = 64;    // head dim
constexpr int BQ = 64;    // query rows per block
constexpr int BKV = 64;   // keys per tile
constexpr int F_THREADS = 128, LDF = DH + 4;  // f32: floats per shared row
constexpr int B_THREADS = 128, LDH = DH + 8;  // bf16: elements per shared row (144 bytes)
constexpr int B_BLOCKS = 6;                    // bf16: blocks per SM (37 KB of shared memory each)
constexpr size_t F32_SMEM = 4 * BQ * LDF * sizeof(float);
constexpr float LOG2E = 1.4426950408889634f;

using fp::ex2;
using fp::ldmatrix_x4;
using fp::ldmatrix_x4_trans;
using fp::mma_bf16;
using fp::pack_bf16;

// Rows [r0, r0 + 64) of a [*, 64] matrix into shared memory (leading
// dimension ld elements) by cp.async; rows at or past `limit` are zero.
template <typename T, int LD, int THREADS>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int r0, int limit) {
  constexpr int VEC = 16 / sizeof(T), CHUNKS = DH / VEC;
  for (int i = threadIdx.x; i < BKV * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * VEC;
    const bool ok = r0 + r < limit;
    fp::cp_async16(dst + r * LD + c, ok ? src + static_cast<size_t>(r0 + r) * DH + c : src, ok);
  }
}

// ---------------------------------------------------------------------------
// f32: SIMT FMA, one pass, online softmax. Thread (ty, tx) = (tid / 8, tid %
// 8) owns rows ty + 16a (a < 4), keys tx + 8j (j < 8) of each logit tile and
// dims 4tx .. 4tx + 3, 32 + 4tx .. 32 + 4tx + 3 of the output rows.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(F_THREADS, 3)
    attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out, int T,
                         int seq_len, float scale) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][LDF]
  float* Pt = Qs + BQ * LDF;                    // weights, [key][4 ty + a]
  float* Ks = Pt + BKV * LDF;                   // [BKV][LDF]
  float* Vs = Ks + BKV * LDF;                   // [BKV][LDF]
  const size_t base = static_cast<size_t>(blockIdx.y) * T * DH;
  const int q0 = blockIdx.x * BQ;
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  const int ntiles = (seq_len + BKV - 1) / BKV;

  load_tile<float, LDF, F_THREADS>(Qs, q + base, q0, T);
  load_tile<float, LDF, F_THREADS>(Ks, k + base, 0, seq_len);
  fp::cp_async_commit();

  float o[4][8], m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) o[a][e] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BKV;
    load_tile<float, LDF, F_THREADS>(Vs, v + base, k0, seq_len);
    fp::cp_async_commit();
    fp::cp_async_wait<1>();  // Q and this K tile
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[a][j] = 0.f;
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      float4 qa[4], kb[8];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * a) * LDF + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) kb[j] = *reinterpret_cast<const float4*>(Ks + (tx + 8 * j) * LDF + d);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float t = s[a][j];
          t = fmaf(qa[a].x, kb[j].x, t);
          t = fmaf(qa[a].y, kb[j].y, t);
          t = fmaf(qa[a].z, kb[j].z, t);
          s[a][j] = fmaf(qa[a].w, kb[j].w, t);
        }
    }

    // Online softmax; a row's 64 keys live in the 8 lanes of one ty.
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[a][j] = k0 + tx + 8 * j < seq_len ? s[a][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[a][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);  // finite: every tile holds a key < seq_len
      const float alpha = ex2((m[a] - m_new) * LOG2E);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[a][j] = ex2((s[a][j] - m_new) * LOG2E);
        sum += s[a][j];
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[a] = l[a] * alpha + sum;
      m[a] = m_new;
#pragma unroll
      for (int e = 0; e < 8; ++e) o[a][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(Pt + (tx + 8 * j) * LDF + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();  // K tile consumed, weights complete

    if (it + 1 < ntiles) load_tile<float, LDF, F_THREADS>(Ks, k + base, k0 + BKV, seq_len);
    fp::cp_async_commit();
    fp::cp_async_wait<1>();  // this V tile
    __syncthreads();

#pragma unroll 8
    for (int j = 0; j < BKV; ++j) {
      const float4 w = *reinterpret_cast<const float4*>(Pt + j * LDF + 4 * ty);
      const float4 va = *reinterpret_cast<const float4*>(Vs + j * LDF + 4 * tx);
      const float4 vb = *reinterpret_cast<const float4*>(Vs + j * LDF + 32 + 4 * tx);
      const float wa[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        o[a][0] = fmaf(wa[a], va.x, o[a][0]);
        o[a][1] = fmaf(wa[a], va.y, o[a][1]);
        o[a][2] = fmaf(wa[a], va.z, o[a][2]);
        o[a][3] = fmaf(wa[a], va.w, o[a][3]);
        o[a][4] = fmaf(wa[a], vb.x, o[a][4]);
        o[a][5] = fmaf(wa[a], vb.y, o[a][5]);
        o[a][6] = fmaf(wa[a], vb.z, o[a][6]);
        o[a][7] = fmaf(wa[a], vb.w, o[a][7]);
      }
    }
    __syncthreads();  // weights and V tile consumed
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= T) continue;
    float* dst = out + base + static_cast<size_t>(row) * DH;
    *reinterpret_cast<float4*>(dst + 4 * tx) =
        make_float4(o[a][0] / l[a], o[a][1] / l[a], o[a][2] / l[a], o[a][3] / l[a]);
    *reinterpret_cast<float4*>(dst + 32 + 4 * tx) =
        make_float4(o[a][4] / l[a], o[a][5] / l[a], o[a][6] / l[a], o[a][7] / l[a]);
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16 (f32 accumulation), two passes over K. Warp w owns
// query rows 16w .. 16w + 15; lane (g, t) = (lane / 4, lane % 4) holds rows
// g and g + 8 of every accumulator fragment, columns 2t and 2t + 1.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(B_THREADS, B_BLOCKS)
    attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ out, int T,
                          int seq_len, float scale) {
  // Two stages of K and V tiles. Pass 1 loads no V, so the query tile is
  // staged in Vs[0], which pass 2 first fills at its second step.
  __shared__ __align__(128) bf16 Ks[2][BKV * LDH];
  __shared__ __align__(128) bf16 Vs[2][BKV * LDH];
  const size_t base = static_cast<size_t>(blockIdx.y) * T * DH;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int ntiles = (seq_len + BKV - 1) / BKV;
  const int steps = 2 * ntiles;  // pass 1: K tiles; pass 2: K and V tiles

  // Step u loads K tile (u mod ntiles), and in pass 2 its V tile, into buffer u % 2.
  auto issue = [&](int u) {
    if (u < steps) {
      const int tile = u < ntiles ? u : u - ntiles;
      load_tile<bf16, LDH, B_THREADS>(Ks[u % 2], k + base, tile * BKV, seq_len);
      if (u >= ntiles) load_tile<bf16, LDH, B_THREADS>(Vs[u % 2], v + base, tile * BKV, seq_len);
    }
    fp::cp_async_commit();
  };
  load_tile<bf16, LDH, B_THREADS>(Vs[0], q + base, q0, T);
  issue(0);
  issue(1);

  // Rows g and g + 8: running max m of the logits in log2 units (the
  // unscaled product times c = scale * log2 e), sum l of 2^(x - m).
  const float c = scale * LOG2E;
  uint32_t qf[DH / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // Pass 1: max and (per-thread partial) sum, tile by tile.
  for (int u = 0; u < ntiles; ++u) {
    fp::cp_async_wait<1>();
    __syncthreads();
    if (u == 0) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        ldmatrix_x4(qf[kk], Vs[0] + (16 * warp + lane % 16) * LDH + 16 * kk + 8 * (lane / 16));
    }
    float s[8][4];
#pragma unroll
    for (int np = 0; np < 4; ++np) fp::logits_pair<DH / 16, LDH>(s + 2 * np, qf, Ks[u % 2], np, lane);
    fp::mask_keys<8>(s, u * BKV, t, seq_len);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx * c);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        sum += ex2(fmaf(s[n][2 * h], c, -m_new)) + ex2(fmaf(s[n][2 * h + 1], c, -m_new));
      l[h] = l[h] * ex2(m[h] - m_new) + sum;
      m[h] = m_new;
    }
    __syncthreads();  // buffer u % 2 consumed
    issue(u + 2);
  }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.f / l[h];
  }

  // Pass 2, 16 keys at a time: S again, w = bf16(p / s) straight into the A
  // fragments, O += w V.
  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  for (int u = ntiles; u < steps; ++u) {
    fp::cp_async_wait<1>();
    __syncthreads();
    const bf16* Kb = Ks[u % 2];
    const bf16* Vb = Vs[u % 2];
    const int k0 = (u - ntiles) * BKV;
#pragma unroll
    for (int j = 0; j < BKV / 16; ++j) {  // keys 16j .. 16j + 15
      float s[2][4];
      fp::logits_pair<DH / 16, LDH>(s, qf, Kb, j, lane);
      fp::mask_keys<2>(s, k0 + 16 * j, t, seq_len);
      uint32_t a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // A fragment i: key block i / 2, row g + 8 (i % 2)
        const float* sv = s[i / 2] + 2 * (i % 2);
        const int h = i % 2;
        a[i] = pack_bf16(ex2(fmaf(sv[0], c, -m[h])) * inv[h], ex2(fmaf(sv[1], c, -m[h])) * inv[h]);
      }
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {  // dims 16dp .. 16dp + 15
        uint32_t b[4];
        ldmatrix_x4_trans(b, Vb + (16 * j + lane % 8 + 8 * ((lane / 8) % 2)) * LDH + 16 * dp + 8 * (lane / 16));
        mma_bf16(o[2 * dp], a, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // buffer u % 2 consumed
    issue(u + 2);
  }
  fp::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + g + 8 * h;
    if (row >= T) continue;
    bf16* dst = out + base + static_cast<size_t>(row) * DH;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n + 2 * t) = pack_bf16(o[n][2 * h], o[n][2 * h + 1]);
  }
}

}  // namespace

// q, k, v, out [bh, T, head_dim] contiguous, f32 (is_bf16 = 0) or bf16. Any
// T: nothing of length T stays resident.
FP_EXPORT int fp_attention(const void* q, const void* k, const void* v, void* out, int bh,
                           int T, int seq_len, int head_dim, int is_bf16, float scale,
                           void* stream_ptr) {
  if (bh < 1 || bh > 65535 || T < 1 || seq_len < 1 || seq_len > T || head_dim != DH)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + BQ - 1) / BQ, bh);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (is_bf16) {
    attention_bf16_kernel<<<grid, B_THREADS, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(out), T, seq_len, scale);
  } else {
    cudaFuncSetAttribute(attention_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(F32_SMEM));
    attention_f32_kernel<<<grid, F_THREADS, F32_SMEM, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(out), T, seq_len, scale);
  }
  return fp::launch_status();
}
