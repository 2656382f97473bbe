// One pre-norm DINOv2 transformer block on Hopper, as seven hand-written
// kernels launched in sequence by fp_vit_block:
//
//   LN1 -> GEMM(qkv, bias, q scaled) -> attention -> GEMM(proj, bias,
//   layer-scaled residual) -> LN2 -> GEMM(fc1, bias, GELU) -> GEMM(fc2, bias,
//   layer-scaled residual)
//
// Replaces: foundpose_tpu/ops/vit_block.py:_block_kernel (the Pallas kernel
// that runs the whole block for one image per grid step, with the image's
// activations and the layer's weights resident in VMEM).
//
// What bounds it on the H100: at ViT-S/14 with 905 tokens and batch 16 one
// layer is 71.4 GFLOP (the four GEMMs 51.2, attention 20.1) against ~3.5 MB
// of bf16 weights and ~11 MB of bf16 activations per pass: far above the
// card's ~295 FLOP/byte ridge, so the block is tensor-core bound (72 us at
// 989 TFLOP/s).
//
// What the design does about it. The TPU kernel's one-grid-step-per-image
// form would give 16 blocks for 132 SMs, so the work is cut by output tile.
// - GEMMs (C[M, N] = A[M, K] . W[N, K]^T, M = batch * tokens): TMA + wgmma.
//   A and W (nn.Linear layout, already K-major) arrive by TMA in 64-deep
//   128-byte-swizzled slices through a 3-stage mbarrier ring fed by one
//   producer warp; two consumer warpgroups run wgmma m64n128k16 on 64 rows
//   each of a 128 x 128 tile. TMA zero-fills rows past M (ragged M) and k
//   past K. One tile per block, 97 KB of shared memory, 2 blocks per SM:
//   one block's epilogue overlaps the other's loads and products. Tiles
//   stay 128 x 128 for every shape: at M = 14,480 and N = 384 (proj, fc2)
//   the 342 tiles leave 132 SMs at most 3 each (86% of a balanced load),
//   and 128 x 192 or 128 x 96 tiles give the same worst SM (2 x 192 or 4 x
//   96 columns of 128 rows), so one wgmma shape serves all four GEMMs. The
//   epilogue applies bias, the q scale, GELU (tanh form through the SFU's
//   exp2 and reciprocal: fc1 0.061 -> 0.053 ms against tanhf) or ls * y in
//   registers at the rounding points below, stages the bf16 tile in the (then free) ring,
//   and stores it by coalesced 16-byte stores (adding the residual, read
//   the same way).
// - Attention: one block per (128-query tile, head, image), 8 warps of 16
//   queries (128-query tiles halve the K/V re-reads from L2 of 64-query
//   ones; the time moved by ~4%), mma.sync m16n8k16 with the logits S and
//   the weights P in registers: each 16 x 16 accumulator of S is rounded
//   to bf16 P in registers and fed back as the A fragment of the value
//   product, so no logit tile touches shared memory. K and V stream in 64-key tiles
//   through a cp.async double buffer straight from the [B, T, 3D] qkv
//   buffer; q's fragments load once from it. "capped" is one pass over the
//   keys (no max, no rescaling); "column" a first pass for the row max and
//   a second for the weights. exp2 comes from the SFU (ex2.approx).
// - LayerNorm: one warp per token row, 8-byte loads, the row in registers.
//   LN is 5% of the block (2% of the first form's; split in PERF.md), so
//   it is not folded into the GEMMs.
//
// Rounding points follow the TPU kernel (ops/vit_block.py):
//  - log2(e)/sqrt(hd) is folded into q before q is cast to bf16;
//  - "capped" softmax: p = min(exp2(l), 1e30) with no max; "column": the
//    per-query max over all keys is subtracted (a first pass over the keys
//    finds it, so p is the same value the TPU kernel forms);
//  - the normalizer is the f32 sum of the bf16-rounded p, floored at 1e-30,
//    applied as a multiply by its reciprocal;
//  - proj and fc2 outputs are cast to bf16 before x + ls * y, which is
//    evaluated in bf16 (ls * y rounded, then the sum rounded).
// Tokens are not padded: rows at or past `tokens` are never touched, and
// keys at or past `seq_len` are masked out of the softmax.
#include "hopper.cuh"

namespace {

using fp::bf2f;
using fp::f2bf;

// ---------------------------------------------------------------------------
// LayerNorm: one warp per token row; statistics in f32, output bf16.
// ---------------------------------------------------------------------------
constexpr int LN_THREADS = 256, LN_MAX_CHUNKS = 12;  // 4 values a chunk: d <= 1536

// NC = ceil(d / 128) chunks of 4 values a lane: the row stays in 4 * NC
// registers (a kernel sized for the widest row held 66 registers at d =
// 384 and ran slower than the scalar loop it replaced).
template <int NC>
__global__ void __launch_bounds__(LN_THREADS)
    layernorm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     const bf16* __restrict__ b, bf16* __restrict__ out, int rows, int d,
                     float eps) {
  const int row = blockIdx.x * (LN_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const bf16* xr = x + static_cast<size_t>(row) * d;
  bf16* orow = out + static_cast<size_t>(row) * d;
  float v[NC][4];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = 4 * (lane + 32 * i);
    if (c < d) {
      const uint2 raw = *reinterpret_cast<const uint2*>(xr + c);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[i][j] = bf2f(e[j]);
        s += v[i][j];
      }
    }
  }
  const float mean = fp::warp_sum(s) / d;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    if (4 * (lane + 32 * i) < d) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float t = v[i][j] - mean;
        q += t * t;
      }
    }
  }
  const float rstd = rsqrtf(fp::warp_sum(q) / d + eps);
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = 4 * (lane + 32 * i);
    if (c < d) {
      const uint2 wr = *reinterpret_cast<const uint2*>(w + c);
      const uint2 br = *reinterpret_cast<const uint2*>(b + c);
      const bf16* we = reinterpret_cast<const bf16*>(&wr);
      const bf16* be = reinterpret_cast<const bf16*>(&br);
      uint2 o;
      bf16* oe = reinterpret_cast<bf16*>(&o);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float n = (v[i][j] - mean) * rstd;
        oe[j] = f2bf(__fadd_rn(__fmul_rn(n, bf2f(we[j])), bf2f(be[j])));
      }
      *reinterpret_cast<uint2*>(orow + c) = o;
    }
  }
}

// ---------------------------------------------------------------------------
// GEMM: C[M, N] = A[M, K] . W[N, K]^T (W in nn.Linear layout) + epilogue.
// TMA + wgmma, one 128 x 128 tile per block: warps 0-7 are two consumer
// warpgroups (64 rows each), warp 8 the TMA producer.
// ---------------------------------------------------------------------------
constexpr int GM = 128, GN = 128, GK = 64;  // GK bf16 = one 128-byte swizzle row
constexpr int G_STAGES = 3;
constexpr int G_CONSUMERS = 256, G_THREADS = G_CONSUMERS + 32;
constexpr int G_A_BYTES = GM * 128, G_STAGE_BYTES = G_A_BYTES + GN * 128;
constexpr int G_SROW = GN + 8;  // bf16 a row of the epilogue staging: 272 bytes, conflict-free
constexpr size_t G_SMEM = 1024 + G_STAGES * G_STAGE_BYTES + 2 * G_STAGES * sizeof(uint64_t);
static_assert(GM * G_SROW * sizeof(bf16) <= G_STAGES * G_STAGE_BYTES, "staging fits the ring");

enum Epilogue { EPI_QKV = 0, EPI_GELU_TANH = 1, EPI_GELU_ERF = 2, EPI_RESID = 3 };

__device__ __forceinline__ float gelu_tanh(float x) {
  // jax.nn.gelu(approximate=True): x * 0.5 * (1 + tanh(u)), written as
  // x / (1 + exp(-2u)) with exp and the reciprocal from the SFU: within a
  // few f32 ulps of the tanh form, far below the bf16 cast that follows.
  const float inner = 0.7978845608028654f * (x + 0.044715f * (x * x * x));
  return __fdividef(x, 1.f + fp::ex2(-2.8853900817779268f * inner));  // 2 log2(e)
}

__device__ __forceinline__ float gelu_erf(float x) {
  // jax.nn.gelu(approximate=False)
  return __fmul_rn(__fmul_rn(0.5f, x), erfcf(__fmul_rn(-x, 0.70710678118654752f)));
}

// The f32 value at column n after bias, before the cast to bf16 (for the
// residual epilogue: ls * bf16(y), which the cast rounds as the contract says).
template <int EPI>
__device__ __forceinline__ float epilogue(float acc, float bias, float ls, int n, int scale_cols,
                                          float scale) {
  float v = __fadd_rn(acc, bias);
  if (EPI == EPI_QKV) return n < scale_cols ? __fmul_rn(v, scale) : v;
  if (EPI == EPI_GELU_TANH) return gelu_tanh(v);
  if (EPI == EPI_GELU_ERF) return gelu_erf(v);
  return __fmul_rn(ls, bf2f(f2bf(v)));
}

template <int EPI>
__global__ void __launch_bounds__(G_THREADS, 2)
    gemm_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w,
                const bf16* __restrict__ bias, bf16* __restrict__ C, int M, int N, int K,
                const bf16* __restrict__ resid, const bf16* __restrict__ ls, int scale_cols,
                float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G_STAGES * G_STAGE_BYTES);
  uint64_t* empty = full + G_STAGES;
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  const int nk = (K + GK - 1) / GK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G_STAGES; ++s) {
      fp::mbar_init(&full[s], 1);
      fp::mbar_init(&empty[s], G_CONSUMERS / 32);  // one arrival per consumer warp
    }
    fp::mbar_init_fence();
  }
  __syncthreads();

  if (warp == G_CONSUMERS / 32) {  // producer warp: A and W slices by TMA
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int s = 0; s < nk; ++s) {
        fp::mbar_wait(&empty[stage], phase ^ 1);
        fp::mbar_expect_tx(&full[stage], G_STAGE_BYTES);
        unsigned char* st = smem + stage * G_STAGE_BYTES;
        fp::tma_load_2d(st, &tm_a, &full[stage], s * GK, m0);
        fp::tma_load_2d(st + G_A_BYTES, &tm_w, &full[stage], s * GK, n0);
        if (++stage == G_STAGES) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  // One wgmma group per slice; a slice's stage is released once the next
  // slice's group is issued and its own has completed.
  const int wg = warp / 4;
  float acc[64];
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int s = 0; s < nk; ++s) {
    fp::mbar_wait(&full[stage], phase);
    fp::wgmma_fence();
    unsigned char* st = smem + stage * G_STAGE_BYTES;
    const uint64_t da = fp::wgmma_desc_sw128(st + wg * (G_A_BYTES / 2));
    const uint64_t db = fp::wgmma_desc_sw128(st + G_A_BYTES);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fp::wgmma_m64n128k16_bf16(acc, da + 2 * kk, db + 2 * kk, s > 0 || kk > 0);
    fp::wgmma_commit();
    if (s > 0) {
      fp::wgmma_wait<1>();
      if (lane == 0) fp::mbar_arrive(&empty[prev]);
    }
    prev = stage;
    if (++stage == G_STAGES) stage = 0, phase ^= 1;
  }
  fp::wgmma_wait<0>();

  // Epilogue. Both warpgroups' products are done, so the ring is free: each
  // warpgroup stages its 64 x 128 bf16 rows there, then stores them by
  // 16-byte chunks, 16 lanes a row.
  fp::named_sync(1, G_CONSUMERS);
  bf16* stg = reinterpret_cast<bf16*>(smem) + wg * 64 * G_SROW;
  const int r0 = 16 * (warp % 4) + lane / 4;  // accumulator rows r0 and r0 + 8
#pragma unroll
  for (int j = 0; j < GN / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4), n = n0 + col;
    float b0 = 0.f, b1 = 0.f, l0 = 0.f, l1 = 0.f;
    if (n < N) {  // N % 8 == 0: n + 1 < N too
      b0 = bf2f(bias[n]);
      b1 = bf2f(bias[n + 1]);
      if (EPI == EPI_RESID) {
        l0 = bf2f(ls[n]);
        l1 = bf2f(ls[n + 1]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = epilogue<EPI>(acc[4 * j + 2 * h], b0, l0, n, scale_cols, scale);
      const float v1 = epilogue<EPI>(acc[4 * j + 2 * h + 1], b1, l1, n + 1, scale_cols, scale);
      *reinterpret_cast<uint32_t*>(stg + (r0 + 8 * h) * G_SROW + col) = fp::pack_bf16(v0, v1);
    }
  }
  fp::named_sync(2 + wg, 128);
  for (int i = threadIdx.x % 128; i < 64 * (GN / 8); i += 128) {
    const int r = i / (GN / 8), c = (i % (GN / 8)) * 8;
    const int m = m0 + 64 * wg + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    uint4 v = *reinterpret_cast<const uint4*>(stg + r * G_SROW + c);
    const size_t o = static_cast<size_t>(m) * N + n;
    if (EPI == EPI_RESID) {
      const uint4 xr = *reinterpret_cast<const uint4*>(resid + o);
      bf16* ve = reinterpret_cast<bf16*>(&v);
      const bf16* xe = reinterpret_cast<const bf16*>(&xr);
#pragma unroll
      for (int e = 0; e < 8; ++e) ve[e] = f2bf(__fadd_rn(bf2f(xe[e]), bf2f(ve[e])));
    }
    *reinterpret_cast<uint4*>(C + o) = v;
  }
}

// ---------------------------------------------------------------------------
// Attention over the qkv buffer [B, T, 3D] (q pre-scaled by log2(e)/sqrt(hd)).
// One block per (128-query tile, head, image); 8 warps, 16 query rows each.
// Lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8 of every
// accumulator fragment, columns 2t and 2t + 1.
// ---------------------------------------------------------------------------
constexpr int AQ = 128, AK = 64, HD = 64, ALD = HD + 8, ATHREADS = 256, ABLOCKS = 2;

// Rows [r0, r0 + 64) of one head's 64 columns (row stride rs elements) by
// cp.async; rows at or past `limit` are zero.
__device__ __forceinline__ void load_head_tile(bf16* dst, const bf16* __restrict__ src, size_t rs,
                                               int r0, int limit) {
  for (int i = threadIdx.x; i < AK * (HD / 8); i += ATHREADS) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
    const bool ok = r0 + r < limit;
    fp::cp_async16(dst + r * ALD + c, ok ? src + static_cast<size_t>(r0 + r) * rs + c : src, ok);
  }
}

template <bool CAPPED>
__global__ void __launch_bounds__(ATHREADS, ABLOCKS)
    attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int T, int seq_len,
                     int D) {
  __shared__ __align__(128) bf16 Ks[2][AK * ALD];
  __shared__ __align__(128) bf16 Vs[2][AK * ALD];
  const int q0 = blockIdx.x * AQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const size_t rs = 3 * static_cast<size_t>(D);
  const bf16* base = qkv + static_cast<size_t>(b) * T * rs + h * HD;
  const int ntiles = (seq_len + AK - 1) / AK;
  const int first_v = CAPPED ? 0 : ntiles;  // the first step of the value pass
  const int steps = first_v + ntiles;

  // Step u loads K tile u (pass 1) or K and V tile u - first_v into buffer u % 2.
  auto issue = [&](int u) {
    if (u < steps) {
      const int tile = u < first_v ? u : u - first_v;
      load_head_tile(Ks[u % 2], base + D, rs, tile * AK, seq_len);
      if (u >= first_v) load_head_tile(Vs[u % 2], base + 2 * D, rs, tile * AK, seq_len);
    }
    fp::cp_async_commit();
  };
  issue(0);
  issue(1);

  // This warp's 16 query rows as A fragments, straight from the qkv buffer:
  // a[0] row g, k 2t; a[1] row g + 8; a[2] row g, k 8 + 2t; a[3] row g + 8.
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 16 * warp + g + 8 * (i % 2);
      qf[kk][i] = row < T ? *reinterpret_cast<const uint32_t*>(
                                base + static_cast<size_t>(row) * rs + 16 * kk + 8 * (i / 2) + 2 * t)
                          : 0u;
    }

  float m[2] = {-INFINITY, -INFINITY};  // column: row max of the logits (base 2)
  float l[2] = {0.f, 0.f};              // per-thread part of the sum of bf16(p)
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int u = 0; u < steps; ++u) {
    fp::cp_async_wait<1>();
    __syncthreads();
    const bf16* Kb = Ks[u % 2];
    if (!CAPPED && u < first_v) {  // pass 1: the row max
      float s[8][4];
#pragma unroll
      for (int np = 0; np < 4; ++np) fp::logits_pair<HD / 16, ALD>(s + 2 * np, qf, Kb, np, lane);
      fp::mask_keys<8>(s, u * AK, t, seq_len);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) m[e / 2] = fmaxf(m[e / 2], s[n][e]);
      if (u == first_v - 1) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 1));
          m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 2));
        }
      }
    } else {  // the weights, 16 keys at a time: S, then P = bf16(p) as A fragments, O += P V
      const bf16* Vb = Vs[u % 2];
      const int k0 = (u - first_v) * AK;
#pragma unroll
      for (int j = 0; j < AK / 16; ++j) {
        float s[2][4];
        fp::logits_pair<HD / 16, ALD>(s, qf, Kb, j, lane);
        fp::mask_keys<2>(s, k0 + 16 * j, t, seq_len);
        uint32_t a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // A fragment i: key block i / 2, row g + 8 (i % 2)
          const float* sv = s[i / 2] + 2 * (i % 2);
          const int hh = i % 2;
          float p0, p1;
          if (CAPPED) {
            p0 = fminf(fp::ex2(sv[0]), 1e30f);
            p1 = fminf(fp::ex2(sv[1]), 1e30f);
          } else {
            p0 = fp::ex2(__fsub_rn(sv[0], m[hh]));
            p1 = fp::ex2(__fsub_rn(sv[1], m[hh]));
          }
          a[i] = fp::pack_bf16(p0, p1);
          const float2 pr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a[i]));
          l[hh] += pr.x + pr.y;
        }
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {  // dims 16dp .. 16dp + 15
          uint32_t bv[4];
          fp::ldmatrix_x4_trans(bv, Vb + (16 * j + lane % 8 + 8 * ((lane / 8) % 2)) * ALD + 16 * dp +
                                        8 * (lane / 16));
          fp::mma_bf16(o[2 * dp], a, bv[0], bv[1]);
          fp::mma_bf16(o[2 * dp + 1], a, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // buffer u % 2 consumed
    issue(u + 2);
  }
  fp::cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const float inv = 1.f / fmaxf(l[hh], 1e-30f);
    const int row = q0 + 16 * warp + g + 8 * hh;
    if (row >= T) continue;
    bf16* dst = out + (static_cast<size_t>(b) * T + row) * D + h * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n + 2 * t) =
          fp::pack_bf16(__fmul_rn(o[n][2 * hh], inv), __fmul_rn(o[n][2 * hh + 1], inv));
  }
}

template <int EPI>
int launch_gemm(const bf16* A, const bf16* W, const bf16* bias, bf16* C, int M, int N, int K,
                const bf16* resid, const bf16* ls, int scale_cols, float scale,
                cudaStream_t stream) {
  // Once per process and instantiation: shared memory past 48 KB.
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(G_SMEM));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tm_a, tm_w;
  int rc = fp::encode_tensor_map_2d(&tm_a, A, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, GM, GK,
                                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  rc = fp::encode_tensor_map_2d(&tm_w, W, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, N, K, GN, GK,
                                CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  const dim3 grid((N + GN - 1) / GN, (M + GM - 1) / GM);
  gemm_kernel<EPI><<<grid, G_THREADS, G_SMEM, stream>>>(tm_a, tm_w, bias, C, M, N, K, resid, ls,
                                                        scale_cols, scale);
  return fp::launch_status();
}

int launch_layernorm(const bf16* x, const bf16* w, const bf16* b, bf16* out, int rows, int d,
                     float eps, cudaStream_t stream) {
  const int blocks = (rows + LN_THREADS / 32 - 1) / (LN_THREADS / 32);
  switch ((d + 127) / 128) {
#define FP_LN_CASE(nc) \
  case nc:             \
    layernorm_kernel<nc><<<blocks, LN_THREADS, 0, stream>>>(x, w, b, out, rows, d, eps); break;
    FP_LN_CASE(1) FP_LN_CASE(2) FP_LN_CASE(3) FP_LN_CASE(4) FP_LN_CASE(5) FP_LN_CASE(6)
    FP_LN_CASE(7) FP_LN_CASE(8) FP_LN_CASE(9) FP_LN_CASE(10) FP_LN_CASE(11) FP_LN_CASE(12)
#undef FP_LN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return fp::launch_status();
}

template <bool CAPPED>
int launch_attention(const bf16* qkv, bf16* out, int batch, int T, int seq_len, int D, int heads,
                     cudaStream_t stream) {
  const dim3 grid((T + AQ - 1) / AQ, heads, batch);
  attention_kernel<CAPPED><<<grid, ATHREADS, 0, stream>>>(qkv, out, T, seq_len, D);
  return fp::launch_status();
}

}  // namespace

// x, out: [batch, tokens, dim] bf16. Weights bf16, nn.Linear layout. The five
// scratch buffers are [batch*tokens, dim] (xn, attn, x1), [.., 3*dim] (qkv)
// and [.., hidden] (h). Every pointer 16-byte aligned. Returns the first
// non-zero cudaGetLastError().
FP_EXPORT int fp_vit_block(
    const void* x, void* out, const void* n1w, const void* n1b,
    const void* qkv_w, const void* qkv_b, const void* proj_w,
    const void* proj_b, const void* ls1, const void* n2w, const void* n2b,
    const void* fc1_w, const void* fc1_b, const void* fc2_w, const void* fc2_b,
    const void* ls2, void* xn_buf, void* qkv_buf, void* attn_buf, void* x1_buf,
    void* h_buf, int batch, int tokens, int seq_len, int dim, int hidden,
    int num_heads, float eps, float q_scale, int gelu_tanh, int capped,
    void* stream_ptr) {
  if (dim != num_heads * HD || dim > 4 * 32 * LN_MAX_CHUNKS || hidden % 8 != 0 || hidden < 8 ||
      seq_len < 1 || seq_len > tokens || batch < 1 || batch > 65535 || num_heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int M = batch * tokens;
  auto B = [](const void* p) { return static_cast<const bf16*>(p); };
  auto Bm = [](void* p) { return static_cast<bf16*>(p); };
  int rc;
  if ((rc = launch_layernorm(B(x), B(n1w), B(n1b), Bm(xn_buf), M, dim, eps, stream))) return rc;
  if ((rc = launch_gemm<EPI_QKV>(B(xn_buf), B(qkv_w), B(qkv_b), Bm(qkv_buf), M,
                                 3 * dim, dim, nullptr, nullptr, dim, q_scale, stream)))
    return rc;
  rc = capped ? launch_attention<true>(B(qkv_buf), Bm(attn_buf), batch, tokens, seq_len, dim, num_heads, stream)
              : launch_attention<false>(B(qkv_buf), Bm(attn_buf), batch, tokens, seq_len, dim, num_heads, stream);
  if (rc) return rc;
  if ((rc = launch_gemm<EPI_RESID>(B(attn_buf), B(proj_w), B(proj_b), Bm(x1_buf), M,
                                   dim, dim, B(x), B(ls1), 0, 1.f, stream)))
    return rc;
  if ((rc = launch_layernorm(B(x1_buf), B(n2w), B(n2b), Bm(xn_buf), M, dim, eps, stream))) return rc;
  rc = gelu_tanh ? launch_gemm<EPI_GELU_TANH>(B(xn_buf), B(fc1_w), B(fc1_b), Bm(h_buf), M,
                                              hidden, dim, nullptr, nullptr, 0, 1.f, stream)
                 : launch_gemm<EPI_GELU_ERF>(B(xn_buf), B(fc1_w), B(fc1_b), Bm(h_buf), M,
                                             hidden, dim, nullptr, nullptr, 0, 1.f, stream);
  if (rc) return rc;
  return launch_gemm<EPI_RESID>(B(h_buf), B(fc2_w), B(fc2_b), Bm(out), M, dim,
                                hidden, B(x1_buf), B(ls2), 0, 1.f, stream);
}
