// One pre-norm ViT block (DINOv2, DINOv3) on Hopper, as seven hand-written
// kernels launched in sequence by fp_vit_block:
//
//   LN1 -> GEMM(qkv, bias, q scaled) -> attention -> GEMM(proj, bias,
//   layer-scaled residual) -> LN2 -> GEMM(fc1, bias, GELU) -> GEMM(fc2, bias,
//   layer-scaled residual)
//
// or, for SwiGLU models (DINOv2 ViT-G/14, DINOv3 ViT-7B/16), GEMM(w12, bias,
// silu(gate) * value) -> GEMM(w3, bias, layer-scaled residual) in place of
// fc1 and fc2. Heads are 64 or 128 wide; with rotary tables (DINOv3) the qkv
// GEMM rotates q and k of the patch tokens in its epilogue (EPI_QKV_ROPE).
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
// - SwiGLU (the TPU kernel's branch at ops/vit_block.py:303): the w12 GEMM
//   gives h = silu(A W1^T + b1) * (A W2^T + b2), W1 = w12 rows [0, H) (gate),
//   W2 = rows [H, 2H) (value). Its tile is 128 rows x 64 columns of h from
//   one 128 x 128 accumulator: the producer loads the B slice as two 64-row
//   TMA boxes, gate rows [n0, n0 + 64) then value rows [H + n0, H + n0 + 64),
//   so accumulator column c is gate column n0 + c and column c + 64 its
//   value. In the wgmma m64n128 layout both sit in one thread (acc[4j + e]
//   and acc[4(j + 8) + e]), and the epilogue combines them in registers: no
//   weight permutation, no second pass, no [M, 2H] buffer (in f32, as the
//   rounding point needs, 474 MB at ViT-G with batch 16). At ViT-G (M =
//   14,480, H = 4,096, K = 1,536) the product is 364 GFLOP: tensor-core
//   bound (0.37 ms at 989 TFLOP/s).
// - Attention: persistent and warp-specialised, one block a SM walking
//   work tiles of (query tile, head, image). A producer warpgroup (24-32
//   registers by setmaxnreg) has one thread issue every TMA load from 3-D
//   tensor maps over [B, T, 3D] (rows past T read as zero, never as the
//   next image's): each tile's Q once, then its K and V tiles through two
//   rings of mbarrier-completed slots, released apart (K once its logits
//   are done, V once its value product is). The rings run on from tile to
//   tile, and Q's buffer is released before a tile's last value product,
//   so the next tile's first K and its Q load under that product and the
//   stores. Each consumer warpgroup owns 64 query rows. S = Q K^T is wgmma
//   m64nBNk16 with both operands in 128-byte swizzled shared memory (K
//   K-major as it lies in the buffer; heads of 128 as two 64-column boxes);
//   S stays in registers, each pair of p is rounded to bf16 and packed
//   straight into the A fragment of O += P V, wgmma m64nHDk16 with A from
//   registers and V as the transposed (MN-major) B: no copy of V and no
//   logit touches shared memory. Within a warpgroup the logits of tile j
//   are issued with the value product of tile j - 1, so tile j's exp2 runs
//   while the tensor cores work; the warpgroups of a block interleave
//   besides (taking turns at the tensor cores by named barriers, as FA3
//   does, was 6-12% slower here).
//   Heads of 128: 2 consumer warpgroups (128 query rows, 240 registers),
//   key tiles of 176, 2 stages (209 KB): the tensor cores bind (S and P V
//   are 2 x 64 x 176 x 128 x 2 operations a warpgroup and tile against
//   11,264 exp2, half the SFU's time for them). Heads of 64: 3 consumer
//   warpgroups (192 rows, 160 registers), key tiles of 128, 3 stages (121
//   KB): a tile's 8,192 exp2 a warpgroup (16 a clock per SM) take as long as
//   its two products on the tensor cores, so the SFU binds as much as they
//   do. Measured on an H100 at the benchmark's shapes, 37-40% of the
//   tensor-core bound at both head dims; dropping the exp2 takes 12-14% of
//   the time, dropping P V 32-34%. exp2 stays on the SFU (ex2.approx): a
//   quarter of it as a polynomial on the FMA pipes was slower at heads of 64.
//   Ragged ends: the last query tile runs whole, its rows past T never
//   stored; a last key tile of at most 16 (heads of 64) or 32 keys (heads
//   of 128) runs as a narrow wgmma (N = 16 or 32), and keys past seq_len
//   are masked to -inf. At T = 905 the products spent on padding are 6.5%
//   at heads of 64 (960 query rows x 912 keys) and 12.3% at heads of 128
//   (1,024 x 912); at T = 901, 7.3% at heads of 64 (the mma.sync design
//   this replaced: 16.7% and 17.4%).
// - RoPE (DINOv3's axial 2-D rotary positions, the TPU kernel has none):
//   at head dim 128 a 128-wide N tile of q or k is exactly one head, and
//   head columns c and c + 64, which the rotation pairs, sit in one thread
//   of the m64n128 accumulator (acc[4j + e] and acc[4(j + 8) + e]), as the
//   SwiGLU gate/value pair does. So the qkv GEMM's epilogue rotates the f32
//   accumulator of rows whose token index t = row mod T is at least
//   `prefix` (the class and storage tokens are not rotated), with cos and
//   sin from [T - prefix, 64] f32 tables (230 KB each at a 30 x 30 grid;
//   the tile's 128 rows copied into the free ring by cp.async at once),
//   before the q scale and the single cast to bf16: no extra pass over q
//   and k, no f32 copy of them.
// - LayerNorm: one warp per token row, 8-byte loads, the row in registers
//   (up to d = 4,096: 128 values a lane).
//   LN is 5% of the block (2% of the first form's; split in PERF.md), so
//   it is not folded into the GEMMs.
//
// Rounding points follow the TPU kernel (ops/vit_block.py):
//  - log2(e)/sqrt(hd) is folded into q before q is cast to bf16;
//  - RoPE: q and k rotated in f32 (x1 cos - x2 sin, x2 cos + x1 sin, each
//    product and sum rounded to f32) before the q scale and the bf16 cast;
//  - "capped" softmax: p = min(exp2(l), 1e30) with no max; "column": the
//    per-query max over all keys is subtracted (a first pass over the keys
//    finds it, so p is the same value the TPU kernel forms);
//  - the normalizer is the f32 sum of the bf16-rounded p, floored at 1e-30,
//    applied as a multiply by its reciprocal;
//  - proj and fc2 outputs are cast to bf16 before x + ls * y, which is
//    evaluated in bf16 (ls * y rounded, then the sum rounded).
// Tokens are not padded: rows at or past `tokens` are never touched, and
// keys at or past `seq_len` are masked out of the softmax.
#include <climits>

#include "hopper.cuh"

namespace {

using fp::bf2f;
using fp::f2bf;

// ---------------------------------------------------------------------------
// LayerNorm: one warp per token row; statistics in f32, output bf16.
// ---------------------------------------------------------------------------
constexpr int LN_THREADS = 256, LN_MAX_CHUNKS = 32;  // 4 values a chunk: d <= 4096

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
// warpgroups (64 rows each), warp 8 the TMA producer. EPI_SWIGLU: W is
// [2N, K] and a block writes 128 x 64 of C (TILE_N). EPI_QKV_ROPE: N = 3 x
// 128 x heads, a tile is one head of q, k or v.
// ---------------------------------------------------------------------------
constexpr int GM = 128, GN = 128, GK = 64;  // GK bf16 = one 128-byte swizzle row
constexpr int G_STAGES = 3;
constexpr int G_CONSUMERS = 256, G_THREADS = G_CONSUMERS + 32;
constexpr int G_A_BYTES = GM * 128, G_STAGE_BYTES = G_A_BYTES + GN * 128;
constexpr int G_SROW = GN + 8;  // bf16 a row of the epilogue staging: 272 bytes, conflict-free
constexpr size_t G_SMEM = 1024 + G_STAGES * G_STAGE_BYTES + 2 * G_STAGES * sizeof(uint64_t);
static_assert(GM * G_SROW * sizeof(bf16) <= G_STAGES * G_STAGE_BYTES, "staging fits the ring");
// EPI_QKV_ROPE's tables of a tile's rows in the ring: f32 a row of 64 and 8
// of padding (2-way bank conflicts at most on a warp's float2 reads).
constexpr int RT_LD = GN / 2 + 8;
static_assert(2 * GM * RT_LD * sizeof(float) <= G_STAGES * G_STAGE_BYTES, "tables fit the ring");

enum Epilogue {
  EPI_QKV = 0, EPI_GELU_TANH = 1, EPI_GELU_ERF = 2, EPI_RESID = 3, EPI_SWIGLU = 4, EPI_QKV_ROPE = 5
};

// The rotary tables of EPI_QKV_ROPE: cos and sin [tokens - prefix, 64] f32,
// row p for token prefix + p of every image (tokens a image).
struct Rope {
  const float* cos;
  const float* sin;
  int tokens, prefix;
};

// Output columns of one tile: SwiGLU's 128 accumulator columns are 64 gate
// and 64 value columns of the same 64 outputs.
template <int EPI>
constexpr int TILE_N = EPI == EPI_SWIGLU ? GN / 2 : GN;

__device__ __forceinline__ float gelu_tanh(float x) {
  // jax.nn.gelu(approximate=True): x * 0.5 * (1 + tanh(u)), written as
  // x / (1 + exp(-2u)) with exp and the reciprocal from the SFU: within a
  // few f32 ulps of the tanh form, far below the bf16 cast that follows.
  const float inner = 0.7978845608028654f * (x + 0.044715f * (x * x * x));
  return __fdividef(x, 1.f + fp::ex2(-2.8853900817779268f * inner));  // 2 log2(e)
}

__device__ __forceinline__ float silu(float x) {
  // jax.nn.silu: x * sigmoid(x) = x / (1 + exp(-x)), exp from the SFU.
  return __fdividef(x, 1.f + fp::ex2(-1.4426950408889634f * x));  // log2(e)
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
                float scale, const Rope rope) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G_STAGES * G_STAGE_BYTES);
  uint64_t* empty = full + G_STAGES;
  constexpr int TN = TILE_N<EPI>;
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * TN;
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
        if (EPI == EPI_SWIGLU) {  // gate rows, then the value rows of the same outputs
          fp::tma_load_2d(st + G_A_BYTES, &tm_w, &full[stage], s * GK, n0);
          fp::tma_load_2d(st + G_A_BYTES + TN * 128, &tm_w, &full[stage], s * GK, N + n0);
        } else {
          fp::tma_load_2d(st + G_A_BYTES, &tm_w, &full[stage], s * GK, n0);
        }
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
  // warpgroup stages its 64 x TN bf16 rows there, then stores them by
  // 16-byte chunks, TN / 8 lanes a row.
  fp::named_sync(1, G_CONSUMERS);
  bf16* stg = reinterpret_cast<bf16*>(smem) + wg * 64 * G_SROW;
  const int r0 = 16 * (warp % 4) + lane / 4;  // accumulator rows r0 and r0 + 8
  if constexpr (EPI == EPI_SWIGLU) {
    // Gate and value in f32 from their accumulators and biases; the product
    // rounded to bf16 once, as the TPU kernel rounds it.
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4), n = n0 + col;
      float g0 = 0.f, g1 = 0.f, v0 = 0.f, v1 = 0.f;
      if (n < N) {  // N % 8 == 0: n + 1 < N too
        g0 = bf2f(bias[n]);
        g1 = bf2f(bias[n + 1]);
        v0 = bf2f(bias[N + n]);
        v1 = bf2f(bias[N + n + 1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* ga = acc + 4 * j + 2 * h;
        const float* va = acc + 4 * (j + TN / 8) + 2 * h;
        const float y0 = __fmul_rn(silu(__fadd_rn(ga[0], g0)), __fadd_rn(va[0], v0));
        const float y1 = __fmul_rn(silu(__fadd_rn(ga[1], g1)), __fadd_rn(va[1], v1));
        *reinterpret_cast<uint32_t*>(stg + (r0 + 8 * h) * G_SROW + col) = fp::pack_bf16(y0, y1);
      }
    }
  } else if constexpr (EPI == EPI_QKV_ROPE) {
    // The tile is one head: q (n0 < scale_cols = D), k (n0 < 2D) or v.
    // Columns col and col + 64 (col < 64) are the rotation's pair. For q and
    // k the consumers first copy the cos and sin rows of the tile's 128 rows
    // into the free ring, all by cp.async at once (one round trip to L2, not
    // one a column pair), then turn the accumulators in place into the
    // output values, and stage them only after every thread has read the
    // tables (the staging overwrites them).
    const bool rotated = n0 < 2 * scale_cols;
    const float sc = n0 < scale_cols ? scale : 1.f;
    float* tab = reinterpret_cast<float*>(smem);  // [2][GM][RT_LD]: cos rows, then sin rows
    if (rotated) {
      for (int i = threadIdx.x; i < 2 * GM * (GN / 8); i += G_CONSUMERS) {
        const int t = i / (GM * (GN / 8)), r = (i / (GN / 8)) % GM, c = 4 * (i % (GN / 8));
        const int m = m0 + r;
        const int p = m < M ? m % rope.tokens - rope.prefix : -1;
        const float* src = (t ? rope.sin : rope.cos) + static_cast<size_t>(p < 0 ? 0 : p) * (GN / 2);
        fp::cp_async16(tab + (t * GM + r) * RT_LD + c, src + c, p >= 0);
      }
      fp::cp_async_commit();
      fp::cp_async_wait<0>();
      fp::named_sync(1, G_CONSUMERS);
    }
    bool on[2];  // rows r0 and r0 + 8 of this warpgroup rotated
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 64 * wg + r0 + 8 * h;
      on[h] = rotated && m < M && m % rope.tokens >= rope.prefix;
    }
#pragma unroll
    for (int j = 0; j < GN / 16; ++j) {
      const int col = 8 * j + 2 * (lane % 4), n = n0 + col;
      const float2 b1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + n));
      const float2 b2 =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + n + GN / 2));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* a1 = acc + 4 * j + 2 * h;             // column col
        float* a2 = acc + 4 * (j + GN / 16) + 2 * h;  // column col + 64
        float x1[2] = {__fadd_rn(a1[0], b1.x), __fadd_rn(a1[1], b1.y)};
        float x2[2] = {__fadd_rn(a2[0], b2.x), __fadd_rn(a2[1], b2.y)};
        if (on[h]) {
          const float* cr = tab + (64 * wg + r0 + 8 * h) * RT_LD + col;
          const float2 c = *reinterpret_cast<const float2*>(cr);
          const float2 sn = *reinterpret_cast<const float2*>(cr + GM * RT_LD);
          const float cv[2] = {c.x, c.y}, sv[2] = {sn.x, sn.y};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float y1 = __fsub_rn(__fmul_rn(x1[e], cv[e]), __fmul_rn(x2[e], sv[e]));
            const float y2 = __fadd_rn(__fmul_rn(x2[e], cv[e]), __fmul_rn(x1[e], sv[e]));
            x1[e] = y1;
            x2[e] = y2;
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          a1[e] = __fmul_rn(x1[e], sc);
          a2[e] = __fmul_rn(x2[e], sc);
        }
      }
    }
    if (rotated) fp::named_sync(1, G_CONSUMERS);  // every thread has read the tables
#pragma unroll
    for (int j = 0; j < GN / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(stg + (r0 + 8 * h) * G_SROW + col) =
            fp::pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  } else {
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
  }
  fp::named_sync(2 + wg, 128);
  for (int i = threadIdx.x % 128; i < 64 * (TN / 8); i += 128) {
    const int r = i / (TN / 8), c = (i % (TN / 8)) * 8;
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
// Persistent: one block a SM (never more than the tiles) walks the work
// tiles of (BM query rows, head, image) in a fixed stride. Warpgroup 0 is the
// producer: one thread issues every TMA load, each tile's first K tile, its
// Q (once the last tile's Q is released), then its K and V tiles of BN keys
// into two rings of STAGES slots (K and V released separately: a K slot is
// free once its logits are done, a V slot once its value product is). The
// other WGS warpgroups are consumers, 64 query rows each, with the
// registers setmaxnreg moves from the producer.
//
// A consumer, per key tile j: S = Q K_j^T by wgmma m64nBNk16 with both
// operands in shared memory (K K-major as it lies in the buffer); masks keys
// at or past seq_len; p as the contract says, each pair rounded to bf16 and
// packed straight into the A fragment of the value product; O += P V_j by
// wgmma m64nHDk16 with A from registers and V as the transposed (MN-major)
// B operand. The tiles overlap within the warpgroup: the logits of tile j
// and the value product of tile j - 1 are issued together, and the exp2 of
// tile j runs while the tensor cores compute P_{j-1} V_{j-1}; the
// warpgroups of a block interleave on top of that. Q is released after a
// work tile's last logits, before its last value product and its stores.
// "column" runs a first pass of logits alone for the row max.
// ---------------------------------------------------------------------------
// Tiles by head dim. Heads of 128: 2 consumer warpgroups (128 query rows,
// 240 registers: S 88, P 44 and O 64 live at once), keys in tiles of 176,
// two stages of K and of V (Q 32 KB + 176 KB). Heads of 64: 3 consumer
// warpgroups (192 rows, 160 registers: S 64, P 32, O 32), keys in tiles of
// 128, three stages (Q 24 KB + 96 KB). A last key tile of at most TN keys
// runs as a narrow one (wgmma N = TN).
template <int HD>
struct AttnShape;
template <>
struct AttnShape<64> {
  static constexpr int WGS = 3, BN = 128, TN = 16, STAGES = 3, PRODUCER_REGS = 32,
                       CONSUMER_REGS = 160;
};
template <>
struct AttnShape<128> {
  static constexpr int WGS = 2, BN = 176, TN = 32, STAGES = 2, PRODUCER_REGS = 24,
                       CONSUMER_REGS = 240;
};

template <int HD>
struct Attn : AttnShape<HD> {
  static constexpr int BM = 64 * AttnShape<HD>::WGS;  // query rows a block
  static constexpr int THREADS = 128 * (AttnShape<HD>::WGS + 1);
  static constexpr int HALVES = HD / 64;  // 64-column boxes a head: one 128-byte swizzle row each
  static constexpr int Q_BYTES = HALVES * BM * 128;
  static constexpr int TILE_BYTES = HALVES * AttnShape<HD>::BN * 128;  // one K or V tile
  static constexpr size_t SMEM =
      1024 + Q_BYTES + 2 * AttnShape<HD>::STAGES * TILE_BYTES +
      (1 + 4 * AttnShape<HD>::STAGES) * sizeof(uint64_t);
  static_assert(SMEM <= 232448, "shared memory of one block");
  static_assert(128 * (AttnShape<HD>::PRODUCER_REGS +
                       AttnShape<HD>::WGS * AttnShape<HD>::CONSUMER_REGS) <=
                    65536 / THREADS / 8 * 8 * THREADS,
                "setmaxnreg moves registers within the block's launch allocation");
};

// A slot of a ring and the parity of its current phase.
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++stage == stages) stage = 0, phase ^= 1;
  }
};

// S [64 x N] = Q K^T of one warpgroup over the first N keys of a K tile of
// BN rows, issued and committed: dq the warpgroup's Q rows in column half 0
// (half c lies c * BM * 128 bytes on), dk the K tile's (half c c * BN * 128
// bytes on).
template <int HD, int BM, int BN, int N>
__device__ __forceinline__ void issue_logits(float* s, uint64_t dq, uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk / 4, k = 2 * (kk % 4);  // 32 bytes a step within the 128-byte row
    fp::wgmma_ss_bf16<N>(s, dq + c * (BM * 128 >> 4) + k, dk + c * (BN * 128 >> 4) + k, kk > 0);
  }
  fp::wgmma_commit();
}

// O [64 x HD] += P V of one warpgroup over N keys, issued and committed: p
// the packed bf16 weights (p[4kk .. 4kk + 3] the A fragment of keys 16kk ..
// 16kk + 15), dv the V tile as a transposed B (16 keys = 2048 bytes).
template <int HD, int N>
__device__ __forceinline__ void issue_values(float* o, const uint32_t* p, uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) fp::wgmma_rs_bf16_tb<HD>(o, p + 4 * kk, dv + 128 * kk, 1);
  fp::wgmma_commit();
}

// Logits of keys at or past seq_len to -inf. s[4j + 2h + e] is row g + 8h,
// key k0 + 8j + 2t + e (the wgmma accumulator layout).
template <int N>
__device__ __forceinline__ void mask_tile(float* s, int k0, int t, int seq_len) {
  if (k0 + N <= seq_len) return;
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    if (k0 + 8 * (i / 4) + 2 * t + (i & 1) >= seq_len) s[i] = -INFINITY;
}

// The weights of one tile: p from the logits as the contract says, rounded
// to bf16 in pairs and packed (pk[q] from s[2q], s[2q + 1]: the A fragment
// order), and the sums l of the rounded weights of rows g and g + 8.
template <int N, bool CAPPED>
__device__ __forceinline__ void tile_weights(const float* s, uint32_t* pk, float* l, const float* m) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const int h = q % 2;
    float p0, p1;
    if (CAPPED) {
      p0 = fminf(fp::ex2(s[2 * q]), 1e30f);
      p1 = fminf(fp::ex2(s[2 * q + 1]), 1e30f);
    } else {
      p0 = fp::ex2(__fsub_rn(s[2 * q], m[h]));
      p1 = fp::ex2(__fsub_rn(s[2 * q + 1], m[h]));
    }
    pk[q] = fp::pack_bf16(p0, p1);
    const float2 pr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pk[q]));
    l[h] += pr.x + pr.y;
  }
}

// One consumer warpgroup's walk over the key tiles: its rings' positions,
// its row statistics and the operations of a tile.
template <int HD, bool CAPPED>
struct Consumer {
  using A = Attn<HD>;
  unsigned char *Ks, *Vs;
  uint64_t *k_full, *k_empty, *v_full, *v_empty;
  uint64_t dq;
  int lane, t, seq_len;
  Ring kr, vr;
  float m[2] = {-INFINITY, -INFINITY};  // column: row max of the logits (base 2)
  float l[2] = {0.f, 0.f};              // this thread's part of the sum of bf16(p)

  __device__ __forceinline__ uint64_t k_desc() {
    fp::mbar_wait(&k_full[kr.stage], kr.phase);
    return fp::wgmma_desc_sw128(Ks + kr.stage * A::TILE_BYTES);
  }
  __device__ __forceinline__ uint64_t v_desc() {
    fp::mbar_wait(&v_full[vr.stage], vr.phase);
    return fp::wgmma_desc_sw128_mn(Vs + vr.stage * A::TILE_BYTES, A::BN * 128);
  }
  __device__ __forceinline__ void release(uint64_t* empty, Ring& r) {
    if (lane == 0) fp::mbar_arrive(&empty[r.stage]);  // this warp's products are done with it
    r.next(A::STAGES);
  }
  // "column"'s first pass: the row max over the next K tile (keys from k0).
  __device__ __forceinline__ void row_max(int k0) {
    float s[A::BN / 2];
    const uint64_t dk = k_desc();
    fp::wgmma_fence();
    issue_logits<HD, A::BM, A::BN, A::BN>(s, dq, dk);
    fp::wgmma_wait<0>();
    release(k_empty, kr);
    mask_tile<A::BN>(s, k0, t, seq_len);
#pragma unroll
    for (int i = 0; i < A::BN / 2; ++i) m[(i / 2) % 2] = fmaxf(m[(i / 2) % 2], s[i]);
  }
  // The weights pk of the next K tile's first N keys (from k0).
  template <int N>
  __device__ __forceinline__ void first(uint32_t* pk, int k0) {
    float s[N / 2];
    const uint64_t dk = k_desc();
    fp::wgmma_fence();
    issue_logits<HD, A::BM, A::BN, N>(s, dq, dk);
    fp::wgmma_wait<0>();
    release(k_empty, kr);
    mask_tile<N>(s, k0, t, seq_len);
    tile_weights<N, CAPPED>(s, pk, l, m);
  }
  // The weights pk of the next K tile's first N keys (from k0), while the
  // tensor cores add P V of the previous tile (p, its first NP keys) to o.
  template <int N, int NP>
  __device__ __forceinline__ void step(float* o, const uint32_t* p, uint32_t* pk, int k0) {
    float s[N / 2];
    const uint64_t dk = k_desc();
    const uint64_t dv = v_desc();
    fp::wgmma_fence();
    issue_logits<HD, A::BM, A::BN, N>(s, dq, dk);
    issue_values<HD, NP>(o, p, dv);
    fp::wgmma_wait<1>();  // the logits are done
    release(k_empty, kr);
    mask_tile<N>(s, k0, t, seq_len);
    tile_weights<N, CAPPED>(s, pk, l, m);
    fp::wgmma_wait<0>();  // the value product is done with p and V
    release(v_empty, vr);
  }
  // P V of the last tile (p, its first NP keys) added to o.
  template <int NP>
  __device__ __forceinline__ void last(float* o, const uint32_t* p) {
    const uint64_t dv = v_desc();
    fp::wgmma_fence();
    issue_values<HD, NP>(o, p, dv);
    fp::wgmma_wait<0>();
    release(v_empty, vr);
  }
};

template <int HD, bool CAPPED>
__global__ void __launch_bounds__(Attn<HD>::THREADS, 1)
    attention_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_kv,
                     bf16* __restrict__ out, int T, int seq_len, int D, int heads, int tiles) {
  using A = Attn<HD>;
  constexpr int BM = A::BM, BN = A::BN, TN = A::TN, STAGES = A::STAGES, WGS = A::WGS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Ks = Qs + A::Q_BYTES;             // [STAGES][TILE_BYTES]
  unsigned char* Vs = Ks + STAGES * A::TILE_BYTES;  // [STAGES][TILE_BYTES]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + STAGES * A::TILE_BYTES);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;
  uint64_t* k_empty = k_full + STAGES;
  uint64_t* v_full = k_empty + STAGES;
  uint64_t* v_empty = v_full + STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qtiles = (T + BM - 1) / BM, ntiles = (seq_len + BN - 1) / BN;
  if (threadIdx.x == 0) {
    fp::mbar_init(q_full, 1);
    fp::mbar_init(q_empty, 4 * WGS);  // one arrival per consumer warp
    for (int s = 0; s < STAGES; ++s) {
      fp::mbar_init(&k_full[s], 1);
      fp::mbar_init(&v_full[s], 1);
      fp::mbar_init(&k_empty[s], 4 * WGS);
      fp::mbar_init(&v_empty[s], 4 * WGS);
    }
    fp::mbar_init_fence();
  }
  __syncthreads();

  // Work tile w: query tile w % qtiles of head (w / qtiles) % heads of image
  // w / (qtiles * heads); block i takes tiles i, i + gridDim.x, ...
  if (warp < 4) {  // the producer warpgroup
    fp::setmaxnreg_dec<A::PRODUCER_REGS>();
    if (warp == 0 && lane == 0) {
      Ring kr, vr;
      uint32_t qphase = 0;
      for (int w = blockIdx.x; w < tiles; w += gridDim.x, qphase ^= 1) {
        const int q0 = (w % qtiles) * BM, head = (w / qtiles) % heads, b = w / (qtiles * heads);
        auto load = [&](unsigned char* ring, uint64_t* full, uint64_t* empty, Ring& r, int col,
                        int tile) {
          fp::mbar_wait(&empty[r.stage], r.phase ^ 1);
          fp::mbar_expect_tx(&full[r.stage], A::TILE_BYTES);
          unsigned char* dst = ring + r.stage * A::TILE_BYTES;
          for (int c = 0; c < A::HALVES; ++c)
            fp::tma_load_3d(dst + c * BN * 128, &tm_kv, &full[r.stage], col + 64 * c, tile * BN, b);
          r.next(STAGES);
        };
        const int kcol = D + head * HD, vcol = 2 * D + head * HD;
        load(Ks, k_full, k_empty, kr, kcol, 0);  // the tile's first K, ahead of its Q
        // Q: 64-row boxes, once the consumers are done with the last tile's;
        // a box that starts past T is not loaded (its rows are never
        // stored). Rows past T inside a box read as zero.
        fp::mbar_wait(q_empty, qphase ^ 1);
        int boxes = 0;
        for (int r = 0; r < WGS; ++r) boxes += q0 + 64 * r < T;
        fp::mbar_expect_tx(q_full, boxes * A::HALVES * 64 * 128);
        for (int c = 0; c < A::HALVES; ++c)
          for (int r = 0; r < WGS; ++r)
            if (q0 + 64 * r < T)
              fp::tma_load_3d(Qs + c * BM * 128 + r * 8192, &tm_q, q_full, head * HD + 64 * c,
                              q0 + 64 * r, b);
        if (!CAPPED) {  // the first pass's K tiles, then K and V again
          for (int j = 1; j < ntiles; ++j) load(Ks, k_full, k_empty, kr, kcol, j);
          load(Ks, k_full, k_empty, kr, kcol, 0);
        }
        load(Vs, v_full, v_empty, vr, vcol, 0);
        for (int j = 1; j < ntiles; ++j) {
          load(Ks, k_full, k_empty, kr, kcol, j);
          load(Vs, v_full, v_empty, vr, vcol, j);
        }
      }
    }
  } else {  // the consumers
    fp::setmaxnreg_inc<A::CONSUMER_REGS>();
    const int wg = warp / 4 - 1, wl = warp % 4, g = lane / 4, t = lane % 4;
    Consumer<HD, CAPPED> c{Ks, Vs, k_full, k_empty, v_full, v_empty,
                           fp::wgmma_desc_sw128(Qs + wg * 8192), lane, t, seq_len};
    // Tiles of BN keys, then, if the last holds at most TN keys, a narrow one.
    const int full = seq_len - (ntiles - 1) * BN <= TN ? ntiles - 1 : ntiles;
    uint32_t qphase = 0;
    for (int w = blockIdx.x; w < tiles; w += gridDim.x, qphase ^= 1) {
      const int q0 = (w % qtiles) * BM, head = (w / qtiles) % heads, b = w / (qtiles * heads);
      c.m[0] = c.m[1] = -INFINITY;
      c.l[0] = c.l[1] = 0.f;
      // Q's buffer is free for the next tile once the last logits are done,
      // before the last value product and the stores.
      auto release_q = [&]() {
        if (lane == 0) fp::mbar_arrive(q_empty);
      };
      fp::mbar_wait(q_full, qphase);
      if (!CAPPED) {  // pass 1: the row max
#pragma unroll 1
        for (int j = 0; j < ntiles; ++j) c.row_max(j * BN);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          c.m[h] = fmaxf(c.m[h], __shfl_xor_sync(0xffffffffu, c.m[h], 1));
          c.m[h] = fmaxf(c.m[h], __shfl_xor_sync(0xffffffffu, c.m[h], 2));
        }
      }
      float o[HD / 2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
      if (full == 0) {
        uint32_t pt[TN / 4];
        c.template first<TN>(pt, 0);
        release_q();
        c.template last<TN>(o, pt);
      } else {
        uint32_t p[BN / 4];  // the weights of the tile whose value product is next
        c.template first<BN>(p, 0);
#pragma unroll 1
        for (int j = 1; j < full; ++j) {
          uint32_t pk[BN / 4];
          c.template step<BN, BN>(o, p, pk, j * BN);
#pragma unroll
          for (int q = 0; q < BN / 4; ++q) p[q] = pk[q];
        }
        if (full < ntiles) {
          uint32_t pt[TN / 4];
          c.template step<TN, BN>(o, p, pt, full * BN);
          release_q();
          c.template last<TN>(o, pt);
        } else {
          release_q();
          c.template last<BN>(o, p);
        }
      }

      // o[4j + 2h + e] is row g + 8h, column 8j + 2t + e.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float l = c.l[h];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float inv = 1.f / fmaxf(l, 1e-30f);
        const int row = q0 + 64 * wg + 16 * wl + g + 8 * h;
        if (row >= T) continue;
        bf16* dst = out + (static_cast<size_t>(b) * T + row) * D + head * HD + 2 * t;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<uint32_t*>(dst + 8 * j) =
              fp::pack_bf16(__fmul_rn(o[4 * j + 2 * h], inv), __fmul_rn(o[4 * j + 2 * h + 1], inv));
      }
    }
  }
}

template <int EPI>
int launch_gemm(const bf16* A, const bf16* W, const bf16* bias, bf16* C, int M, int N, int K,
                const bf16* resid, const bf16* ls, int scale_cols, float scale,
                cudaStream_t stream, Rope rope = Rope{nullptr, nullptr, 1, 0}) {
  // Once per process and instantiation: shared memory past 48 KB.
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(G_SMEM));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // SwiGLU: W holds 2N rows (gate, value), loaded as two boxes of TN rows.
  constexpr int TN = TILE_N<EPI>;
  const int w_rows = EPI == EPI_SWIGLU ? 2 * N : N;
  CUtensorMap tm_a, tm_w;
  int rc = fp::encode_tensor_map_2d(&tm_a, A, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, GM, GK,
                                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  rc = fp::encode_tensor_map_2d(&tm_w, W, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w_rows, K, TN, GK,
                                CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  const dim3 grid((N + TN - 1) / TN, (M + GM - 1) / GM);
  gemm_kernel<EPI><<<grid, G_THREADS, G_SMEM, stream>>>(tm_a, tm_w, bias, C, M, N, K, resid, ls,
                                                        scale_cols, scale, rope);
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
    FP_LN_CASE(13) FP_LN_CASE(14) FP_LN_CASE(15) FP_LN_CASE(16) FP_LN_CASE(17) FP_LN_CASE(18)
    FP_LN_CASE(19) FP_LN_CASE(20) FP_LN_CASE(21) FP_LN_CASE(22) FP_LN_CASE(23) FP_LN_CASE(24)
    FP_LN_CASE(25) FP_LN_CASE(26) FP_LN_CASE(27) FP_LN_CASE(28) FP_LN_CASE(29) FP_LN_CASE(30)
    FP_LN_CASE(31) FP_LN_CASE(32)
#undef FP_LN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return fp::launch_status();
}

template <int HD, bool CAPPED>
int launch_attention(const bf16* qkv, bf16* out, int batch, int T, int seq_len, int D, int heads,
                     cudaStream_t stream) {
  using A = Attn<HD>;
  // Once per process and instantiation: shared memory past 48 KB.
  static const cudaError_t attr =
      cudaFuncSetAttribute(attention_kernel<HD, CAPPED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(A::SMEM));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // [batch, T, 3D] as 3-D tensors, so that rows past T read as zero and never
  // as the next image's: Q in boxes of 64 rows, K and V of BN rows.
  CUtensorMap tm_q, tm_kv;
  int rc = fp::encode_tensor_map_3d(&tm_q, qkv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, batch, T,
                                    3 * D, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  rc = fp::encode_tensor_map_3d(&tm_kv, qkv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, batch, T, 3 * D,
                                A::BN, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  // Persistent: one block a SM (at most one a tile) walks the tiles.
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>((T + A::BM - 1) / A::BM) * heads * batch;
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  attention_kernel<HD, CAPPED><<<grid, A::THREADS, A::SMEM, stream>>>(tm_q, tm_kv, out, T, seq_len, D,
                                                                      heads, static_cast<int>(tiles));
  return fp::launch_status();
}

template <int HD>
int launch_attention(bool capped, const bf16* qkv, bf16* out, int batch, int T, int seq_len, int D,
                     int heads, cudaStream_t stream) {
  return capped ? launch_attention<HD, true>(qkv, out, batch, T, seq_len, D, heads, stream)
                : launch_attention<HD, false>(qkv, out, batch, T, seq_len, D, heads, stream);
}

}  // namespace

// x, out: [batch, tokens, dim] bf16. Weights bf16, nn.Linear layout; with
// swiglu set, fc1_w/fc1_b are w12 [2*hidden, dim] / [2*hidden] (gate rows
// first) and fc2_w/fc2_b are w3 [dim, hidden] / [dim], and gelu_tanh is not
// read. The five scratch buffers are [batch*tokens, dim] (xn, attn, x1),
// [.., 3*dim] (qkv) and [.., hidden] (h). Every pointer 16-byte aligned.
// head_dim is 64 or 128. rope_cos and rope_sin, when not null, are the
// rotary tables [tokens - rope_prefix, 64] f32 (head_dim 128 only): q and k
// of tokens at or past rope_prefix are rotated.
// Returns the first non-zero cudaGetLastError().
FP_EXPORT int fp_vit_block(
    const void* x, void* out, const void* n1w, const void* n1b,
    const void* qkv_w, const void* qkv_b, const void* proj_w,
    const void* proj_b, const void* ls1, const void* n2w, const void* n2b,
    const void* fc1_w, const void* fc1_b, const void* fc2_w, const void* fc2_b,
    const void* ls2, void* xn_buf, void* qkv_buf, void* attn_buf, void* x1_buf,
    void* h_buf, int batch, int tokens, int seq_len, int dim, int hidden,
    int num_heads, float eps, float q_scale, int gelu_tanh, int capped, int swiglu,
    int head_dim, const void* rope_cos, const void* rope_sin, int rope_prefix,
    void* stream_ptr) {
  const bool rope = rope_cos != nullptr;
  if ((head_dim != 64 && head_dim != 128) || dim != num_heads * head_dim ||
      dim > 4 * 32 * LN_MAX_CHUNKS || hidden % 8 != 0 || hidden < 8 || seq_len < 1 ||
      seq_len > tokens || batch < 1 || batch > 65535 || num_heads > 65535 ||
      (rope && (head_dim != 128 || rope_sin == nullptr || rope_prefix < 0 ||
                rope_prefix >= tokens)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int M = batch * tokens;
  auto B = [](const void* p) { return static_cast<const bf16*>(p); };
  auto Bm = [](void* p) { return static_cast<bf16*>(p); };
  int rc;
  if ((rc = launch_layernorm(B(x), B(n1w), B(n1b), Bm(xn_buf), M, dim, eps, stream))) return rc;
  if (rope)
    rc = launch_gemm<EPI_QKV_ROPE>(
        B(xn_buf), B(qkv_w), B(qkv_b), Bm(qkv_buf), M, 3 * dim, dim, nullptr, nullptr, dim, q_scale,
        stream,
        Rope{static_cast<const float*>(rope_cos), static_cast<const float*>(rope_sin), tokens,
             rope_prefix});
  else
    rc = launch_gemm<EPI_QKV>(B(xn_buf), B(qkv_w), B(qkv_b), Bm(qkv_buf), M, 3 * dim, dim, nullptr,
                              nullptr, dim, q_scale, stream);
  if (rc) return rc;
  rc = head_dim == 64
           ? launch_attention<64>(capped, B(qkv_buf), Bm(attn_buf), batch, tokens, seq_len, dim,
                                  num_heads, stream)
           : launch_attention<128>(capped, B(qkv_buf), Bm(attn_buf), batch, tokens, seq_len, dim,
                                   num_heads, stream);
  if (rc) return rc;
  if ((rc = launch_gemm<EPI_RESID>(B(attn_buf), B(proj_w), B(proj_b), Bm(x1_buf), M,
                                   dim, dim, B(x), B(ls1), 0, 1.f, stream)))
    return rc;
  if ((rc = launch_layernorm(B(x1_buf), B(n2w), B(n2b), Bm(xn_buf), M, dim, eps, stream))) return rc;
  if (swiglu)
    rc = launch_gemm<EPI_SWIGLU>(B(xn_buf), B(fc1_w), B(fc1_b), Bm(h_buf), M, hidden, dim,
                                 nullptr, nullptr, 0, 1.f, stream);
  else if (gelu_tanh)
    rc = launch_gemm<EPI_GELU_TANH>(B(xn_buf), B(fc1_w), B(fc1_b), Bm(h_buf), M, hidden, dim,
                                    nullptr, nullptr, 0, 1.f, stream);
  else
    rc = launch_gemm<EPI_GELU_ERF>(B(xn_buf), B(fc1_w), B(fc1_b), Bm(h_buf), M, hidden, dim,
                                   nullptr, nullptr, 0, 1.f, stream);
  if (rc) return rc;
  return launch_gemm<EPI_RESID>(B(h_buf), B(fc2_w), B(fc2_b), Bm(out), M, dim,
                                hidden, B(x1_buf), B(ls2), 0, 1.f, stream);
}
