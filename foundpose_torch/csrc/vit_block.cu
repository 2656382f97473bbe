// One pre-norm DINOv2 transformer block on Hopper, as four hand-written
// kernels launched in sequence by fp_vit_block:
//
//   LN1 -> GEMM(qkv, bias, q scaled) -> flash attention -> GEMM(proj, bias,
//   layer-scaled residual) -> LN2 -> GEMM(fc1, bias, GELU) -> GEMM(fc2, bias,
//   layer-scaled residual)
//
// Replaces: foundpose_tpu/ops/vit_block.py:_block_kernel (the Pallas kernel
// that runs the whole block for one image per grid step, with the image's
// activations and the layer's weights resident in VMEM).
//
// What bounds it on the H100: at ViT-S/14 with 905 tokens and batch 16 one
// layer is ~4.5 GFLOP per image (qkv 0.81, proj 0.27, fc1 1.08, fc2 1.08,
// attention 1.28), ~72 GFLOP per layer for the batch, against ~3.5 MB of bf16
// weights and ~11 MB of bf16 activations per pass: far above the card's
// ~295 FLOP/byte ridge, so the block is tensor-core bound.
//
// What the design does about it: the TPU kernel's one-grid-step-per-image
// form would give 16 blocks for 132 SMs, so the work is cut by output tile
// instead: the GEMMs run on the [B*T, D] token matrix in 128x128 tiles
// (~100-1300 blocks per GEMM), and attention runs one block per (image,
// head, 64-query tile) (1440 blocks), streaming 64-key tiles of K and V
// through shared memory so the [T, T] logits never reach device memory.
// Products run on the tensor cores through nvcuda::wmma (bf16 inputs, f32
// accumulation). LayerNorm statistics and the softmax run in f32. This is
// the simple first form: no wgmma, TMA or software pipelining yet.
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
#include "common.cuh"

namespace {

using namespace nvcuda;
using fp::bf2f;
using fp::f2bf;

// ---------------------------------------------------------------------------
// LayerNorm: one warp per token row; statistics in f32, output bf16.
// ---------------------------------------------------------------------------
__global__ void layernorm_kernel(const bf16* __restrict__ x,
                                 const bf16* __restrict__ w,
                                 const bf16* __restrict__ b,
                                 bf16* __restrict__ out, int rows, int d,
                                 float eps) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const bf16* xr = x + static_cast<size_t>(row) * d;
  bf16* orow = out + static_cast<size_t>(row) * d;
  float s = 0.f;
  for (int i = lane; i < d; i += 32) s += bf2f(xr[i]);
  const float mean = fp::warp_sum(s) / d;
  float v = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float t = bf2f(xr[i]) - mean;
    v += t * t;
  }
  const float var = fp::warp_sum(v) / d;
  const float rstd = rsqrtf(var + eps);
  for (int i = lane; i < d; i += 32) {
    const float n = (bf2f(xr[i]) - mean) * rstd;
    orow[i] = f2bf(__fadd_rn(__fmul_rn(n, bf2f(w[i])), bf2f(b[i])));
  }
}

// ---------------------------------------------------------------------------
// GEMM: C[M, N] = A[M, K] . W[N, K]^T (W in nn.Linear layout) + epilogue.
// 128x128 output tile per block, 8 warps in a 4x2 grid, each warp 32x64.
// ---------------------------------------------------------------------------
constexpr int GM = 128, GN = 128, GK = 32, GLD = GK + 8, GTHREADS = 256;

enum Epilogue { EPI_QKV = 0, EPI_GELU_TANH = 1, EPI_GELU_ERF = 2, EPI_RESID = 3 };

__device__ __forceinline__ float gelu_tanh(float x) {
  // jax.nn.gelu(approximate=True)
  const float inner = 0.7978845608028654f * (x + 0.044715f * (x * x * x));
  return x * (0.5f * (1.f + tanhf(inner)));
}

__device__ __forceinline__ float gelu_erf(float x) {
  // jax.nn.gelu(approximate=False)
  return __fmul_rn(__fmul_rn(0.5f, x), erfcf(__fmul_rn(-x, 0.70710678118654752f)));
}

template <int EPI>
__global__ void __launch_bounds__(GTHREADS)
    gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                const bf16* __restrict__ bias, bf16* __restrict__ C, int M,
                int N, int K, const bf16* __restrict__ resid,
                const bf16* __restrict__ ls, int scale_cols, float scale) {
  __shared__ __align__(128) bf16 As[GM * GLD];
  __shared__ __align__(128) bf16 Ws[GN * GLD];
  __shared__ __align__(128) float scratch[GTHREADS / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  const int wm = warp >> 1, wn = warp & 1;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += GK) {
    // 128 rows x 32 columns of each operand = 512 16-byte chunks.
    for (int c = tid; c < GM * GK / 8; c += GTHREADS) {
      const int r = c >> 2, col = (c & 3) * 8;
      uint4 va = make_uint4(0, 0, 0, 0), vw = make_uint4(0, 0, 0, 0);
      if (m0 + r < M)
        va = *reinterpret_cast<const uint4*>(
            A + static_cast<size_t>(m0 + r) * K + k0 + col);
      if (n0 + r < N)
        vw = *reinterpret_cast<const uint4*>(
            W + static_cast<size_t>(n0 + r) * K + k0 + col);
      *reinterpret_cast<uint4*>(As + r * GLD + col) = va;
      *reinterpret_cast<uint4*>(Ws + r * GLD + col) = vw;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * GLD + kk, GLD);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(b[j], Ws + (wn * 64 + j * 16) * GLD + kk, GLD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* sc = scratch[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = m0 + wm * 32 + i * 16 + (e >> 4);
        const int n = n0 + wn * 64 + j * 16 + (e & 15);
        if (m < M && n < N) {
          const size_t o = static_cast<size_t>(m) * N + n;
          float v = __fadd_rn(sc[e], bf2f(bias[n]));
          if (EPI == EPI_QKV) {
            if (n < scale_cols) v = __fmul_rn(v, scale);
            C[o] = f2bf(v);
          } else if (EPI == EPI_GELU_TANH) {
            C[o] = f2bf(gelu_tanh(v));
          } else if (EPI == EPI_GELU_ERF) {
            C[o] = f2bf(gelu_erf(v));
          } else {
            const float y = bf2f(f2bf(v));
            const float t = bf2f(f2bf(__fmul_rn(bf2f(ls[n]), y)));
            C[o] = f2bf(__fadd_rn(bf2f(resid[o]), t));
          }
        }
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// Attention over the qkv buffer [B, T, 3D] (q pre-scaled by log2(e)/sqrt(hd)).
// One block per (64-query tile, head, image); 4 warps, 16 query rows each.
// ---------------------------------------------------------------------------
constexpr int AQ = 64, AK = 64, HD = 64, ALD = HD + 8, SLD = AK + 4, ATHREADS = 128;
constexpr size_t ATT_SMEM =
    3 * fp::align128(sizeof(bf16) * AQ * ALD) +
    fp::align128(sizeof(float) * (ATHREADS / 32) * 16 * SLD) +
    fp::align128(sizeof(bf16) * (ATHREADS / 32) * 16 * ALD);

template <bool CAPPED>
__global__ void __launch_bounds__(ATHREADS)
    attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                     int T, int seq_len, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + AQ * ALD;
  bf16* Vs = Ks + AK * ALD;
  float* Ss = reinterpret_cast<float*>(Vs + AK * ALD);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + (ATHREADS / 32) * 16 * SLD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * AQ, h = blockIdx.y, b = blockIdx.z;
  const size_t rs = 3 * static_cast<size_t>(D);
  const bf16* base = qkv + static_cast<size_t>(b) * T * rs;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int c = tid; c < AQ * HD / 8; c += ATHREADS) {
    const int r = c >> 3, col = (c & 7) * 8, t = q0 + r;
    uint4 v = zero;
    if (t < T)
      v = *reinterpret_cast<const uint4*>(base + t * rs + h * HD + col);
    *reinterpret_cast<uint4*>(Qs + r * ALD + col) = v;
  }
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[HD / 16];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wmma::load_matrix_sync(qa[kk], Qs + warp * 16 * ALD + kk * 16, ALD);

  float* S = Ss + warp * 16 * SLD;
  bf16* P = Ps + warp * 16 * ALD;
  // Each lane owns half of one of the warp's 16 rows: row r, 32 columns.
  const int r = lane >> 1, c0 = (lane & 1) * 32;

  auto load_tile = [&](int k0, bool with_v) {
    __syncthreads();  // the previous tile is fully consumed
    for (int c = tid; c < AK * HD / 8; c += ATHREADS) {
      const int rr = c >> 3, col = (c & 7) * 8, t = k0 + rr;
      uint4 kv = zero, vv = zero;
      if (t < T) {
        kv = *reinterpret_cast<const uint4*>(base + t * rs + D + h * HD + col);
        if (with_v)
          vv = *reinterpret_cast<const uint4*>(base + t * rs + 2 * D + h * HD + col);
      }
      *reinterpret_cast<uint4*>(Ks + rr * ALD + col) = kv;
      if (with_v) *reinterpret_cast<uint4*>(Vs + rr * ALD + col) = vv;
    }
    __syncthreads();
  };
  auto logits = [&]() {  // S = Q K^T for this warp's 16 rows
#pragma unroll
    for (int j = 0; j < AK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, Ks + j * 16 * ALD + kk * 16, ALD);
        wmma::mma_sync(s, qa[kk], kb, s);
      }
      wmma::store_matrix_sync(S + j * 16, s, SLD, wmma::mem_row_major);
    }
    __syncwarp();
  };

  float row_max = -INFINITY;
  if (!CAPPED) {
    for (int k0 = 0; k0 < seq_len; k0 += AK) {
      load_tile(k0, false);
      logits();
      for (int c = c0; c < c0 + 32; ++c)
        if (k0 + c < seq_len) row_max = fmaxf(row_max, S[r * SLD + c]);
      __syncwarp();
    }
    row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[HD / 16];
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) wmma::fill_fragment(o[j], 0.f);
  float row_sum = 0.f;
  for (int k0 = 0; k0 < seq_len; k0 += AK) {
    load_tile(k0, true);
    logits();
    for (int c = c0; c < c0 + 32; ++c) {
      float p = 0.f;
      if (k0 + c < seq_len) {
        const float l = S[r * SLD + c];
        p = CAPPED ? fminf(exp2f(l), 1e30f) : exp2f(__fsub_rn(l, row_max));
      }
      const bf16 pb = f2bf(p);
      row_sum += bf2f(pb);
      P[r * ALD + c] = pb;
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < AK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
      wmma::load_matrix_sync(pa, P + kk * 16, ALD);
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, Vs + kk * 16 * ALD + j * 16, ALD);
        wmma::mma_sync(o[j], pa, vb, o[j]);
      }
    }
    __syncwarp();
  }
  row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
#pragma unroll
  for (int j = 0; j < HD / 16; ++j)
    wmma::store_matrix_sync(S + j * 16, o[j], SLD, wmma::mem_row_major);
  __syncwarp();
  const float inv = 1.f / fmaxf(row_sum, 1e-30f);
  const int t = q0 + warp * 16 + r;
  if (t < T) {
    bf16* dst = out + (static_cast<size_t>(b) * T + t) * D + h * HD;
    for (int c = c0; c < c0 + 32; ++c) dst[c] = f2bf(__fmul_rn(S[r * SLD + c], inv));
  }
}

template <int EPI>
int launch_gemm(const bf16* A, const bf16* W, const bf16* bias, bf16* C, int M,
                int N, int K, const bf16* resid, const bf16* ls,
                int scale_cols, float scale, cudaStream_t stream) {
  const dim3 grid((N + GN - 1) / GN, (M + GM - 1) / GM);
  gemm_kernel<EPI><<<grid, GTHREADS, 0, stream>>>(A, W, bias, C, M, N, K, resid,
                                                   ls, scale_cols, scale);
  return fp::launch_status();
}

int launch_layernorm(const bf16* x, const bf16* w, const bf16* b, bf16* out,
                     int rows, int d, float eps, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  layernorm_kernel<<<blocks, kThreads, 0, stream>>>(x, w, b, out, rows, d, eps);
  return fp::launch_status();
}

template <bool CAPPED>
int launch_attention(const bf16* qkv, bf16* out, int batch, int T, int seq_len,
                     int D, int heads, cudaStream_t stream) {
  cudaFuncSetAttribute(attention_kernel<CAPPED>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(ATT_SMEM));
  const dim3 grid((T + AQ - 1) / AQ, heads, batch);
  attention_kernel<CAPPED><<<grid, ATHREADS, ATT_SMEM, stream>>>(qkv, out, T,
                                                                 seq_len, D);
  return fp::launch_status();
}

}  // namespace

// x, out: [batch, tokens, dim] bf16. Weights bf16, nn.Linear layout. The five
// scratch buffers are [batch*tokens, dim] (xn, attn, x1), [.., 3*dim] (qkv)
// and [.., hidden] (h). Returns the first non-zero cudaGetLastError().
FP_EXPORT int fp_vit_block(
    const void* x, void* out, const void* n1w, const void* n1b,
    const void* qkv_w, const void* qkv_b, const void* proj_w,
    const void* proj_b, const void* ls1, const void* n2w, const void* n2b,
    const void* fc1_w, const void* fc1_b, const void* fc2_w, const void* fc2_b,
    const void* ls2, void* xn_buf, void* qkv_buf, void* attn_buf, void* x1_buf,
    void* h_buf, int batch, int tokens, int seq_len, int dim, int hidden,
    int num_heads, float eps, float q_scale, int gelu_tanh, int capped,
    void* stream_ptr) {
  if (dim != num_heads * HD || dim % GK != 0 || hidden % GK != 0 ||
      seq_len < 1 || seq_len > tokens)
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
