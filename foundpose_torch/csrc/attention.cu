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
// The normalizer divides p BEFORE the value product, as the TPU kernel does
// (unlike csrc/vit_block.cu, which multiplies by 1/s afterwards).
//
// What bounds it on the H100: at the unfused ViT-S path (16 crops x 6
// heads, 905 tokens, Dh 64) one layer is 2 x 96 x 905^2 x 64 x 2 = 20.1
// GFLOP on 89 MB of f32 q, k, v and output. In f32, which the exact
// configuration runs, the tensor cores are off limits (TF32 would round
// the inputs to 10 mantissa bits), so the bound is the 67 TFLOP/s of f32
// FMA: ~0.30 ms. In bf16 the tensor cores bound it at ~20 us.
//
// What the design does about it: one block per (32-query tile, b * h)
// keeps that tile's [32, T] f32 logits in shared memory (~131 KB at T =
// 905), so the exact max-subtracted softmax is formed in one pass over the
// keys, the weights are normalized before the value product as the
// contract demands, and no [T, T] tensor reaches device memory. K and then
// V stream through shared memory in tiles. f32: SIMT FMA, each thread a
// 4 x 4 (logits) or 2 x 4 (output) register tile fed by float4 shared
// loads. bf16: nvcuda::wmma 16x16x16 with f32 accumulation. T needs no
// padding: staged rows past T (or keys past seq_len) are zero, and output
// rows past T are never written. This is the simple first form: one block
// per SM fits at these sizes, and nothing overlaps loads with math.
#include <math.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int BQ = 32;  // query rows per block
constexpr int DH = 64;  // head dim
constexpr int BK_F32 = 128, F32_THREADS = 256, LDF = DH + 4;
constexpr int BK_BF = 64, BF_THREADS = 128, LDH = DH + 8, LDO = DH + 4;
constexpr size_t MAX_SMEM = 232448;  // dynamic shared memory a block may use

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void store_weight(float* p, float w) { *p = w; }
__device__ __forceinline__ void store_weight(bf16* p, float w) { *p = fp::f2bf(w); }

// Softmax of the resident logits S [BQ, lds], one warp per row: keys
// < seq_len give w = exp(l - max) / sum, keys in [seq_len, kv_pad) give 0.
// W may alias S (f32): each lane reads and writes only its own entries.
template <typename W>
__device__ void softmax_rows(float* S, int lds, W* Wt, int ldw, int seq_len, int kv_pad) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x / 32;
  for (int r = threadIdx.x / 32; r < BQ; r += nwarps) {
    float* row = S + static_cast<size_t>(r) * lds;
    float m = -INFINITY;
    for (int j = lane; j < seq_len; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < seq_len; j += 32) {
      const float p = expf(row[j] - m);
      row[j] = p;
      s += p;
    }
    s = fp::warp_sum(s);
    W* wrow = Wt + static_cast<size_t>(r) * ldw;
    for (int j = lane; j < kv_pad; j += 32) store_weight(wrow + j, j < seq_len ? row[j] / s : 0.f);
  }
}

// Stages rows [r0, r0 + rows) of a [*, DH] matrix into smem with leading
// dimension ld; rows at or past `limit` are zero. VEC elements per load.
template <typename T, typename V>
__device__ void stage_rows(const T* __restrict__ src, T* dst, int ld, int r0, int rows, int limit) {
  constexpr int VEC = sizeof(V) / sizeof(T);
  for (int i = threadIdx.x; i < rows * DH / VEC; i += blockDim.x) {
    const int r = i / (DH / VEC), c = (i % (DH / VEC)) * VEC;
    V val = {};
    if (r0 + r < limit) val = *reinterpret_cast<const V*>(src + static_cast<size_t>(r0 + r) * DH + c);
    *reinterpret_cast<V*>(dst + r * ld + c) = val;
  }
}

// ---------------------------------------------------------------------------
// f32: SIMT FMA.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(F32_THREADS)
    attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out, int T,
                         int seq_len, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lds = round_up(T, BK_F32) + 1;
  const int kv_pad = round_up(seq_len, BK_F32);
  float* Qs = reinterpret_cast<float*>(smem);                       // [BQ][LDF]
  float* KV = Qs + fp::align128(BQ * LDF * 4) / 4;                   // [BK_F32][LDF]
  float* S = KV + fp::align128(BK_F32 * LDF * 4) / 4;                // [BQ][lds]
  const size_t base = static_cast<size_t>(blockIdx.y) * T * DH;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  stage_rows<float, float4>(q + base, Qs, LDF, q0, BQ, T);

  // Logits: thread -> rows tr + 8a (a < 4) x keys tc + 32i (i < 4).
  const int tr = tid / 32, tc = tid % 32;
  for (int k0 = 0; k0 < seq_len; k0 += BK_F32) {
    __syncthreads();
    stage_rows<float, float4>(k + base, KV, LDF, k0, BK_F32, seq_len);
    __syncthreads();
    float acc[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = *reinterpret_cast<const float4*>(Qs + (tr + 8 * a) * LDF + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) kb[i] = *reinterpret_cast<const float4*>(KV + (tc + 32 * i) * LDF + d);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float s = acc[a][i];
          s = fmaf(qa[a].x, kb[i].x, s);
          s = fmaf(qa[a].y, kb[i].y, s);
          s = fmaf(qa[a].z, kb[i].z, s);
          acc[a][i] = fmaf(qa[a].w, kb[i].w, s);
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int i = 0; i < 4; ++i) S[(tr + 8 * a) * lds + k0 + tc + 32 * i] = acc[a][i] * scale;
  }
  __syncthreads();
  softmax_rows<float>(S, lds, S, lds, seq_len, kv_pad);

  // Output: thread -> rows orow, orow + 16 x dims oc .. oc + 3.
  const int orow = tid / 16, oc = (tid % 16) * 4;
  float4 o[2] = {};
  for (int k0 = 0; k0 < seq_len; k0 += BK_F32) {
    __syncthreads();
    stage_rows<float, float4>(v + base, KV, LDF, k0, BK_F32, seq_len);
    __syncthreads();
    const int kn = min(BK_F32, seq_len - k0);
    for (int j = 0; j < kn; ++j) {
      const float4 vv = *reinterpret_cast<const float4*>(KV + j * LDF + oc);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float w = S[(orow + 16 * a) * lds + k0 + j];
        o[a].x = fmaf(w, vv.x, o[a].x);
        o[a].y = fmaf(w, vv.y, o[a].y);
        o[a].z = fmaf(w, vv.z, o[a].z);
        o[a].w = fmaf(w, vv.w, o[a].w);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int row = q0 + orow + 16 * a;
    if (row < T) *reinterpret_cast<float4*>(out + base + static_cast<size_t>(row) * DH + oc) = o[a];
  }
}

// ---------------------------------------------------------------------------
// bf16: wmma with f32 accumulation. 4 warps; warp w owns rows 16 * (w / 2)
// and two 16-wide column blocks (w % 2) * 2 + {0, 1} of every 32 x 64 tile.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(BF_THREADS)
    attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ out, int T,
                          int seq_len, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int t_alloc = round_up(T, BK_BF);
  const int lds = t_alloc + 4, ldw = t_alloc + 8;
  const int kv_pad = round_up(seq_len, BK_BF);
  bf16* Qs = reinterpret_cast<bf16*>(smem);                                   // [BQ][LDH]
  bf16* KV = Qs + fp::align128(BQ * LDH * 2) / 2;                              // [BK_BF][LDH]
  float* S = reinterpret_cast<float*>(KV + fp::align128(BK_BF * LDH * 2) / 2);  // [BQ][lds]
  bf16* Wt = reinterpret_cast<bf16*>(S + fp::align128(BQ * lds * 4) / 4);       // [BQ][ldw]
  float* Os = reinterpret_cast<float*>(Wt + fp::align128(BQ * ldw * 2) / 2);    // [BQ][LDO]
  const size_t base = static_cast<size_t>(blockIdx.y) * T * DH;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int rb = (warp / 2) * 16, cb = (warp % 2) * 32;
  stage_rows<bf16, uint4>(q + base, Qs, LDH, q0, BQ, T);

  for (int k0 = 0; k0 < seq_len; k0 += BK_BF) {
    __syncthreads();
    stage_rows<bf16, uint4>(k + base, KV, LDH, k0, BK_BF, seq_len);
    __syncthreads();
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2];
    wmma::fill_fragment(c[0], 0.f);
    wmma::fill_fragment(c[1], 0.f);
#pragma unroll
    for (int kk = 0; kk < DH; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Qs + rb * LDH + kk, LDH);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // B = K^T: element (d, key) sits at KV[key * LDH + d], column major.
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, KV + (cb + 16 * j) * LDH + kk, LDH);
        wmma::mma_sync(c[j], a, b, c[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      for (int e = 0; e < c[j].num_elements; ++e) c[j].x[e] *= scale;
      wmma::store_matrix_sync(S + rb * lds + k0 + cb + 16 * j, c[j], lds, wmma::mem_row_major);
    }
  }
  __syncthreads();
  softmax_rows<bf16>(S, lds, Wt, ldw, seq_len, kv_pad);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[2];
  wmma::fill_fragment(o[0], 0.f);
  wmma::fill_fragment(o[1], 0.f);
  for (int k0 = 0; k0 < seq_len; k0 += BK_BF) {
    __syncthreads();
    stage_rows<bf16, uint4>(v + base, KV, LDH, k0, BK_BF, seq_len);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK_BF; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Wt + rb * ldw + k0 + kk, ldw);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, KV + kk * LDH + cb + 16 * j, LDH);
        wmma::mma_sync(o[j], a, b, o[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(Os + rb * LDO + cb + 16 * j, o[j], LDO, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < BQ * DH; i += blockDim.x) {
    const int r = i / DH, c = i % DH;
    if (q0 + r < T) out[base + static_cast<size_t>(q0 + r) * DH + c] = fp::f2bf(Os[r * LDO + c]);
  }
}

size_t attention_smem_bytes(int T, bool bf) {
  if (!bf) {
    const int lds = round_up(T, BK_F32) + 1;
    return fp::align128(BQ * LDF * 4) + fp::align128(BK_F32 * LDF * 4) +
           fp::align128(static_cast<size_t>(BQ) * lds * 4);
  }
  const int t_alloc = round_up(T, BK_BF);
  return fp::align128(BQ * LDH * 2) + fp::align128(BK_BF * LDH * 2) +
         fp::align128(static_cast<size_t>(BQ) * (t_alloc + 4) * 4) +
         fp::align128(static_cast<size_t>(BQ) * (t_alloc + 8) * 2) + fp::align128(BQ * LDO * 4);
}

}  // namespace

// q, k, v, out [bh, T, head_dim] contiguous, f32 (is_bf16 = 0) or bf16.
FP_EXPORT int fp_attention(const void* q, const void* k, const void* v, void* out, int bh,
                           int T, int seq_len, int head_dim, int is_bf16, float scale,
                           void* stream_ptr) {
  if (bh < 1 || T < 1 || seq_len < 1 || seq_len > T || head_dim != DH)
    return static_cast<int>(cudaErrorInvalidValue);
  // The resident logits bound T: 1408 in f32, 1088 in bf16 (227 KB a block).
  const size_t smem = attention_smem_bytes(T, is_bf16 != 0);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + BQ - 1) / BQ, bh);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (is_bf16) {
    cudaFuncSetAttribute(attention_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    attention_bf16_kernel<<<grid, BF_THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(out), T, seq_len, scale);
  } else {
    cudaFuncSetAttribute(attention_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    attention_f32_kernel<<<grid, F32_THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(out), T, seq_len, scale);
  }
  return fp::launch_status();
}
