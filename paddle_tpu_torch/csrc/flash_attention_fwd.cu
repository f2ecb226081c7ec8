// Flash-attention forward for Hopper (sm_90a), bf16 or f32 in and out,
// f32 accumulation. Returns O and the per-row log-sum-exp.
//
// Replaces: paddle_tpu/ops/pallas_attention.py `_fwd_kernel` (the
// non-varlen forward reached through `_flash_forward_x32` and
// `flash_attention_raw`).
//
// Layout: q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D], contiguous; o like q;
// lse f32 [B, Hq, Sq]. GQA is handled by indexing kv head h / (Hq / Hkv)
// here instead of materialising repeated K/V (flash_attention_raw repeats
// first; the result is the same). Causal masking aligns the last query
// row with the last key column (col <= row + Sk - Sq), as the TPU kernel
// does.
//
// What bounds it on the H100: a causal head does ~4*D*S*S/2 flops on
// 8*S*D bytes (bf16 Q, K, V, O), S/4 flops per byte, so the card's bound
// is its memory up to S ~ 1200 (the ridge is ~295 flop/byte) and its
// tensor-core rate above. This first version does its products with
// plain f32 FMAs on the CUDA cores, so the CUDA cores' FMA rate bounds
// it, far above either; moving QK^T and PV onto mma.sync/wgmma is the
// known next step.
//
// Design: one block of 128 threads per (64-row q tile, head, batch). The
// q tile is staged once in shared memory (pre-scaled by 1/sqrt(D)); the
// block loops over 64-row kv tiles, staging K, then V, through one shared
// buffer (two blocks fit on an SM). Each thread owns 4 rows x 8 score
// columns and 4 rows x D/8 output columns; the 8 threads of a row group are
// 8 adjacent lanes, so row max/sum reductions are three shuffles. The
// online softmax keeps running max, sum and the accumulator in f32
// registers. Tiles entirely above the causal diagonal are never loaded;
// the ragged tail and the diagonal are masked per element. Rows padded by
// 1 float keep the column-wise shared-memory reads free of bank conflicts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // kv rows per tile
constexpr int kThreads = 128;  // 16 row groups x 8 column lanes
constexpr int kMaxD = 128;
constexpr int kAccCols = kMaxD / 8;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

size_t smem_bytes(int d) {
  const int dp = d + 1;
  return sizeof(float) * (size_t)(kBQ * dp + kBK * dp + kBQ * (kBK + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int hq, int hkv, int sq, int sk,
                 int d, float scale, int causal) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  float* qs = smem;              // [kBQ][dp]
  float* kvs = qs + kBQ * dp;    // [kBK][dp]: K, then V, of the current tile
  float* ps = kvs + kBK * dp;    // [kBQ][kBK + 1]

  const int tid = threadIdx.x;
  const int ty = tid >> 3;  // row group: rows ty*4 .. ty*4+3 of the tile
  const int tx = tid & 7;   // column lane
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int off = sk - sq;

  const T* qb = q + (size_t)(b * hq + h) * sq * d;
  const T* kb = k + (size_t)(b * hkv + hk) * sk * d;
  const T* vb = v + (size_t)(b * hkv + hk) * sk * d;

  for (int i = tid; i < kBQ * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    const int row = q0 + r;
    qs[r * dp + c] = row < sq ? to_f32(qb[(size_t)row * d + c]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][kAccCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kAccCols; ++c) acc[i][c] = 0.f;
  }

  // kv columns any row of this tile can see
  int kv_end = sk;
  if (causal) kv_end = min(sk, q0 + kBQ + off);
  const int ntiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // previous tile's PV readers are done with kvs
    for (int i = tid; i < kBK * d; i += kThreads) {
      const int r = i / d, c = i - r * d;
      const int col = k0 + r;
      kvs[r * dp + c] = col < sk ? to_f32(kb[(size_t)col * d + c]) : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * dp + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = kvs[(tx + 8 * j) * dp + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      bool ok[8];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + tx + 8 * j;
        ok[j] = col < sk && (!causal || col <= row + off);
        if (!ok[j]) s[i][j] = kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float mn = fmaxf(m[i], mx);
      const float alpha = __expf(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // an all-masked row keeps mn == kNeg, where exp(s - mn) would be 1
        const float p = ok[j] ? __expf(s[i][j] - mn) : 0.f;
        ps[(ty * 4 + i) * (kBK + 1) + tx + 8 * j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      l[i] = l[i] * alpha + sum;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < kAccCols; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // every thread is done reading K
    for (int i = tid; i < kBK * d; i += kThreads) {
      const int r = i / d, c = i - r * d;
      const int col = k0 + r;
      kvs[r * dp + c] = col < sk ? to_f32(vb[(size_t)col * d + c]) : 0.f;
    }
    __syncthreads();

    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * (kBK + 1) + kk];
#pragma unroll
      for (int c = 0; c < kAccCols; ++c) {
        const int col = tx + 8 * c;
        if (col < d) {
          const float vv = kvs[kk * dp + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }

  T* ob = o + (size_t)(b * hq + h) * sq * d;
  float* lb = lse + (size_t)(b * hq + h) * sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
    const float inv = 1.f / li;
#pragma unroll
    for (int c = 0; c < kAccCols; ++c) {
      const int col = tx + 8 * c;
      if (col < d) ob[(size_t)row * d + col] = from_f32<T>(acc[i][c] * inv);
    }
    if (tx == 0) lb[row] = m[i] + logf(li);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int hq, int hkv, int sq, int sk, int d, int causal,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), hq, hkv, sq, sk, d, 1.0f / sqrtf((float)d),
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() (0 = ok);
// the caller has checked shapes, dtypes, contiguity and d <= 128.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int b,
                                   int hq, int hkv, int sq, int sk, int d,
                                   int causal, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b == 0 || sq == 0) return 0;
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, lse, b, hq, hkv, sq, sk, d,
                                 causal, st);
  return launch<float>(q, k, v, o, lse, b, hq, hkv, sq, sk, d, causal, st);
}
