// The CUDA-core flash-attention tile bodies shared by K1/K1v
// (flash_attention_fwd.cu), K2/K2v (flash_attention_bwd.cu) and K9
// (flashmask_attention.cu): the forward, the dQ kernel and the dK/dV
// kernel, each a template over the element type, a mask policy and the
// largest head dim it takes (DM = 128 or 256: the accumulators are sized
// by it, so the d <= 128 instantiations keep their registers). They run
// f32 and f16 inputs at every head dim and bf16 at head dims above 128;
// bf16 at padded d <= 128 runs the tensor-core bodies of
// flash_attention_tc.cuh over the same mask policies (K1, K1v, K2, K2v,
// K9). The source files that include this header
// hold what each kernel replaces, what bounds it on the H100, and its C
// entry points.
//
// Tiling (all three kernels). 64-row q tiles and 64-row kv tiles, f32 in
// shared memory (rows padded by 1 float so column-wise reads are free of
// bank conflicts), products as plain f32 FMAs on the CUDA cores, f32
// online softmax. Blocks run in parallel with no order, so the TPU's
// sequential grid with VMEM scratch carried across steps becomes a loop
// inside each block:
//  * forward: one block of 128 threads per (q tile, q head, batch); the q
//    tile (pre-scaled by 1/sqrt(D)) stays in shared memory, the block loops
//    over kv tiles, staging K, then V, through one buffer. Each thread owns
//    4 rows x 8 score columns (columns tx + 8j) and 4 rows x D/8 output
//    columns; the 8 lanes of a row group are adjacent, so row max/sum
//    reductions are three shuffles. At d 256 it holds 148 KB of shared
//    memory;
//  * dQ: one block of 256 threads per (q tile, q head, batch); Q and dO stay
//    in shared memory; per kv tile it stages V (dP = dO V^T), then K (S =
//    Q K^T, then dQ += dS K), dS passing through shared memory (214 KB at
//    d 256);
//  * dK/dV: one block of 256 threads per (kv tile, kv head, batch); K and V
//    stay in shared memory; the block loops over the q heads of its GQA
//    group and the q tiles that can see the tile, and keeps dK and dV in
//    registers, so the group's sum needs no atomics and results repeat
//    from run to run. At DM 256 each 64-row q tile the mask visits is
//    staged as two 32-row halves (QR = 32): 64 rows of Q and dO beside K
//    and V would take 297 KB of shared memory, two halves take 215 KB.
// With P = exp(S * scale - lse): dS = P * (dO V^T - delta), dQ = dS K
// scale, dV = P^T dO, dK = dS^T (Q scale).
//
// The mask policy (`Mask`) decides which kv tiles a q tile visits, which
// q tiles a kv tile visits, and per tile one of three kinds:
//   kSkip   - no element visible: never loaded;
//   kFull   - every element visible and in range: no per-element mask;
//   kMasked - straddling: each element asks `visible(row, col, info)`,
//             where `info` is the policy's per-column datum (`col_info`).
// Masked probabilities are zeroed, not exponentiated against a mask
// value: a row that sees no key has lse = -1e30, which would cancel it.
// Such a row gets O = 0 and lse = -1e30; a kv row no q row sees gets
// dK = dV = 0 (its accumulators start at 0 and every tile is skipped).
// A call with no keys or no queries launches no body at all: the entries
// write those results with `fill_empty` / `zero_fill` below.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;   // query rows per tile
constexpr int kBK = 64;   // kv rows per tile
constexpr float kNeg = -1e30f;
constexpr int kFwdThreads = 128;  // 16 row groups x 8 column lanes
constexpr int kBwdThreads = 256;  // 16 row groups x 16 column lanes
// the largest head dim of each instantiation: DM 128 up to 128, 256 above
constexpr int kSmallD = 128;
constexpr int kLargeD = 256;

enum TileKind { kSkip = 0, kFull = 1, kMasked = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// the entries' dtype codes: 0 = float32, 1 = bfloat16, 2 = float16
enum ElemCode { kCodeF32 = 0, kCodeBF16 = 1, kCodeF16 = 2 };
inline size_t elem_bytes(int dtype) { return dtype == kCodeF32 ? 4 : 2; }

// ------------------------------------------------------------ mask policies

// K1/K2 (kv_lens null) and K1v/K2v: key column `col` is visible from query
// row `row` when col < len (kv_lens[b], clamped to [0, Sk]; Sk when null)
// and, causal, col <= row + Sk - Sq (the last query row aligned with the
// last key column). As the reference's `_block_dispatch`: a tile past the
// length or wholly above the diagonal is skipped; without kv_lens a tile
// wholly in range and below the diagonal is full; with kv_lens every
// visited tile masks per element (the reference's force_masked=has_lens).
struct LenCausalMask {
  struct Args {
    const int* kv_lens;
    int causal;
  };
  int len, sq, off, causal, forced;
  __device__ LenCausalMask(const Args& a, int b, int /*h*/, int /*hq*/,
                           int sq_, int sk)
      : len(a.kv_lens ? min(max(a.kv_lens[b], 0), sk) : sk),
        sq(sq_),
        off(sk - sq_),
        causal(a.causal),
        forced(a.kv_lens != nullptr) {}
  // one past the last key column any row of the q tile at q0 can see
  __device__ int kv_end(int q0) const {
    return causal ? min(len, q0 + kBQ + off) : len;
  }
  // the q tiles [first, end) that can see the kv tile at k0
  __device__ int q_first(int k0) const {
    return causal ? max(0, k0 - off) / kBQ : 0;
  }
  __device__ int q_end(int k0, int nqt) const { return k0 < len ? nqt : 0; }
  __device__ int kind(int q0, int k0) const {
    if (k0 >= kv_end(q0)) return kSkip;
    if (forced) return kMasked;
    const bool full = q0 + kBQ <= sq && k0 + kBK <= len &&
                      (!causal || k0 + kBK - 1 <= q0 + off);
    return full ? kFull : kMasked;
  }
  __device__ int col_info(int /*col*/) const { return 0; }
  __device__ bool visible(int row, int col, int /*info*/) const {
    return col < len && (!causal || col <= row + off);
  }
};

// K9, FlashMask (causal LTS form): key column j is hidden from query rows
// i >= start[b, h, j] (and, causal, above the diagonal); a column past Sk
// reads start 0, hidden from every row. smin / smax [B, H, ceil(Sk/64)]
// are each kv tile's least start row over its in-range columns and its
// greatest over all of them (padded columns count as 0), computed by the
// wrapper. The reference's three-way dispatch (`_fm_block_dispatch`):
// a tile is skipped when its first row is at or past smax, or it lies
// wholly above the diagonal; it is full when its last row precedes smin
// and it is wholly in range and below the diagonal; else it masks.
struct StartRowMask {
  struct Args {
    const int* start;
    const int* smin;
    const int* smax;
    int causal;
  };
  const int* st;
  const int* tmin;
  const int* tmax;
  int sq, sk, off, causal;
  __device__ StartRowMask(const Args& a, int b, int h, int hq, int sq_,
                          int sk_)
      : sq(sq_), sk(sk_), off(sk_ - sq_), causal(a.causal) {
    const size_t bh = (size_t)b * hq + h;
    const int nk = (sk_ + kBK - 1) / kBK;
    st = a.start + bh * sk_;
    tmin = a.smin + bh * nk;
    tmax = a.smax + bh * nk;
  }
  __device__ int kv_end(int q0) const {
    return causal ? min(sk, q0 + kBQ + off) : sk;
  }
  __device__ int q_first(int k0) const {
    return causal ? max(0, k0 - off) / kBQ : 0;
  }
  // rows at or past the tile's greatest start row see none of it
  __device__ int q_end(int k0, int nqt) const {
    return min(nqt, (tmax[k0 / kBK] + kBQ - 1) / kBQ);
  }
  __device__ int kind(int q0, int k0) const {
    const int t = k0 / kBK;
    const int row1 = q0 + kBQ - 1, col1 = k0 + kBK - 1;
    if (q0 >= tmax[t]) return kSkip;
    if (causal && k0 > row1 + off) return kSkip;
    const bool full = row1 < tmin[t] && row1 < sq && col1 < sk &&
                      (!causal || col1 <= q0 + off);
    return full ? kFull : kMasked;
  }
  __device__ int col_info(int col) const { return col < sk ? st[col] : 0; }
  __device__ bool visible(int row, int col, int start) const {
    return row < start && (!causal || col <= row + off);
  }
};

// ------------------------------------------------------------------ forward

size_t fwd_smem_bytes(int d) {
  const int dp = d + 1;
  return sizeof(float) * (size_t)(kBQ * dp + kBK * dp + kBQ * (kBK + 1));
}

template <typename T, typename Mask, int DM>
__global__ void __launch_bounds__(kFwdThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, T* __restrict__ o_res,
                 typename Mask::Args margs, int hq, int hkv, int sq, int sk,
                 int d, float scale) {
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
  const Mask mask(margs, b, h, hq, sq, sk);

  const T* qb = q + (size_t)(b * hq + h) * sq * d;
  const T* kb = k + (size_t)(b * hkv + hk) * sk * d;
  const T* vb = v + (size_t)(b * hkv + hk) * sk * d;

  for (int i = tid; i < kBQ * d; i += kFwdThreads) {
    const int r = i / d, c = i - r * d;
    const int row = q0 + r;
    qs[r * dp + c] = row < sq ? to_f32(qb[(size_t)row * d + c]) * scale : 0.f;
  }

  constexpr int kAccCols = DM / 8;
  float m[4], l[4], acc[4][kAccCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kAccCols; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = mask.kv_end(q0);
  const int ntiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kBK;
    const int kind = mask.kind(q0, k0);  // uniform over the block
    if (kind == kSkip) continue;
    int info[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      info[j] = kind == kMasked ? mask.col_info(k0 + tx + 8 * j) : 0;
    __syncthreads();  // previous tile's PV readers are done with kvs
    for (int i = tid; i < kBK * d; i += kFwdThreads) {
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
        ok[j] = kind == kFull || mask.visible(row, col, info[j]);
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
    for (int i = tid; i < kBK * d; i += kFwdThreads) {
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
  T* rb = o_res == nullptr ? nullptr : o_res + (size_t)(b * hq + h) * sq * d;
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
      if (col < d) {
        const float f = acc[i][c] * inv;
        const T rounded = from_f32<T>(f);
        ob[(size_t)row * d + col] = rounded;
        // what rounding O to T dropped (0 in f32)
        if (rb != nullptr)
          rb[(size_t)row * d + col] = from_f32<T>(f - to_f32(rounded));
      }
    }
    if (tx == 0) lb[row] = m[i] + logf(li);
  }
}

template <typename T, typename Mask, int DM>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, void* o_res, typename Mask::Args margs, int b,
               int hq, int hkv, int sq, int sk, int d, float scale,
               cudaStream_t stream) {
  if (d > DM) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, Mask, DM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_fwd_kernel<T, Mask, DM><<<grid, kFwdThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), static_cast<T*>(o_res), margs, hq, hkv, sq,
      sk, d, scale);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- backward

// rows [r0, r0 + kRows) of a [rows, d] matrix into shared [kRows][d + 1]
// f32, times `mul`; rows past `rows` are zero
template <typename T, int kRows>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0,
                                      int rows, int d, float mul) {
  const int dp = d + 1;
  for (int i = threadIdx.x; i < kRows * d; i += kBwdThreads) {
    const int r = i / d, c = i - r * d;
    const int row = r0 + r;
    dst[r * dp + c] = row < rows ? to_f32(src[(size_t)row * d + c]) * mul
                                 : 0.f;
  }
}

// acc[i][j] = sum_c a[(ty*4+i)][c] * b[(tx+16j)][c] over shared [.][d+1],
// j < J
template <int J>
__device__ __forceinline__ void tile_dot(float (&acc)[4][J], const float* a,
                                         const float* b, int d, int ty,
                                         int tx) {
  const int dp = d + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) acc[i][j] = 0.f;
  for (int c = 0; c < d; ++c) {
    float av[4], bv[J];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty * 4 + i) * dp + c];
#pragma unroll
    for (int j = 0; j < J; ++j) bv[j] = b[(tx + 16 * j) * dp + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

size_t dq_smem_bytes(int d) {
  const int dp = d + 1;
  return sizeof(float) * (size_t)(2 * kBQ * dp + kBK * dp + kBQ * (kBK + 1));
}

// q rows the dK/dV body stages at a time: a whole 64-row q tile up to
// d 128, half of one above (see the header)
template <int DM>
__host__ __device__ constexpr int dkv_q_rows() {
  return DM > kSmallD ? kBQ / 2 : kBQ;
}

size_t dkv_smem_bytes(int d, int qr) {
  const int dp = d + 1;
  return sizeof(float) *
         (size_t)(2 * kBK * dp + 2 * qr * dp + 2 * kBK * (qr + 1) + 2 * qr);
}

template <typename T, typename Mask, int DM>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    typename Mask::Args margs, int hq, int hkv, int sq,
                    int sk, int d, float scale) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  float* qs = smem;              // [kBQ][dp] Q * scale
  float* dos = qs + kBQ * dp;    // [kBQ][dp] dO
  float* kvs = dos + kBQ * dp;   // [kBK][dp] V, then K, of the current tile
  float* dss = kvs + kBK * dp;   // [kBQ][kBK + 1] dS

  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // row group: rows ty*4 .. ty*4+3
  const int tx = tid & 15;  // column lane
  // causal: the last q tiles see the most kv tiles; launch them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const Mask mask(margs, b, h, hq, sq, sk);
  const size_t row0 = (size_t)(b * hq + h) * sq;  // first row of this head

  const T* kb = k + (size_t)(b * hkv + hk) * sk * d;
  const T* vb = v + (size_t)(b * hkv + hk) * sk * d;
  stage<T, kBQ>(qs, q + row0 * d, q0, sq, d, scale);
  stage<T, kBQ>(dos, dout + row0 * d, q0, sq, d, 1.f);

  constexpr int kAccCols = DM / 16;
  float lse_r[4], del_r[4], acc[4][kAccCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lse_r[i] = row < sq ? lse[row0 + row] : 0.f;
    del_r[i] = row < sq ? delta[row0 + row] : 0.f;
#pragma unroll
    for (int c = 0; c < kAccCols; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = mask.kv_end(q0);
  const int ntiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kBK;
    const int kind = mask.kind(q0, k0);  // checked before anything loads
    if (kind == kSkip) continue;
    int info[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      info[j] = kind == kMasked ? mask.col_info(k0 + tx + 16 * j) : 0;
    __syncthreads();  // the previous tile's dQ readers are done
    stage<T, kBK>(kvs, vb, k0, sk, d, 1.f);
    __syncthreads();
    float dp_[4][4];
    tile_dot(dp_, dos, kvs, d, ty, tx);  // dP = dO V^T
    __syncthreads();  // every thread is done reading V
    stage<T, kBK>(kvs, kb, k0, sk, d, 1.f);
    __syncthreads();
    float s[4][4];
    tile_dot(s, qs, kvs, d, ty, tx);  // S = (Q scale) K^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok =
            kind == kFull || (row < sq && mask.visible(row, col, info[j]));
        const float p = ok ? __expf(s[i][j] - lse_r[i]) : 0.f;
        dss[(ty * 4 + i) * (kBK + 1) + tx + 16 * j] =
            p * (dp_[i][j] - del_r[i]);
      }
    }
    __syncthreads();
    for (int kk = 0; kk < kBK; ++kk) {  // dQ += dS K
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty * 4 + i) * (kBK + 1) + kk];
#pragma unroll
      for (int c = 0; c < kAccCols; ++c) {
        const int col = tx + 16 * c;
        if (col < d) {
          const float kv = kvs[kk * dp + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
#pragma unroll
    for (int c = 0; c < kAccCols; ++c) {
      const int col = tx + 16 * c;
      if (col < d)
        dq[(row0 + row) * d + col] = from_f32<T>(acc[i][c] * scale);
    }
  }
}

template <typename T, typename Mask, int DM>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, typename Mask::Args margs, int hq,
                     int hkv, int sq, int sk, int d, float scale) {
  constexpr int QR = dkv_q_rows<DM>();  // q rows staged at a time
  constexpr int J = QR / 16;            // q columns per thread
  constexpr int kAccCols = DM / 16;
  extern __shared__ float smem[];
  const int dp = d + 1;
  float* ks = smem;              // [kBK][dp] K
  float* vs = ks + kBK * dp;     // [kBK][dp] V
  float* qs = vs + kBK * dp;     // [QR][dp] Q * scale of the current rows
  float* dos = qs + QR * dp;     // [QR][dp] dO
  float* pts = dos + QR * dp;    // [kBK][QR + 1] P^T
  float* dss = pts + kBK * (QR + 1);  // [kBK][QR + 1] dS^T
  float* ls = dss + kBK * (QR + 1);   // [QR] lse
  float* dl = ls + QR;                // [QR] delta

  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // row group: kv rows ty*4 .. ty*4+3
  const int tx = tid & 15;  // column lane (q rows of the staged rows)
  // causal: the first kv tiles are seen by the most q tiles
  const int k0 = blockIdx.x * kBK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = hq / hkv;
  const size_t kv0 = (size_t)(b * hkv + hk) * sk;  // first row of this head

  stage<T, kBK>(ks, k + kv0 * d, k0, sk, d, 1.f);
  stage<T, kBK>(vs, v + kv0 * d, k0, sk, d, 1.f);

  float acc_k[4][kAccCols], acc_v[4][kAccCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kAccCols; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const int nqt = (sq + kBQ - 1) / kBQ;

  for (int g = 0; g < rep; ++g) {
    const int h = hk * rep + g;
    const Mask mask(margs, b, h, hq, sq, sk);
    const size_t row0 = (size_t)(b * hq + h) * sq;
    int info[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) info[i] = mask.col_info(k0 + ty * 4 + i);
    const int qt_end = mask.q_end(k0, nqt);
    for (int qt = mask.q_first(k0); qt < qt_end; ++qt) {
      const int kind = mask.kind(qt * kBQ, k0);  // uniform over the block
      if (kind == kSkip) continue;
      // the staged q rows [q0, q0 + QR): the whole q tile at DM 128 (QR
      // = 64), each half of it at DM 256. At DM 128 the body runs once,
      // straight: wrapped in a loop over the halves, it ran 10-27% slower
      // there (same bits, other register allocation).
      auto rows = [&](const int q0) {
        __syncthreads();  // the previous rows' readers are done
        stage<T, QR>(qs, q + row0 * d, q0, sq, d, scale);
        stage<T, QR>(dos, dout + row0 * d, q0, sq, d, 1.f);
        for (int r = tid; r < QR; r += kBwdThreads) {
          const int row = q0 + r;
          ls[r] = row < sq ? lse[row0 + row] : 0.f;
          dl[r] = row < sq ? delta[row0 + row] : 0.f;
        }
        __syncthreads();
        float s[4][J], dpt[4][J];
        tile_dot<J>(s, ks, qs, d, ty, tx);     // S^T = K (Q scale)^T
        tile_dot<J>(dpt, vs, dos, d, ty, tx);  // dP^T = V dO^T
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = k0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const int r = tx + 16 * j;
            const int row = q0 + r;
            const bool ok = kind == kFull ||
                            (row < sq && mask.visible(row, col, info[i]));
            const float p = ok ? __expf(s[i][j] - ls[r]) : 0.f;
            pts[(ty * 4 + i) * (QR + 1) + r] = p;
            dss[(ty * 4 + i) * (QR + 1) + r] = p * (dpt[i][j] - dl[r]);
          }
        }
        __syncthreads();
        for (int r = 0; r < QR; ++r) {  // dV += P^T dO; dK += dS^T (Q scale)
          float pv[4], dsv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            pv[i] = pts[(ty * 4 + i) * (QR + 1) + r];
            dsv[i] = dss[(ty * 4 + i) * (QR + 1) + r];
          }
#pragma unroll
          for (int c = 0; c < kAccCols; ++c) {
            const int col = tx + 16 * c;
            if (col < d) {
              const float dov = dos[r * dp + col];
              const float qv = qs[r * dp + col];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                acc_v[i][c] = fmaf(pv[i], dov, acc_v[i][c]);
                acc_k[i][c] = fmaf(dsv[i], qv, acc_k[i][c]);
              }
            }
          }
        }
      };
      if constexpr (QR == kBQ) {
        rows(qt * kBQ);
      } else {
        rows(qt * kBQ);
        if (qt * kBQ + QR < sq) rows(qt * kBQ + QR);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= sk) continue;
#pragma unroll
    for (int c = 0; c < kAccCols; ++c) {
      const int col = tx + 16 * c;
      if (col < d) {
        // dK picked up its 1/sqrt(D) through the pre-scaled Q
        dk[(kv0 + row) * d + col] = from_f32<T>(acc_k[i][c]);
        dv[(kv0 + row) * d + col] = from_f32<T>(acc_v[i][c]);
      }
    }
  }
}

template <typename T, typename Mask, int DM>
int launch_bwd_dq(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, typename Mask::Args margs, int b, int hq,
                  int hkv, int sq, int sk, int d, float scale,
                  cudaStream_t stream) {
  if (d > DM) return (int)cudaErrorInvalidValue;
  const size_t smem = dq_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, Mask, DM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_bwd_dq_kernel<T, Mask, DM><<<grid, kBwdThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), margs, hq, hkv, sq, sk, d, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename Mask, int DM>
int launch_bwd_dkv(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, typename Mask::Args margs, int b,
                   int hq, int hkv, int sq, int sk, int d,
                   float scale, cudaStream_t stream) {
  if (d > DM) return (int)cudaErrorInvalidValue;
  const size_t smem = dkv_smem_bytes(d, dkv_q_rows<DM>());
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, Mask, DM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sk + kBK - 1) / kBK, hkv, b);
  flash_bwd_dkv_kernel<T, Mask, DM><<<grid, kBwdThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), margs, hq, hkv, sq, sk, d,
      scale);
  return (int)cudaGetLastError();
}

// -------------------------------------------------- calls with no work

__global__ void fill_f32_kernel(float* __restrict__ p, size_t n, float v) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    p[i] = v;
}

// `bytes` zero bytes at p (no launch when there are none)
int zero_fill(void* p, size_t bytes, cudaStream_t stream) {
  if (bytes == 0) return 0;
  return (int)cudaMemsetAsync(p, 0, bytes, stream);
}

// a forward with no keys: O = 0 and lse = -1e30 over `rows` query rows of
// d elements of `elem` bytes, as the bodies give a row that sees no key
int fill_empty(void* o, void* lse, size_t rows, int d, size_t elem,
               cudaStream_t stream) {
  const int err = zero_fill(o, rows * d * elem, stream);
  if (err != 0 || rows == 0) return err;
  const int blocks = (int)((rows + 255) / 256 < 1024 ? (rows + 255) / 256
                                                      : 1024);
  fill_f32_kernel<<<blocks, 256, 0, stream>>>(static_cast<float*>(lse),
                                              rows, kNeg);
  return (int)cudaGetLastError();
}

}  // namespace
