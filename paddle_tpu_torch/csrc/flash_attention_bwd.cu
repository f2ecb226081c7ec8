// Flash-attention backward for Hopper (sm_90a), bf16 or f32 in and out,
// f32 accumulation: dQ in one kernel, dK and dV in another.
//
// Replaces: paddle_tpu/ops/pallas_attention.py `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` (the non-varlen backward reached through
// `_flash_backward_x32`, the `_flash` custom VJP's backward rule).
//
// Layout: q, o, dO [B, Hq, Sq, D], k/v [B, Hkv, Sk, D], contiguous; lse
// and delta = rowsum(dO * O) f32 [B, Hq, Sq] (lse as the forward kernel
// writes it; delta computed by the caller, as the reference computes it
// outside its kernels). With P = exp(S * scale - lse) and scale =
// 1/sqrt(D):
//   dS = P * (dO V^T - delta);  dQ = dS K scale;  dV = P^T dO;
//   dK = dS^T (Q scale).
// Causal masking aligns the last query row with the last key column
// (col <= row + Sk - Sq), as the forward does. Masked probabilities are
// zeroed, not exponentiated against a mask value: a row that sees no key
// has lse = -1e30 and would otherwise add garbage to dK/dV.
//
// What bounds it on the H100: per (query row, visible key) pair the five
// products do 10*D flops on the bytes of Q, K, V, O, dO, dQ, dK, dV (7*S*D
// values per head) plus lse and delta; a causal head at S = 1024, D = 128
// does ~367 flops per byte in bf16, above the card's ridge (~295), so the
// tensor-core rate bounds it there and the memory below S ~ 800. This
// first version does its products with plain f32 FMAs on the CUDA cores,
// and recomputes S and dP in both kernels (seven products, not five), so
// the CUDA cores' FMA rate bounds it, far above either; moving the
// products onto mma.sync/wgmma is the known next step.
//
// Design. Blocks run in parallel with no order, so the TPU's sequential
// grid with VMEM scratch carried across steps becomes a loop inside each
// block, and the two accumulations go to two kernels that need no atomics:
//  * dQ: one block of 256 threads per (64-row q tile, q head, batch). Q
//    (pre-scaled) and dO stay in shared memory; the block loops over 64-row
//    kv tiles, staging V (for dP = dO V^T), then K (for S = Q K^T, and then
//    dQ += dS K) through one shared buffer, with dS passed through shared
//    memory between the two thread layouts.
//  * dK/dV: one block per (64-row kv tile, kv head, batch). K and V stay in
//    shared memory; the block loops over the q heads of its GQA group and
//    over the q tiles that can see the tile, staging Q (pre-scaled), dO,
//    lse and delta, and keeps dK and dV in registers. The group's q heads
//    are summed inside the block, so dK/dV need no atomics and results
//    repeat from run to run (the reference repeats K/V and lets the VJP of
//    jnp.repeat sum; the result is the same).
// Each thread owns 4 rows x 4 columns of a 64 x 64 score tile (columns
// tx + 16j) and 4 rows x D/16 columns of the accumulators. Tiles entirely
// above the causal diagonal are never visited; the diagonal and the ragged
// tails are masked per element. The heaviest causal tiles are launched
// first. Rows padded by 1 float keep the column-wise shared-memory reads
// free of bank conflicts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // kv rows per tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kMaxD = 128;
constexpr int kAccCols = kMaxD / 16;

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

// rows [r0, r0 + kRows) of a [rows, d] matrix into shared [kRows][d + 1]
// f32, times `mul`; rows past `rows` are zero
template <typename T, int kRows>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0,
                                      int rows, int d, float mul) {
  const int dp = d + 1;
  for (int i = threadIdx.x; i < kRows * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    const int row = r0 + r;
    dst[r * dp + c] = row < rows ? to_f32(src[(size_t)row * d + c]) * mul
                                 : 0.f;
  }
}

// acc[i][j] = sum_c a[(ty*4+i)][c] * b[(tx+16j)][c] over shared [.][d+1]
__device__ __forceinline__ void tile_dot(float acc[4][4], const float* a,
                                         const float* b, int d, int ty,
                                         int tx) {
  const int dp = d + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int c = 0; c < d; ++c) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty * 4 + i) * dp + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * dp + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

size_t dq_smem_bytes(int d) {
  const int dp = d + 1;
  return sizeof(float) * (size_t)(2 * kBQ * dp + kBK * dp + kBQ * (kBK + 1));
}

size_t dkv_smem_bytes(int d) {
  const int dp = d + 1;
  return sizeof(float) *
         (size_t)(2 * kBK * dp + 2 * kBQ * dp + 2 * kBK * (kBQ + 1) + 2 * kBQ);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int hq, int hkv, int sq, int sk, int d, float scale,
                    int causal) {
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
  const int off = sk - sq;
  const size_t row0 = (size_t)(b * hq + h) * sq;  // first row of this head

  const T* kb = k + (size_t)(b * hkv + hk) * sk * d;
  const T* vb = v + (size_t)(b * hkv + hk) * sk * d;
  stage<T, kBQ>(qs, q + row0 * d, q0, sq, d, scale);
  stage<T, kBQ>(dos, dout + row0 * d, q0, sq, d, 1.f);

  float lse_r[4], del_r[4], acc[4][kAccCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lse_r[i] = row < sq ? lse[row0 + row] : 0.f;
    del_r[i] = row < sq ? delta[row0 + row] : 0.f;
#pragma unroll
    for (int c = 0; c < kAccCols; ++c) acc[i][c] = 0.f;
  }

  // kv columns any row of this tile can see
  int kv_end = sk;
  if (causal) kv_end = min(sk, q0 + kBQ + off);
  const int ntiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kBK;
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
            row < sq && col < sk && (!causal || col <= row + off);
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int hq, int hkv, int sq, int sk,
                     int d, float scale, int causal) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  float* ks = smem;              // [kBK][dp] K
  float* vs = ks + kBK * dp;     // [kBK][dp] V
  float* qs = vs + kBK * dp;     // [kBQ][dp] Q * scale of the current q tile
  float* dos = qs + kBQ * dp;    // [kBQ][dp] dO
  float* pts = dos + kBQ * dp;   // [kBK][kBQ + 1] P^T
  float* dss = pts + kBK * (kBQ + 1);  // [kBK][kBQ + 1] dS^T
  float* ls = dss + kBK * (kBQ + 1);   // [kBQ] lse
  float* dl = ls + kBQ;                // [kBQ] delta

  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // row group: kv rows ty*4 .. ty*4+3
  const int tx = tid & 15;  // column lane (q rows of the tile)
  // causal: the first kv tiles are seen by the most q tiles
  const int k0 = blockIdx.x * kBK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = hq / hkv;
  const int off = sk - sq;
  const size_t kv0 = (size_t)(b * hkv + hk) * sk;  // first row of this head

  stage<T, kBK>(ks, k + kv0 * d, k0, sk, d, 1.f);
  stage<T, kBK>(vs, v + kv0 * d, k0, sk, d, 1.f);

  float acc_k[4][kAccCols], acc_v[4][kAccCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kAccCols; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // the first q row that sees column k0 is k0 - off: earlier q tiles lie
  // entirely above the diagonal
  const int qt_first = causal ? max(0, k0 - off) / kBQ : 0;
  const int nqt = (sq + kBQ - 1) / kBQ;

  for (int g = 0; g < rep; ++g) {
    const size_t row0 = (size_t)(b * hq + hk * rep + g) * sq;
    for (int qt = qt_first; qt < nqt; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // the previous q tile's readers are done
      stage<T, kBQ>(qs, q + row0 * d, q0, sq, d, scale);
      stage<T, kBQ>(dos, dout + row0 * d, q0, sq, d, 1.f);
      for (int r = tid; r < kBQ; r += kThreads) {
        const int row = q0 + r;
        ls[r] = row < sq ? lse[row0 + row] : 0.f;
        dl[r] = row < sq ? delta[row0 + row] : 0.f;
      }
      __syncthreads();
      float s[4][4], dpt[4][4];
      tile_dot(s, ks, qs, d, ty, tx);     // S^T = K (Q scale)^T
      tile_dot(dpt, vs, dos, d, ty, tx);  // dP^T = V dO^T
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          const int row = q0 + r;
          const bool ok =
              row < sq && col < sk && (!causal || col <= row + off);
          const float p = ok ? __expf(s[i][j] - ls[r]) : 0.f;
          pts[(ty * 4 + i) * (kBQ + 1) + r] = p;
          dss[(ty * 4 + i) * (kBQ + 1) + r] = p * (dpt[i][j] - dl[r]);
        }
      }
      __syncthreads();
      for (int r = 0; r < kBQ; ++r) {  // dV += P^T dO; dK += dS^T (Q scale)
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = pts[(ty * 4 + i) * (kBQ + 1) + r];
          dsv[i] = dss[(ty * 4 + i) * (kBQ + 1) + r];
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

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int b, int hq,
              int hkv, int sq, int sk, int d, int causal,
              cudaStream_t stream) {
  const size_t smem = dq_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_bwd_dq_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), hq, hkv, sq, sk, d, 1.0f / sqrtf((float)d),
      causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta,
               void* dk, void* dv, int b, int hq, int hkv, int sq, int sk,
               int d, int causal, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sk + kBK - 1) / kBK, hkv, b);
  flash_bwd_dkv_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), hq, hkv, sq, sk, d,
      1.0f / sqrtf((float)d), causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError()
// (0 = ok); the caller has checked shapes, dtypes, contiguity and
// d <= 128.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int b, int hq, int hkv,
                                      int sq, int sk, int d, int causal,
                                      int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b == 0 || sq == 0) return 0;
  if (dtype == 1)
    return launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, b, hq,
                                    hkv, sq, sk, d, causal, st);
  return launch_dq<float>(q, k, v, dout, lse, delta, dq, b, hq, hkv, sq, sk,
                          d, causal, st);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int b, int hq,
                                       int hkv, int sq, int sk, int d,
                                       int causal, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b == 0 || sk == 0) return 0;
  if (dtype == 1)
    return launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, b,
                                     hq, hkv, sq, sk, d, causal, st);
  return launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, b, hq, hkv,
                           sq, sk, d, causal, st);
}
