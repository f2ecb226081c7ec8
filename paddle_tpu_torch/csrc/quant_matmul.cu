// Int4 weight-only dequant-matmul for Hopper (sm_90a):
// out[M, N] = (x[M, K] @ q[K, N]) * scale[N], with q unpacked from
// packed[K/2, N] int8 inside the kernel, f32 accumulation and one
// rounding to x's dtype.
//
// Replaces: paddle_tpu/ops/quantized.py `_qmm_kernel` (reached through
// `_qmm_x32`, entry `quant_matmul_raw`).
//
// Layout: x [M, K] f32 or bf16, row-major; packed [K/2, N] int8,
// split-half: packed row i holds logical K-row i in its low nibble and
// K-row K/2 + i in its high nibble, each a signed 4-bit value (-8..7);
// scale [N] f32, one per output column; out [M, N] in x's dtype. K is
// even and N a multiple of 32 (the wrapper checks).
//
// What bounds it on the H100: at decode (M = 1..8, the slot bucket)
// memory. The packed weight, K/2 * N bytes, is the only large input and
// each of its bytes feeds 2 * M multiply-adds, far below the ~295
// flop/byte ridge. At prefill (M up to 512) a tensor-core GEMM would be
// bound by operations; this first kernel runs on the CUDA cores.
//
// Design: the packed bytes are the only weight traffic. A block owns 32
// output columns and 8 rows of x. Its 256 threads are 8 column lanes
// (4 adjacent columns each: one 4-byte load of a packed row) by 32 row
// lanes, so one warp reads 4 packed rows x 32 bytes, whole 32-byte
// sectors. Each packed byte is unpacked in registers (a shift pair,
// sign-extending) into its low and high K-rows, which pair with two
// columns of x: [i0, i1) and [K/2 + i0, K/2 + i1). x is staged through
// shared memory in f32, 128 packed rows at a time, both halves side by
// side. The 32 row lanes' partial sums are added in shared memory in a
// fixed order (no atomics, so results do not change from run to run).
// A decode-sized call has too few column tiles to fill 132 SMs (N = 2048
// gives 64 blocks), so the wrapper splits K: each split writes f32
// partial sums and a second small kernel adds the splits in order, scales
// and rounds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColLanes = 8;                  // x 4 columns = 32 columns
constexpr int kCols = kColLanes * 4;
constexpr int kRowLanes = kThreads / kColLanes;  // packed rows in parallel
constexpr int kBM = 8;                        // x rows per block
constexpr int kPT = 128;                      // packed rows per x tile
static_assert(kBM * kCols == kThreads, "one output per thread at the end");

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

// byte c of w: its low and its high nibble, sign-extended
__device__ __forceinline__ float nibble_lo(uint32_t w, int c) {
  return (float)((int)(w << (28 - 8 * c)) >> 28);
}
__device__ __forceinline__ float nibble_hi(uint32_t w, int c) {
  return (float)((int)(w << (24 - 8 * c)) >> 28);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const T* __restrict__ x, const int8_t* __restrict__ packed,
           const float* __restrict__ scale, T* __restrict__ out,
           float* __restrict__ partial, int m, int k, int n,
           int rows_per_split) {
  __shared__ float xs[kBM][2][kPT];               // x tile, both halves
  __shared__ float red[kRowLanes][kBM * kCols];   // row lanes' partials

  const int tid = threadIdx.x;
  const int tx = tid % kColLanes, ty = tid / kColLanes;
  const int n0 = blockIdx.x * kCols;
  const int col = n0 + tx * 4;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * kBM;
  const int kh = k / 2;
  const int r_begin = split * rows_per_split;
  const int r_end = min(kh, r_begin + rows_per_split);

  float acc[kBM][4];
#pragma unroll
  for (int i = 0; i < kBM; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int t0 = r_begin; t0 < r_end; t0 += kPT) {
    const int cnt = min(kPT, r_end - t0);
    for (int i = tid; i < kBM * 2 * kPT; i += kThreads) {
      const int mi = i / (2 * kPT);
      const int h = (i / kPT) & 1;
      const int r = i % kPT;
      float v = 0.f;
      if (m0 + mi < m && r < cnt)
        v = to_f32(x[(size_t)(m0 + mi) * k + h * kh + t0 + r]);
      xs[mi][h][r] = v;
    }
    __syncthreads();
    for (int r = ty; r < cnt; r += kRowLanes) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(
          packed + (size_t)(t0 + r) * n + col);
      float lo[4], hi[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        lo[c] = nibble_lo(w, c);
        hi[c] = nibble_hi(w, c);
      }
#pragma unroll
      for (int mi = 0; mi < kBM; ++mi) {
        const float xl = xs[mi][0][r], xh = xs[mi][1][r];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[mi][c] = fmaf(xh, hi[c], fmaf(xl, lo[c], acc[mi][c]));
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < kBM; ++mi)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[ty][mi * kCols + tx * 4 + c] = acc[mi][c];
  __syncthreads();

  // thread tid -> output row m0 + tid / 32, column n0 + tid % 32
  float s = 0.f;
  for (int r = 0; r < kRowLanes; ++r) s += red[r][tid];
  const int row = m0 + tid / kCols, cn = n0 + tid % kCols;
  if (row < m) {
    if (partial != nullptr)
      partial[((size_t)split * m + row) * n + cn] = s;
    else
      out[(size_t)row * n + cn] = from_f32<T>(s * scale[cn]);
  }
}

// adds the K splits in order, scales, rounds once
template <typename T>
__global__ void qmm_finish(const float* __restrict__ partial,
                           const float* __restrict__ scale,
                           T* __restrict__ out, int m, int n, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t mn = (size_t)m * n;
  if (i >= mn) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += partial[p * mn + i];
  out[i] = from_f32<T>(s * scale[i % n]);
}

template <typename T>
int launch(const void* x, const void* packed, const void* scale, void* out,
           void* partial, int m, int k, int n, int splits, int rows,
           cudaStream_t st) {
  const dim3 grid(n / kCols, splits, (m + kBM - 1) / kBM);
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  qmm_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(packed),
      static_cast<const float*>(scale), static_cast<T*>(out), part, m, k, n,
      rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return (int)err;
  const size_t mn = (size_t)m * n;
  qmm_finish<T><<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(
      part, static_cast<const float*>(scale), static_cast<T*>(out), m, n,
      splits);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out). partial: f32 scratch of
// [splits, M, N] when splits > 1, else unused. Returns cudaGetLastError()
// (0 = ok); the caller has checked shapes, dtypes, contiguity, an even K,
// N % 32 == 0, 16-byte alignment of packed, and that splits * rows covers
// K/2 with every split non-empty.
extern "C" int quant_matmul(const void* x, const void* packed,
                            const void* scale, void* out, void* partial,
                            int m, int k, int n, int splits, int rows,
                            int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m == 0 || n == 0) return 0;
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, packed, scale, out, partial, m, k, n,
                                 splits, rows, st);
  return launch<float>(x, packed, scale, out, partial, m, k, n, splits, rows,
                       st);
}
