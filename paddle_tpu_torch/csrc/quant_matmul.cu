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
// What bounds it on the H100: the packed weight, K/2 * N bytes, is the
// only large input, and each of its bytes feeds 2 * M multiply-adds. At
// decode (M = 1..8, the slot bucket) that is far below the ~295 flop/byte
// ridge: memory bounds it. At prefill (M = the prompt's bucket, up to
// 512) it is above: the tensor cores' rate bounds it. For bf16 x every
// product of a bf16 value and an int4 code is exact in f32, so bf16
// tensor cores with f32 accumulation compute the reference's arithmetic
// and differ from it only in the order of the sum.
//
// Two bodies behind one C entry; the wrapper picks (`tile_m`):
//  * tensor cores (bf16 x, K % 16 == 0, 16-byte-aligned x): the
//    transposed product out^T[N, M] = W^T[N, K] x^T[K, M] on wgmma. The
//    weight is the A operand, dequantized in registers; x is the B
//    operand, K-major, as K is in S = Q K^T. A block of two warpgroups
//    owns 128 weight columns (64 each, wgmma's m) and BM tokens (wgmma's
//    n: 8, 16, 32 or 64, the smallest that holds M, 64 above) and walks
//    K in slabs of 64 packed rows through a 4-stage TMA ring (a full
//    mbarrier per stage): the packed tile [64 rows, 128 columns] (128-
//    byte swizzle) and x's two boxes [BM, 64] at columns p0 and K/2 + p0
//    (two tensor maps of x's halves, so each zero-fills past K/2). The
//    last warp done with a stage (a shared counter) refills it, so no
//    warp waits on another's slab and the two warpgroups run out of
//    step. Each warp reads its 16 columns of the slab with two
//    ldmatrix.x4.trans: a register then holds packed rows p, p + 1 of
//    two adjacent columns, which are the A fragment's rows r and r + 8
//    (the A rows are permuted to columns so that this holds; the
//    epilogue undoes it). Nibbles become bf16 by integer ops: a byte
//    permute, a mask that puts the nibble, sign bit flipped, into the
//    mantissa of 128.0 (the value is 136 + q), and one bf16x2
//    subtraction of 136, all exact. The low nibbles are the k-steps
//    against x's first box, the high nibbles against the second: one
//    read of the weight, two boxes of x. A slab's two halves are two
//    wgmma groups, so the second half's unpacking overlaps the first
//    half's products. The scale multiplies the f32 accumulator in the
//    epilogue; a thread's two rows are two adjacent columns, so each
//    store writes 4 bytes and a warp's stores fill whole 32-byte sectors.
//    Where too few blocks would fill the card (decode: N = 2048 gives 16
//    column tiles), the wrapper splits K: each split writes its f32
//    partial sums, and the last block of a tile to finish (an atomic
//    ticket, put back to 0 for the next call) adds the partials in split
//    order, scales and rounds, in the same launch. The same bits on
//    every run. At prefill x is read from L2 once per 128-column block
//    (43 times at N 5504): the traffic a wider block would cut.
//  * CUDA cores (f32 x, where TF32 would change the results; bf16 x that
//    TMA cannot address, K % 16 != 0): a block owns 32 output columns
//    and 8 rows of x. Its 256 threads are 8 column lanes (4 adjacent
//    columns each: one 4-byte load of a packed row) by 32 row lanes, so
//    one warp reads 4 packed rows x 32 bytes, whole 32-byte sectors. Each
//    packed byte is unpacked in registers (a shift pair, sign-extending)
//    into its low and high K-rows, which pair with two columns of x:
//    [i0, i1) and [K/2 + i0, K/2 + i1). x is staged through shared memory
//    in f32, 128 packed rows at a time, both halves side by side. The 32
//    row lanes' partial sums are added in shared memory in a fixed order
//    (no atomics). A call with few column tiles splits K: each split
//    writes f32 partial sums and a second small kernel adds the splits in
//    order, scales and rounds.
#include "hopper_common.cuh"

namespace {

// ------------------------------------------------------ CUDA-core body

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
int launch_core(const void* x, const void* packed, const void* scale,
                void* out, void* partial, int m, int k, int n, int splits,
                int rows, cudaStream_t st) {
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

// ---------------------------------------------------- tensor-core body

constexpr int kQGroups = 2;                    // consumer warpgroups
constexpr int kQThreads = 128 * kQGroups;
constexpr int kQCols = 64 * kQGroups;          // weight columns per block
constexpr int kQSlab = 64;                     // packed rows per slab
constexpr int kQWBytes = kQSlab * kQCols;      // one packed tile (8 KB)

constexpr int kQStages = 4;                    // the ring
constexpr int kQFold = 8;        // split partials a thread loads at once

// byte offsets from the 1024-aligned shared base: the ring's stages (the
// packed tile, x's low box, x's high box), then a barrier per stage
template <int BM>
struct QmmSmem {
  static constexpr int kXBytes = BM * 128;     // BM rows of 64 bf16
  static constexpr int kStageBytes = kQWBytes + 2 * kXBytes;
  static constexpr int kFull = kQStages * kStageBytes;
  static constexpr int kBytes = kFull + 8 * kQStages + 1024;  // + slack
};

template <int N>
__device__ __forceinline__ void keep_u32(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// four 8x8 b16 matrices, transposed: matrix j's rows are given by lanes
// 8j .. 8j + 7; lane l receives rows 2 (l % 4), 2 (l % 4) + 1 of column
// l / 4 of each
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// Two nibbles, in bits 0-3 and 16-19 of t, as two bf16 holding their
// signed values: OR-ing the nibble with its sign bit flipped (q + 8,
// 0..15) into the mantissa of 128.0 gives 136 + q; subtracting 136 is
// exact.
__device__ __forceinline__ uint32_t nibbles_bf16(uint32_t t) {
  uint32_t v = (t & 0x000F000Fu) ^ 0x43084308u;
  uint32_t bias = 0x43084308u;                 // 136.0, 136.0
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                             *reinterpret_cast<__nv_bfloat162*>(&bias));
  return *reinterpret_cast<uint32_t*>(&r);
}

// One ldmatrix register (bytes: row p column n_e, row p n_o, row p + 1
// n_e, row p + 1 n_o) -> the four A registers it feeds: the low nibbles
// (K-rows p, p + 1) and the high nibbles (K/2 + p, K/2 + p + 1), each of
// column n_e and of column n_o.
__device__ __forceinline__ void unpack_int4(uint32_t r, uint32_t& lo_e,
                                            uint32_t& lo_o, uint32_t& hi_e,
                                            uint32_t& hi_o) {
  const uint32_t e = __byte_perm(r, 0u, 0x4240);   // n_e: bytes 0, 2
  const uint32_t o = __byte_perm(r, 0u, 0x4341);   // n_o: bytes 1, 3
  lo_e = nibbles_bf16(e);
  lo_o = nibbles_bf16(o);
  hi_e = nibbles_bf16(e >> 4);
  hi_o = nibbles_bf16(o >> 4);
}

// d += A B for a 64 x N x 16 step: A (64 weight columns x 16 K-rows, bf16)
// from registers, B (16 K-rows x N tokens) K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_rs_kmajor(float (&d)[N / 2],
                                                const uint32_t (&a)[4],
                                                uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs_kmajor<8>(float (&d)[4],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3"
      "}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_kmajor<16>(float (&d)[8],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_kmajor<32>(float (&d)[16],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_kmajor<64>(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Packed rows 32 h .. 32 h + 31 of this warp's 16 columns (at 16-byte
// chunk `chunk` of the swizzled stage tile at `w`) -> the A fragments of
// k-steps 2 h and 2 h + 1 against x's low box (lo) and its high box (hi).
__device__ __forceinline__ void slab_half_frags(uint32_t w, int h, int chunk,
                                                int lane, uint32_t (&lo)[2][4],
                                                uint32_t (&hi)[2][4]) {
  const int p = 32 * h + lane;          // the row this lane addresses
  uint32_t r[4];
  ldmatrix_x4_trans(r, w + p * 128 + ((chunk ^ (p & 7)) << 4));
  // r[j]: rows 32 h + 8 j + 2 (lane % 4) and + 1; matrices 2 q, 2 q + 1
  // are the first and the second 8 K-rows of k-step q
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = j >> 1, x = (j & 1) * 2;
    unpack_int4(r[j], lo[q][x], lo[q][x + 1], hi[q][x], hi[q][x + 1]);
  }
}

template <int BM>
__global__ void __launch_bounds__(kQThreads, 2)
qmm_tc_kernel(const __grid_constant__ CUtensorMap tw,
              const __grid_constant__ CUtensorMap txl,
              const __grid_constant__ CUtensorMap txh,
              const float* __restrict__ scale,
              __nv_bfloat16* __restrict__ out, float* __restrict__ partial,
              int* __restrict__ tickets, int m, int kh, int n,
              int slabs_per_split) {
  using L = QmmSmem<BM>;
  extern __shared__ __align__(1024) unsigned char qmm_smem[];
  __shared__ int freed[kQStages];    // warps done with each stage's slab
  __shared__ int last_block;
  const uint32_t base = (smem_u32(qmm_smem) + 1023) & ~1023u;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kQCols;
  const int split = blockIdx.y, splits = gridDim.y;
  const int m0 = blockIdx.z * BM;
  const int s0 = split * slabs_per_split;
  const int count =
      min((kh + kQSlab - 1) / kQSlab, s0 + slabs_per_split) - s0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(base + L::kFull + 8 * s, 1);
      freed[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // slab s0 + i into stage i % kQStages
  auto load = [&](int i) {
    const int st = i % kQStages;
    const uint32_t sb = base + st * L::kStageBytes;
    const uint32_t full = base + L::kFull + 8 * st;
    const int p0 = (s0 + i) * kQSlab;
    mbar_arrive_tx(full, L::kStageBytes);
    tma_load_2d(sb, &tw, full, n0, p0);
    tma_load_2d(sb + kQWBytes, &txl, full, p0, m0);
    tma_load_2d(sb + kQWBytes + L::kXBytes, &txh, full, p0, m0);
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < min(count, kQStages); ++i) load(i);

  // this warp's 16 columns: chunk (warp) of the tile's 8 16-byte chunks
  const int chunk = warp;
  float acc[BM / 2];
#pragma unroll
  for (int x = 0; x < BM / 2; ++x) acc[x] = 0.f;

  for (int i = 0; i < count; ++i) {
    const int st = i % kQStages;
    const uint32_t ph = (i / kQStages) & 1;
    const uint32_t sb = base + st * L::kStageBytes;
    const uint32_t xl = sb + kQWBytes, xh = xl + L::kXBytes;
    mbar_wait(base + L::kFull + 8 * st, ph);
    uint32_t lo0[2][4], hi0[2][4], lo1[2][4], hi1[2][4];
    slab_half_frags(sb, 0, chunk, lane, lo0, hi0);
    wg_fence();
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      wgmma_rs_kmajor<BM>(acc, lo0[q], sw128_desc(xl + q * 32, 16));
      wgmma_rs_kmajor<BM>(acc, hi0[q], sw128_desc(xh + q * 32, 16));
    }
    wg_commit();
    slab_half_frags(sb, 1, chunk, lane, lo1, hi1);
    wg_fence();
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      wgmma_rs_kmajor<BM>(acc, lo1[q], sw128_desc(xl + 64 + q * 32, 16));
      wgmma_rs_kmajor<BM>(acc, hi1[q], sw128_desc(xh + 64 + q * 32, 16));
    }
    wg_commit();
    wg_wait0();
    keep(acc);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      keep_u32(lo0[q]);
      keep_u32(hi0[q]);
      keep_u32(lo1[q]);
      keep_u32(hi1[q]);
    }
    // The last warp done with the stage refills it: no warp waits for
    // another's slab, so the two warpgroups run out of step and one's
    // unpacking overlaps the other's products.
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(&freed[st], 1) == kQThreads / 32 - 1) {
        freed[st] = 0;
        if (i + kQStages < count) load(i + kQStages);
      }
    }
    __syncwarp();
  }

  // Accumulator: this thread's rows r, r + 8 are columns ne, ne + 1; its
  // columns are tokens m0 + 8 j + 2 (lane % 4) + {0, 1}, in acc[4 j + 2 i
  // + c] (column ne + i, token ... + c).
  const int ne = n0 + 16 * warp + 2 * (lane >> 2);
  if (splits == 1) {
    if (ne >= n) return;
    const float s_e = scale[ne], s_o = scale[ne + 1];
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int t = m0 + 8 * j + 2 * (lane & 3) + c;
        if (t < m)
          *reinterpret_cast<uint32_t*>(out + (size_t)t * n + ne) =
              pack_bf16(acc[4 * j + c] * s_e, acc[4 * j + 2 + c] * s_o);
      }
    return;
  }
  if (ne < n) {
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int t = m0 + 8 * j + 2 * (lane & 3) + c;
        if (t < m)
          *reinterpret_cast<float2*>(partial +
                                     ((size_t)split * m + t) * n + ne) =
              make_float2(acc[4 * j + c], acc[4 * j + 2 + c]);
      }
  }
  // the last block of this tile to finish adds the splits in order, with
  // kQFold splits' loads in flight at a time
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int tile = blockIdx.z * gridDim.x + blockIdx.x;
    last_block = atomicAdd(tickets + tile, 1) == splits - 1;
    if (last_block) tickets[tile] = 0;       // ready for the next call
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  const int rows = min(BM, m - m0);
  const size_t mn = (size_t)m * n;
#pragma unroll 2
  for (int e = threadIdx.x; e < rows * (kQCols / 4); e += kQThreads) {
    const int t = m0 + e / (kQCols / 4);
    const int col = n0 + 4 * (e % (kQCols / 4));
    if (col >= n) continue;
    const float* p = partial + (size_t)t * n + col;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp0 = 0; sp0 < splits; sp0 += kQFold) {
      float4 v[kQFold];
#pragma unroll
      for (int u = 0; u < kQFold; ++u)
        if (sp0 + u < splits)
          v[u] = __ldcg(reinterpret_cast<const float4*>(p + (sp0 + u) * mn));
#pragma unroll
      for (int u = 0; u < kQFold; ++u)
        if (sp0 + u < splits) {
          s.x += v[u].x;
          s.y += v[u].y;
          s.z += v[u].z;
          s.w += v[u].w;
        }
    }
    uint2 o;
    o.x = pack_bf16(s.x * scale[col], s.y * scale[col + 1]);
    o.y = pack_bf16(s.z * scale[col + 2], s.w * scale[col + 3]);
    *reinterpret_cast<uint2*>(out + (size_t)t * n + col) = o;
  }
}

// a 2-D row-major tensor of `rows` rows of `cols` elements, `stride`
// bytes apart, as a map whose box is `box_cols` x `box_rows`, 128-byte
// swizzled; out-of-range rows and columns read as zero
bool tmap_2d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
             int cols, int rows, size_t stride, int box_cols, int box_rows) {
  const TmapEncode encode = tmap_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)stride};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM>
int run_tc(const void* x, const void* packed, const void* scale, void* out,
           void* partial, void* tickets, int m, int k, int n, int splits,
           int rows, cudaStream_t st) {
  using L = QmmSmem<BM>;
  const int kh = k / 2;
  const char* xb = static_cast<const char*>(x);
  CUtensorMap tw, txl, txh;
  if (!tmap_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, packed, n, kh, n, kQCols,
               kQSlab) ||
      !tmap_2d(&txl, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, xb, kh, m,
               (size_t)k * 2, 64, BM) ||
      !tmap_2d(&txh, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, xb + (size_t)kh * 2,
               kh, m, (size_t)k * 2, 64, BM))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      qmm_tc_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kQCols - 1) / kQCols, splits, (m + BM - 1) / BM);
  qmm_tc_kernel<BM><<<grid, kQThreads, L::kBytes, st>>>(
      tw, txl, txh, static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out),
      splits > 1 ? static_cast<float*>(partial) : nullptr,
      static_cast<int*>(tickets), m, kh, n, rows / kQSlab);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out). tile_m: 0 = the CUDA-core
// body; 8, 16, 32 or 64 = the tensor-core body with that token tile
// (bf16 only). splits, rows: the K split (`rows` packed rows per split; a
// multiple of 64 on the tensor-core body). partial: f32 scratch of
// [splits, M, N] when splits > 1, else unused. tickets: int32 zeros, one
// per tile of the tensor-core body (left at zero), when splits > 1.
// Returns cudaGetLastError() (0 = ok); the caller has checked shapes,
// dtypes, contiguity, an even K, N % 32 == 0, 16-byte alignment of packed
// (and of x, with K % 16 == 0, on the tensor-core body), and that splits
// * rows covers K/2 with every split non-empty.
extern "C" int quant_matmul(const void* x, const void* packed,
                            const void* scale, void* out, void* partial,
                            void* tickets, int m, int k, int n, int splits,
                            int rows, int tile_m, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m == 0 || n == 0) return 0;
  if (tile_m == 0) {
    if (dtype == 1)
      return launch_core<__nv_bfloat16>(x, packed, scale, out, partial, m, k,
                                        n, splits, rows, st);
    return launch_core<float>(x, packed, scale, out, partial, m, k, n,
                              splits, rows, st);
  }
  if (dtype != 1 || k % 16 != 0 || rows % kQSlab != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  switch (tile_m) {
    case 8:
      return run_tc<8>(x, packed, scale, out, partial, tickets, m, k, n,
                       splits, rows, st);
    case 16:
      return run_tc<16>(x, packed, scale, out, partial, tickets, m, k, n,
                        splits, rows, st);
    case 32:
      return run_tc<32>(x, packed, scale, out, partial, tickets, m, k, n,
                        splits, rows, st);
    case 64:
      return run_tc<64>(x, packed, scale, out, partial, tickets, m, k, n,
                        splits, rows, st);
  }
  return (int)cudaErrorInvalidValue;
}
