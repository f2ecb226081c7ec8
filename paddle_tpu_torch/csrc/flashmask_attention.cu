// FlashMask block-sparse attention for Hopper (sm_90a), forward and
// backward, bf16 or f32 in and out, f32 accumulation (K9). Three entry
// points over the flash-attention tile bodies (the tensor-core ones of
// flash_attention_tc.cuh and the CUDA-core ones of
// flash_attention_tiles.cuh) with the start-row mask policy
// `StartRowMask`:
//  * flashmask_fwd: O and the per-row log-sum-exp;
//  * flashmask_bwd_dq: dQ from the saved lse;
//  * flashmask_bwd_dkv: dK and dV from the saved lse.
//
// Replaces: paddle_tpu/ops/pallas_attention.py `_fm_fwd_kernel`,
// `_fm_bwd_dq_kernel` and `_fm_bwd_dkv_kernel`, reached through
// `flashmask_attention_raw` and the `_flashmask` custom VJP.
//
// Semantics (the causal LTS form): key column j is hidden from query rows
// i >= start[b, h, j], and, causal, from rows with j > i + Sk - Sq. A row
// that every column hides gets O = 0 and lse = -1e30 and contributes
// nothing to the gradients; a key column that no row sees gets dK = dV =
// 0. K9 takes Hq == Hkv, as the reference's kernel does (it indexes K by
// q's head); the wrapper refuses the rest.
//
// Layout: q, o, dO [B, H, Sq, D], k/v [B, H, Sk, D], contiguous; lse and
// delta = rowsum(dO * O) f32 [B, H, Sq]; start int32 [B, H, Sk]; smin /
// smax int32 [B, H, ceil(Sk / 64)]: each 64-column kv tile's least start
// row over its in-range columns and its greatest over all its columns
// (padded columns count as start 0). The wrapper computes smin / smax in
// a small plain-torch prep (as the reference's `_fm_starts_prep` does
// outside its kernels), so every block reads its tile bounds instead of
// reducing 64 start rows per visited tile.
//
// Tile dispatch (the reference's `_fm_block_dispatch`): a kv tile is
// skipped - never loaded - when the q tile's first row is at or past the
// tile's smax, or the tile lies wholly above the causal diagonal; it takes
// the unmasked path when the q tile's last row precedes smin and the tile
// is wholly in range and below the diagonal; only a straddling tile masks
// per element. The forward and dQ kernels check a tile's kind before they
// load anything; the dK/dV kernel visits only the q tiles from the causal
// diagonal up to ceil(smax / 64).
//
// What bounds it on the H100: the work is that of flash attention over
// the visible (row, column) pairs alone: 4*D flops per pair forward, 6*D
// for dQ's three products and 8*D for dK/dV's four, at the tensor-core
// rate, against the bytes of Q, K, V, O (and dO, dQ, dK, dV), lse, delta
// and the start rows. At S = 8192 with a 1024-token window (7.9M visible
// pairs per head of 33.6M causal) the operations bound all three; what
// the block skipping buys is the work of the skipped tiles (4.3x less
// than causal flash at that window). The tensor-core bodies compute every
// pair of a visited tile, masked or not, so their work is the visited
// tiles' pairs, above the visible count where tiles straddle.
//
// Routing is static, by dtype and head dim, with no fallback:
//  * bf16 forward, dQ and dK/dV at d <= 128 run the tensor-core bodies of
//    flash_attention_tc.cuh with `StartRowMask` (wgmma, TMA, two
//    warpgroups of 64 rows, a 2-stage ring), as K1 and K2 do: the policy
//    answers each 64 x 64 tile's kind from smin / smax and each element
//    of a straddling tile from its column's start row (dQ streams 128-
//    column kv tiles at D 128, whose kind combines their two 64-column
//    halves). They take D a multiple of 8 (the caller pads, passing the
//    softmax scale of the original D), 16-byte-aligned Q, K, V (and dO)
//    and, in dK/dV, lse / delta rows `ls_stride` floats apart (a multiple
//    of 4, >= Sq: read by 2-D TMA); dQ reads each thread's two lse and
//    delta rows by plain loads. Anything else returns
//    cudaErrorInvalidValue;
//  * f32, and both dtypes at 128 < d <= 256, run the CUDA-core bodies of
//    flash_attention_tiles.cuh (f32 FMAs), instantiated at DM 128 and
//    256. The CUDA-core dK/dV reads lse and delta rows Sq apart.
// A call with no keys writes O = 0, lse = -1e30 and dQ = 0, one with no
// queries dK = dV = 0, from the entry, without a body.
#include "flash_attention_tc.cuh"

namespace {

StartRowMask::Args mask_args(const void* start, const void* smin,
                             const void* smax, int causal) {
  return StartRowMask::Args{static_cast<const int*>(start),
                            static_cast<const int*>(smin),
                            static_cast<const int*>(smax), causal};
}

size_t elem_bytes(int dtype) { return dtype == 1 ? 2 : 4; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError()
// (0 = ok); the caller has checked shapes (Hq == Hkv), dtypes, contiguity
// and d <= 256. `scale` is the softmax scale, 1/sqrt(D) of the head dim
// before any padding the caller added.
extern "C" int flashmask_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, const void* start,
                             const void* smin, const void* smax, int b,
                             int h, int sq, int sk, int d, int causal,
                             int dtype, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b == 0 || sq == 0) return 0;
  if (sk == 0)
    return fill_empty(o, lse, (size_t)b * h * sq, d, elem_bytes(dtype), st);
  const StartRowMask::Args margs = mask_args(start, smin, smax, causal);
  if (dtype == 1 && d <= kSmallD)
    return launch_fwd_tc<StartRowMask>(q, k, v, o, lse, margs, b, h, h, sq,
                                       sk, d, scale, st);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16, StartRowMask, kLargeD>(
        q, k, v, o, lse, margs, b, h, h, sq, sk, d, scale, st);
  if (d <= kSmallD)
    return launch_fwd<float, StartRowMask, kSmallD>(
        q, k, v, o, lse, margs, b, h, h, sq, sk, d, scale, st);
  return launch_fwd<float, StartRowMask, kLargeD>(
      q, k, v, o, lse, margs, b, h, h, sq, sk, d, scale, st);
}

extern "C" int flashmask_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq,
                                const void* start, const void* smin,
                                const void* smax, int b, int h, int sq,
                                int sk, int d, int causal, int dtype,
                                float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b == 0 || sq == 0) return 0;
  if (sk == 0)
    return zero_fill(dq, (size_t)b * h * sq * d * elem_bytes(dtype), st);
  const StartRowMask::Args margs = mask_args(start, smin, smax, causal);
  if (dtype == 1 && d <= kSmallD)
    return launch_bwd_dq_tc<StartRowMask>(q, k, v, dout, lse, delta, dq,
                                          margs, b, h, h, sq, sk, d, scale,
                                          st);
  if (dtype == 1)
    return launch_bwd_dq<__nv_bfloat16, StartRowMask, kLargeD>(
        q, k, v, dout, lse, delta, dq, margs, b, h, h, sq, sk, d, scale, st);
  if (d <= kSmallD)
    return launch_bwd_dq<float, StartRowMask, kSmallD>(
        q, k, v, dout, lse, delta, dq, margs, b, h, h, sq, sk, d, scale, st);
  return launch_bwd_dq<float, StartRowMask, kLargeD>(
      q, k, v, dout, lse, delta, dq, margs, b, h, h, sq, sk, d, scale, st);
}

extern "C" int flashmask_bwd_dkv(const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* lse, const void* delta,
                                 void* dk, void* dv, const void* start,
                                 const void* smin, const void* smax, int b,
                                 int h, int sq, int sk, int d, int causal,
                                 int dtype, int ls_stride, float scale,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b == 0 || sk == 0) return 0;
  if (sq == 0) {
    const size_t bytes = (size_t)b * h * sk * d * elem_bytes(dtype);
    const int err = zero_fill(dk, bytes, st);
    return err != 0 ? err : zero_fill(dv, bytes, st);
  }
  const StartRowMask::Args margs = mask_args(start, smin, smax, causal);
  if (dtype == 1 && d <= kSmallD)
    return launch_bwd_dkv_tc<StartRowMask>(q, k, v, dout, lse, delta, dk, dv,
                                           margs, b, h, h, sq, sk, d,
                                           ls_stride, scale, st);
  if (dtype == 1)
    return launch_bwd_dkv<__nv_bfloat16, StartRowMask, kLargeD>(
        q, k, v, dout, lse, delta, dk, dv, margs, b, h, h, sq, sk, d, scale,
        st);
  if (d <= kSmallD)
    return launch_bwd_dkv<float, StartRowMask, kSmallD>(
        q, k, v, dout, lse, delta, dk, dv, margs, b, h, h, sq, sk, d, scale,
        st);
  return launch_bwd_dkv<float, StartRowMask, kLargeD>(
      q, k, v, dout, lse, delta, dk, dv, margs, b, h, h, sq, sk, d, scale,
      st);
}
