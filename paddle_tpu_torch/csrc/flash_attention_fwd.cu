// Flash-attention forward for Hopper (sm_90a), bf16 or f32 in and out,
// f32 accumulation. Returns O and the per-row log-sum-exp. Two entry
// points:
//  * flash_attention_fwd (K1), the non-varlen forward;
//  * flash_attention_varlen_fwd (K1v): the same with per-batch kv lengths.
//
// Replaces: paddle_tpu/ops/pallas_attention.py `_fwd_kernel`, reached
// through `_flash_forward_x32` from `flash_attention_raw` (K1) and, with
// `has_lens`, from `flash_attention_varlen_raw` (K1v).
//
// Layout: q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D], contiguous; o like q;
// lse f32 [B, Hq, Sq]; kv_lens int32 [B] (K1v). GQA is handled by indexing
// kv head h / (Hq / Hkv) here instead of materialising repeated K/V
// (flash_attention_raw repeats first; the result is the same). Causal
// masking aligns the last query row with the last key column (col <= row
// + Sk - Sq), as the TPU kernel does. K1v masks key columns >= kv_lens[b]
// and never loads a kv tile that starts past the length, so a sequence of
// length 0 gives O = 0 and lse = -1e30; query rows past the length are
// computed all the same (with causal masking they are not zero) and the
// caller drops them. `scale` is the softmax scale, 1/sqrt(D) of the head
// dim before any padding the caller added (as the reference keeps it when
// it pads D to 128).
//
// What bounds it on the H100: a causal head does ~4*D*S*S/2 flops on
// 8*S*D bytes (bf16 Q, K, V, O), S/4 flops per byte, so the card's bound
// is its memory up to S ~ 1200 (the ridge is ~295 flop/byte) and its
// tensor-core rate above.
//
// Routing is static, by dtype and head dim, with no fallback:
//  * bf16 K1 and K1v at d <= 128 run the tensor-core body (flash_attention_tc.cuh):
//    QK^T and PV on wgmma, two warpgroups of 64 q rows each, K and V
//    streamed by TMA through a 2-stage ring one tile ahead of the math, so
//    loads overlap the math and the products run at the tensor cores'
//    rate. K1v reads its batch row's length in the mask policy and masks
//    every tile it visits (the reference's force_masked=has_lens), so the
//    rows of a partial last tile between the length and Sk, which hold
//    real data, get P = 0. It takes D a multiple of 8 (the caller pads)
//    and 16-byte-aligned inputs; anything else returns
//    cudaErrorInvalidValue;
//  * f32 K1 and K1v, and both dtypes at 128 < d <= 256 (the reference's
//    kernel takes d 256: it pads d to a multiple of 128), run the
//    CUDA-core body (flash_attention_tiles.cuh: one block of 128 threads
//    per 64-row q tile, f32 FMAs; exact f32 like the reference's f32
//    dots), instantiated at DM 128 (f32, d <= 128) and DM 256 (d > 128),
//    so the larger accumulators cost the d <= 128 kernels nothing.
// Tiles wholly above the causal diagonal or past the length are never
// loaded; interior tiles of K1 skip the per-element mask. A call with no
// keys (Sk = 0) launches no body: the entry writes O = 0 and lse = -1e30
// itself, as the bodies give a row that sees no key.
#include "flash_attention_tc.cuh"

namespace {

int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        const int* kv_lens, int b, int hq, int hkv, int sq, int sk, int d,
        int causal, int dtype, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b == 0 || sq == 0) return 0;
  if (sk == 0)
    return fill_empty(o, lse, (size_t)b * hq * sq, d, dtype == 1 ? 2 : 4,
                      st);
  const LenCausalMask::Args margs{kv_lens, causal};
  if (dtype == 1 && d <= kSmallD)
    return launch_fwd_tc<LenCausalMask>(q, k, v, o, lse, margs, b, hq, hkv,
                                        sq, sk, d, scale, st);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16, LenCausalMask, kLargeD>(
        q, k, v, o, lse, margs, b, hq, hkv, sq, sk, d, scale, st);
  if (d <= kSmallD)
    return launch_fwd<float, LenCausalMask, kSmallD>(
        q, k, v, o, lse, margs, b, hq, hkv, sq, sk, d, scale, st);
  return launch_fwd<float, LenCausalMask, kLargeD>(
      q, k, v, o, lse, margs, b, hq, hkv, sq, sk, d, scale, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() (0 = ok);
// the caller has checked shapes, dtypes, contiguity and d <= 256.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int b,
                                   int hq, int hkv, int sq, int sk, int d,
                                   int causal, int dtype, float scale,
                                   void* stream) {
  return fwd(q, k, v, o, lse, nullptr, b, hq, hkv, sq, sk, d, causal, dtype,
             scale, stream);
}

// K1v: kv_lens int32 [B] on the device.
extern "C" int flash_attention_varlen_fwd(const void* q, const void* k,
                                          const void* v, void* o, void* lse,
                                          const void* kv_lens, int b, int hq,
                                          int hkv, int sq, int sk, int d,
                                          int causal, int dtype, float scale,
                                          void* stream) {
  return fwd(q, k, v, o, lse, static_cast<const int*>(kv_lens), b, hq, hkv,
             sq, sk, d, causal, dtype, scale, stream);
}
