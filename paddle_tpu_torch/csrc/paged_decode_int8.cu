// Paged flash-decode attention over int8 caches with one f32 scale per
// block (K7q) for Hopper (sm_90a): the C entry of the kernel template in
// paged_decode.cuh (its note says what bounds it on the H100 and how the
// design answers that).
//
// Replaces: paddle_tpu/ops/pallas_decode.py `_decode_kernel`, reached
// through `_paged_decode_x32` and `paged_decode_attention_raw` with
// `has_scale=True`.
#include "paged_decode.cuh"

// dtype (of q and out, and of model-dtype caches): 0 = float32,
// 1 = bfloat16, 2 = float16. bs is the block size in tokens (an int4
// block stores bs/2 rows). `splits` blocks of `part` tokens (a multiple
// of 64, splits * part >= pages * bs) cover each table row; with
// splits > 1, `ws` is an f32 workspace of s_n * hq * splits * (d + 2)
// floats for the partials. Returns cudaGetLastError() (0 = ok); the
// caller has checked shapes, dtypes, contiguity, 16-byte alignment of the
// caches, d <= 256, d % 8 == 0, bs even for int4 and Hq a multiple of
// Hkv.
extern "C" int paged_decode_attention_int8(
    const void* q, const void* kc, const void* vc, const void* kscale,
    const void* vscale, const void* tables, const void* lens, void* out,
    int s_n, int hq, int hkv, int bs, int d, int pages, int dtype,
    int splits, int part, void* ws, void* stream) {
  return run<kInt8>(q, kc, vc, kscale, vscale, tables, lens, out, s_n, hq,
                    hkv, bs, d, pages, dtype, splits, part, ws, stream);
}
