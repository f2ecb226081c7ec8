"""Paged flash-decode attention: the hand-written CUDA kernel and its plain
PyTorch version.

Port of paddle_tpu/ops/pallas_decode.py (`_decode_kernel` through
`_paged_decode_x32`, entry `paged_decode_attention`) for caches in the
model's dtype (K7) and for int8 and int4 caches with per-block scales
(K7q); the plain version is the counterpart of
`paged_decode_attention_xla`. The kernels live in csrc/paged_decode.cuh
(one template, the cache format a parameter) with one source, C entry
point and launch counter per format (csrc/paged_decode.cu,
paged_decode_int8.cu, paged_decode_int4.cu); the header's note says what
bounds them on the H100 and how the design answers that.

Contract: q [S, Hq, D]; caches [N, Hkv, bs, D] in q's dtype, or int8
with k_scale/v_scale [N] f32 (a cached value is code * scale[block]), or
int4-packed [N, Hkv, bs/2, D] int8 when `kv_int4` (split-half along the
token axis: packed row t holds token t in its low nibble and token
bs/2 + t in its high nibble; scales required); block_tables [S, P] int32
(entries < 0 are padding, clamped to block 0); seq_lens [S] valid kv
lengths. Returns [S, Hq, D] in q's dtype.

Routing: CPU tensors take the plain version; CUDA tensors launch the
kernel of their cache format or raise. There is no fallback. The kernels
take any GQA group and head dims that are multiples of 8 up to 256
(`MAX_HEAD_DIM`), as the reference's kernel serves them; a head dim that
is no multiple of 8 takes the plain version on the card too, as the
reference's gate (`decode_gate_reason`) sends head dims off its kernel's
alignment to its XLA composition.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ._cuda_common import (check_launch, count_launch, current_stream,
                           kernel_library)
from .quantized import int4_unpack

_NAME = "paged_decode_attention"
#: kernel (C entry point and launch counter) of each cache format
KERNEL_NAMES = {"model": _NAME, "int8": _NAME + "_int8",
                "int4": _NAME + "_int4"}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the largest head dim the kernels take (a multiple of 8)
MAX_HEAD_DIM = 256


def _cache_format(k_scale, kv_int4) -> str:
    if kv_int4 and k_scale is None:
        raise ValueError("int4 KV needs per-block scales")
    return "model" if k_scale is None else ("int4" if kv_int4 else "int8")


def paged_decode_attention_reference(q, k_cache, v_cache, block_tables,
                                     seq_lens, k_scale=None, v_scale=None,
                                     kv_int4=False):
    """Gather every page through the block table (unpacking and scaling
    quantized pages into q's dtype, as the reference's XLA composition),
    then a masked softmax in f32 — the plain PyTorch version of the
    kernels."""
    _cache_format(k_scale, kv_int4)
    s_n, hq, d = q.shape
    _, hkv, bs, _ = k_cache.shape
    pages = block_tables.shape[1]
    tabs = block_tables.clamp_min(0).long()
    k = k_cache[tabs]                        # [S, P, Hkv, bs(/2), D]
    v = v_cache[tabs]
    if kv_int4:
        bs *= 2
        k = int4_unpack(k, bs, axis=-2)
        v = int4_unpack(v, bs, axis=-2)
    if k_scale is not None:
        ks = k_scale.to(q.device)[tabs][:, :, None, None, None]
        vs = v_scale.to(q.device)[tabs][:, :, None, None, None]
        k = (k.float() * ks).to(q.dtype)
        v = (v.float() * vs).to(q.dtype)
    t = pages * bs
    k = k.transpose(2, 3).reshape(s_n, t, hkv, d).float()
    v = v.transpose(2, 3).reshape(s_n, t, hkv, d).float()
    rep = hq // hkv
    if rep != 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("shd,sthd->sht", q.float(), k) / math.sqrt(d)
    valid = torch.arange(t, device=q.device)[None, :] \
        < seq_lens.to(q.device).long()[:, None]
    scores = scores.masked_fill(~valid[:, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    # a sequence of length 0 has no valid column: output 0, as the kernel
    probs = torch.nan_to_num(probs, nan=0.0)
    return torch.einsum("sht,sthd->shd", probs, v).to(q.dtype)


def kernel_gate_reason(head_dim):
    """Why a CUDA call takes the plain version instead of the kernel (None
    when the kernel runs): a head dim that is no multiple of 8, which the
    reference's gate sends to its XLA composition too."""
    if head_dim % 8:
        return (f"head_dim {head_dim} is no multiple of 8: the reference's "
                "composition")
    return None


def _check(fmt, q, k_cache, v_cache, block_tables, seq_lens, k_scale,
           v_scale):
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"paged decode takes q [S, Hq, D] and caches "
                         f"[N, Hkv, bs, D]; got q {tuple(q.shape)}, "
                         f"k {tuple(k_cache.shape)}, "
                         f"v {tuple(v_cache.shape)}")
    s_n, hq, d = q.shape
    hkv = k_cache.shape[1]
    if k_cache.shape[3] != d:
        raise ValueError(f"head_dim mismatch: q {d} vs cache "
                         f"{k_cache.shape[3]}")
    if hq % hkv:
        raise ValueError(f"Hq {hq} is not a multiple of Hkv {hkv}")
    if d > MAX_HEAD_DIM or d % 8:
        raise ValueError(f"head_dim {d} (kernel: a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}) not supported by the kernel")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("the caches must be 16-byte aligned (16-byte "
                         "asynchronous copies)")
    if block_tables.shape[0] != s_n or tuple(seq_lens.shape) != (s_n,):
        raise ValueError("block_tables [S, P] and seq_lens [S] must match q")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype}: the kernels take float32 or "
                         "bfloat16 queries")
    if fmt == "model" and (k_cache.dtype != q.dtype
                           or v_cache.dtype != q.dtype):
        raise ValueError(f"dtype {q.dtype}/{k_cache.dtype}: the kernel "
                         "takes float32 or bfloat16 caches in q's dtype")
    tensors = [q, k_cache, v_cache, block_tables, seq_lens]
    if fmt != "model":
        if k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8:
            raise ValueError(f"dtype {k_cache.dtype}: {fmt} caches are "
                             "stored as int8")
        n_blocks = k_cache.shape[0]
        if v_scale is None or tuple(k_scale.shape) != (n_blocks,) \
                or tuple(v_scale.shape) != (n_blocks,) \
                or k_scale.dtype != torch.float32 \
                or v_scale.dtype != torch.float32:
            raise ValueError(f"{fmt} caches need float32 k_scale and "
                             f"v_scale of shape [{n_blocks}]")
        tensors += [k_scale, v_scale]
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise ValueError("block_tables and seq_lens must be int32")
    for t in tensors:
        if t.device != q.device:
            raise ValueError("all inputs must lie on one device")
        if not t.is_contiguous():
            raise ValueError("paged decode needs contiguous inputs")


def paged_decode_attention(q, k_cache, v_cache, block_tables, seq_lens,
                           k_scale=None, v_scale=None, kv_int4=False):
    """Paged decode attention over model-dtype, int8 (`k_scale`/`v_scale`
    given) or int4-packed (`kv_int4`) caches. CPU tensors, and a head dim
    that is no multiple of 8 (the reference's composition), take
    `paged_decode_attention_reference`; CUDA tensors launch the kernel of
    the cache format."""
    fmt = _cache_format(k_scale, kv_int4)
    tensors = [q, k_cache, v_cache, block_tables, seq_lens] + (
        [] if k_scale is None else [k_scale, v_scale])
    if all(t is None or t.device.type == "cpu" for t in tensors) \
            or kernel_gate_reason(q.shape[-1]) is not None:
        return paged_decode_attention_reference(
            q, k_cache, v_cache, block_tables, seq_lens, k_scale, v_scale,
            kv_int4)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    _check(fmt, q, k_cache, v_cache, block_tables, seq_lens, k_scale,
           v_scale)
    s_n, hq, d = q.shape
    _, hkv, bs, _ = k_cache.shape
    if fmt == "int4":
        bs *= 2                    # logical tokens per block
    out = torch.empty_like(q)
    name = KERNEL_NAMES[fmt]
    fn = getattr(kernel_library(name), name)
    scales = [] if fmt == "model" else [k_scale.data_ptr(),
                                        v_scale.data_ptr()]
    fn.argtypes = [ctypes.c_void_p] * (6 + len(scales)) \
        + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), *scales,
              block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
              s_n, hq, hkv, bs, d, block_tables.shape[1], _DTYPES[q.dtype],
              current_stream(q.device))
    check_launch(name, code)
    count_launch(name)
    return out
