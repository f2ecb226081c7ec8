"""Paged flash-decode attention: the hand-written CUDA kernel and its plain
PyTorch version.

Port of paddle_tpu/ops/pallas_decode.py for caches in the model's dtype
(`_decode_kernel` through `_paged_decode_x32`, entry
`paged_decode_attention`); the plain version is the counterpart of
`paged_decode_attention_xla`. The kernel lives in csrc/paged_decode.cu;
its source note says what bounds it on the H100 and how its design
answers that. The int8/int4 cache variants are not ported yet.

Contract: q [S, Hq, D]; caches [N, Hkv, bs, D]; block_tables [S, P] int32
(entries < 0 are padding, clamped to block 0); seq_lens [S] valid kv
lengths. Returns [S, Hq, D] in q's dtype.

Routing: CPU tensors take the plain version; CUDA tensors launch the
kernel or raise. There is no fallback.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ._cuda_common import (check_launch, count_launch, current_stream,
                           kernel_library)

_NAME = "paged_decode_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
GROUPS = (1, 2, 4, 8, 16)     # Hq / Hkv values the kernel is built for


def paged_decode_attention_reference(q, k_cache, v_cache, block_tables,
                                     seq_lens):
    """Gather every page through the block table, then a masked softmax
    in f32 — the plain PyTorch version of the kernel."""
    s_n, hq, d = q.shape
    _, hkv, bs, _ = k_cache.shape
    pages = block_tables.shape[1]
    tabs = block_tables.clamp_min(0).long()
    t = pages * bs
    k = k_cache[tabs].transpose(2, 3).reshape(s_n, t, hkv, d).float()
    v = v_cache[tabs].transpose(2, 3).reshape(s_n, t, hkv, d).float()
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


def _check(q, k_cache, v_cache, block_tables, seq_lens):
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
    if hq // hkv not in GROUPS or d > MAX_HEAD_DIM or d % 8:
        raise ValueError(f"GQA group {hq // hkv} (kernel: {GROUPS}) or "
                         f"head_dim {d} (kernel: a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}) not supported by the kernel")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("the caches must be 16-byte aligned (16-byte "
                         "asynchronous copies)")
    if block_tables.shape[0] != s_n or tuple(seq_lens.shape) != (s_n,):
        raise ValueError("block_tables [S, P] and seq_lens [S] must match q")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(f"dtype {q.dtype}/{k_cache.dtype}: the kernel "
                         "takes float32 or bfloat16 caches in q's dtype")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise ValueError("block_tables and seq_lens must be int32")
    for t in (q, k_cache, v_cache, block_tables, seq_lens):
        if t.device != q.device:
            raise ValueError("all inputs must lie on one device")
        if not t.is_contiguous():
            raise ValueError("paged decode needs contiguous inputs")


def paged_decode_attention(q, k_cache, v_cache, block_tables, seq_lens):
    """Paged decode attention. CPU tensors take
    `paged_decode_attention_reference`; CUDA tensors launch the kernel."""
    tensors = (q, k_cache, v_cache, block_tables, seq_lens)
    if all(t.device.type == "cpu" for t in tensors):
        return paged_decode_attention_reference(*tensors)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    _check(*tensors)
    s_n, hq, d = q.shape
    _, hkv, bs, _ = k_cache.shape
    out = torch.empty_like(q)
    fn = kernel_library(_NAME).paged_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
              block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
              s_n, hq, hkv, bs, d, block_tables.shape[1], _DTYPES[q.dtype],
              current_stream(q.device))
    check_launch(_NAME, code)
    count_launch(_NAME)
    return out
