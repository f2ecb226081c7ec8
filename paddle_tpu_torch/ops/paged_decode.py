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

Split-K: the kernel splits each sequence's table into `decode_splits`
partitions, one block each, and merges their partial results by the
log-sum-exp rule in a second pass of the same C entry (one launch count
per call). The count comes from the table's width alone, never from
seq_lens, so the op reads nothing back from the card.
`paged_decode_split_reference` is the plain model of that arithmetic.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ._cuda_common import (ceil_to, check_launch, count_launch,
                           current_stream, kernel_library)
from .quantized import int4_unpack

_NAME = "paged_decode_attention"
#: kernel (C entry point and launch counter) of each cache format
KERNEL_NAMES = {"model": _NAME, "int8": _NAME + "_int8",
                "int4": _NAME + "_int4"}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the largest head dim the kernels take (a multiple of 8)
MAX_HEAD_DIM = 256
#: tokens of a kernel chunk: a partition is a whole number of them
CHUNK = 64
#: the fewest tokens a split takes (four chunks, which a block pipelines
#: through its ring); a table no wider runs one split
PARTITION = 256
#: the most blocks per SM the split grid grows to before partitions do
MAX_BLOCKS_PER_SM = 16


def decode_splits(pages, bs, s_n, hkv, sm_count):
    """(splits, tokens per split) of the paged-decode kernel for a block
    table [s_n, pages] of `bs`-token blocks over `hkv` kv heads on a card
    of `sm_count` SMs. Reads the table's width alone (never the lengths):
    one split per PARTITION tokens of the table, as many as the grid (hkv
    x s_n x splits blocks) takes up to MAX_BLOCKS_PER_SM blocks per SM,
    fewer and wider past that; one split covering the table when it is no
    wider than a partition. The table is shared out evenly in whole
    CHUNKs, so splits x partition covers it."""
    width = pages * bs
    if width <= PARTITION:
        return 1, ceil_to(max(width, 1), CHUNK)
    rows = max(1, s_n * hkv)
    splits = min(-(-width // PARTITION),
                 max(1, MAX_BLOCKS_PER_SM * sm_count // rows))
    part = ceil_to(-(-width // splits), CHUNK)
    return -(-width // part), part


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


def paged_decode_split_reference(q, k_cache, v_cache, block_tables,
                                 seq_lens, splits, part, k_scale=None,
                                 v_scale=None, kv_int4=False):
    """The kernel's split-K arithmetic in plain torch (f32): each of the
    `splits` partitions of `part` tokens gives its running max m, sum l
    and unnormalised accumulator over its tokens below the length (an
    empty one m = -1e30, l = 0), the quantized formats' k scale on the
    logit and v scale on the probability; the partials are combined by
    the log-sum-exp rule in split order, a row with no token giving 0.
    Returns [S, Hq, D] in q's dtype."""
    _cache_format(k_scale, kv_int4)
    s_n, hq, d = q.shape
    _, hkv, bs, _ = k_cache.shape
    pages = block_tables.shape[1]
    tabs = block_tables.clamp_min(0).long()
    k, v = k_cache[tabs], v_cache[tabs]      # [S, P, Hkv, bs(/2), D]
    if kv_int4:
        bs *= 2
        k = int4_unpack(k, bs, axis=-2)
        v = int4_unpack(v, bs, axis=-2)
    t = pages * bs
    k = k.float().transpose(2, 3).reshape(s_n, t, hkv, d)
    v = v.float().transpose(2, 3).reshape(s_n, t, hkv, d)
    rep = hq // hkv
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("shd,sthd->sht", q.float() / math.sqrt(d), k)
    probs_scale = torch.ones(s_n, t, device=q.device)
    if k_scale is not None:
        tok_block = tabs.repeat_interleave(bs, dim=1)    # [S, T]
        scores = scores * k_scale.to(q.device)[tok_block][:, None, :]
        probs_scale = v_scale.to(q.device)[tok_block]
    lens = seq_lens.to(q.device).long().clamp(0, t)
    pos = torch.arange(t, device=q.device)
    m_all, l_all, acc_all = [], [], []
    for z in range(splits):
        inside = (pos >= z * part) & (pos < (z + 1) * part)
        valid = inside[None, :] & (pos[None, :] < lens[:, None])    # [S, T]
        sc = scores.masked_fill(~valid[:, None, :], -1e30)
        m = sc.amax(dim=-1)                                         # [S, Hq]
        e = torch.exp(sc - m[..., None]) * valid[:, None, :]
        l_all.append(e.sum(dim=-1))
        m_all.append(torch.where(l_all[-1] > 0, m, -1e30))
        acc_all.append(torch.einsum("sht,sthd->shd",
                                    e * probs_scale[:, None, :], v))
    m_p, l_p = torch.stack(m_all), torch.stack(l_all)             # [Z, S, H]
    w = torch.where(l_p > 0, torch.exp(m_p - m_p.amax(dim=0)), 0.0)
    denom = (w * l_p).sum(dim=0)
    num = (w[..., None] * torch.stack(acc_all)).sum(dim=0)
    out = torch.where(denom[..., None] > 0,
                      num / denom.clamp_min(1e-30)[..., None], 0.0)
    return out.to(q.dtype)


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
    the cache format, split over `decode_splits` partitions of the
    table."""
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
    return _launch(fmt, q, k_cache, v_cache, block_tables, seq_lens,
                   k_scale, v_scale)


#: SMs of each card by device index, read once: the decode tick calls
#: the wrapper once a layer
_SM_COUNTS: dict = {}
#: the bound C entry of each cache format
_ENTRIES: dict = {}


def _sm_count(device) -> int:
    count = _SM_COUNTS.get(device.index)
    if count is None:
        count = torch.cuda.get_device_properties(device).multi_processor_count
        _SM_COUNTS[device.index] = count
    return count


def _entry(fmt):
    fn = _ENTRIES.get(fmt)
    if fn is None:
        name = KERNEL_NAMES[fmt]
        fn = getattr(kernel_library(name), name)
        fn.argtypes = [ctypes.c_void_p] * (6 if fmt == "model" else 8) \
            + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        _ENTRIES[fmt] = fn
    return fn


def _launch(fmt, q, k_cache, v_cache, block_tables, seq_lens, k_scale,
            v_scale):
    """The kernel of cache format `fmt` on checked tensors: the split
    count and partition from `decode_splits`, the workspace of the
    partials, one C entry call (the splits and their merge) and one
    launch count."""
    s_n, hq, d = q.shape
    _, hkv, bs, _ = k_cache.shape
    if fmt == "int4":
        bs *= 2                    # logical tokens per block
    pages = block_tables.shape[1]
    splits, part = decode_splits(pages, bs, s_n, hkv, _sm_count(q.device))
    out = torch.empty_like(q)
    # the partials and their (m, l), from the caching allocator
    ws = torch.empty(s_n * hq * splits * (d + 2), dtype=torch.float32,
                     device=q.device) if splits > 1 else None
    name = KERNEL_NAMES[fmt]
    scales = [] if fmt == "model" else [k_scale.data_ptr(),
                                        v_scale.data_ptr()]
    code = _entry(fmt)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), *scales,
        block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(), s_n,
        hq, hkv, bs, d, pages, _DTYPES[q.dtype], splits, part,
        None if ws is None else ws.data_ptr(), current_stream(q.device))
    check_launch(name, code)
    count_launch(name)
    return out
