"""FlashMask block-sparse attention, forward and backward: the
hand-written CUDA kernels (K9), their plain PyTorch versions, and the
differentiable op built from them.

Port of paddle_tpu/ops/pallas_attention.py `_fm_fwd_kernel`,
`_fm_bwd_dq_kernel` and `_fm_bwd_dkv_kernel` (through `_fm_forward_x32` /
`_fm_backward_x32`), their start-row prep `_fm_starts_prep`, the dense
oracle `_fm_dense_ref`, the custom VJP `_flashmask` and
`flashmask_attention_raw`. The kernels live in
csrc/flashmask_attention.cu (the tile bodies shared with K1/K2 in
csrc/flash_attention_tc.cuh and csrc/flash_attention_tiles.cuh); its
source note says what bounds them on the H100 and how the design answers
that.

Semantics (the causal LTS form): over [B, H, S, D] tensors with start
rows [B, H, Sk] int32, key column j is hidden from query rows
i >= start[b, h, j] and, causal, from rows with j > i + Sk - Sq. A row that
every column hides gets O = 0 and LSE = -1e30 (the kernels'), and a key
column no row sees gets dK = dV = 0. K9 takes Hq == Hkv, as the
reference's kernel does; `flashmask_attention_raw` raises ValueError for
the rest on every device.

Routing: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. There is no fallback. On the card the C entries route
statically, by entry, dtype and head dim d padded to a multiple of 8
(`tensor_core_route`):

    entry             bf16, d <= 128     bf16, d > 128; f32
    forward           tensor cores       CUDA cores
    dQ                tensor cores       CUDA cores
    dK/dV             tensor cores       CUDA cores

As for K1/K2 (`ops.flash_attention`), the tensor-core route pads the head
dim to a multiple of 8 (`with_head_pad`; the backward pads q, k, v and dO
once for both of its kernels), needs 16-byte-aligned inputs (`ValueError`
otherwise) and, in dK/dV, lse and delta rows padded to a multiple of 4
floats (`pad_rows`). Head dims up to 256 are taken.
"""
from __future__ import annotations

import ctypes

import torch

from ._cuda_common import (ceil_to, check_launch, count_launch,
                           current_stream, kernel_library)
from .flash_attention import (_DTYPES, _bwd_delta, _check, _check_aligned,
                              _on_cpu, _require_cuda, _tensor_core_route,
                              attend_reference, check_bwd_inputs,
                              dkv_from_scores, dq_from_scores, pad_rows,
                              scores_reference, softmax_scale, with_head_pad)

_FWD = "flashmask_fwd"
_BWD_DQ = "flashmask_bwd_dq"
_BWD_DKV = "flashmask_bwd_dkv"
#: the kernels' kv tile: smin / smax hold one entry per TILE columns
TILE = 64
#: smin of a tile with no in-range column (above any start row)
_NO_START = 2 ** 30


def tile_bounds(start_rows, sk):
    """(smin, smax) int32 [B, H, ceil(Sk / 64)]: each 64-column kv tile's
    least start row over its in-range columns and its greatest over all
    of them, padded columns counting as start 0 (hidden from every row),
    as the reference's `_fm_starts_prep` computes them per kv block. Plain
    torch, on start_rows' device: the prep the K9 wrappers run before
    their kernels."""
    b, h = start_rows.shape[:2]
    nk = -(-sk // TILE)
    pad = ceil_to(sk, TILE) - sk
    sr = torch.nn.functional.pad(start_rows.to(torch.int32), (0, pad))
    tiles = sr.view(b, h, nk, TILE)
    smax = tiles.amax(dim=-1)
    in_range = torch.arange(nk * TILE, device=sr.device).view(nk, TILE) < sk
    smin = torch.where(in_range, tiles, _NO_START).amin(dim=-1)
    return smin.to(torch.int32).contiguous(), smax.to(torch.int32).contiguous()


def _fm_mask(sq, sk, start_rows, causal):
    """[B, H, Sq, Sk] bool: key column j visible from query row i."""
    rows = torch.arange(sq, device=start_rows.device)
    vis = rows[None, None, :, None] < start_rows[:, :, None, :]
    if causal:
        cols = torch.arange(sk, device=start_rows.device)
        vis = vis & (cols[None, :] <= rows[:, None] + (sk - sq))
    return vis


def flashmask_attention_reference(q, k, v, start_rows, causal=False,
                                  residual=False):
    """Plain O(S^2) FlashMask forward over [B, H, S, D] with start rows
    [B, H, Sk], computed in f32 (f64 inputs in f64). Returns (o in q.dtype,
    lse [B, H, Sq] in the compute dtype), and with `residual` o's rounding
    residual (`attend_reference`); a row that every column hides gets o =
    0 and lse = -1e30. Differentiable by torch autograd."""
    return attend_reference(q, k, v, _fm_mask(q.shape[2], k.shape[2],
                                              start_rows, causal),
                            residual=residual)


def flashmask_bwd_dq_reference(q, k, v, do, lse, delta, start_rows,
                               causal=False):
    """Plain version of the K9 dQ kernel, from its inputs (delta =
    rowsum(dO * O) [B, H, Sq] in f32): dQ = dS K scale with P =
    exp(S*scale - lse) zeroed where hidden, in q.dtype."""
    vis = _fm_mask(q.shape[2], k.shape[2], start_rows, causal)
    return dq_from_scores(q, scores_reference(q, k, v, do, lse, delta, vis))


def flashmask_bwd_dkv_reference(q, k, v, do, lse, delta, start_rows,
                                causal=False):
    """Plain version of the K9 dK/dV kernel, from its inputs: dK = dS^T Q
    scale and dV = P^T dO. Returns (dk, dv) in k's and v's dtypes."""
    vis = _fm_mask(q.shape[2], k.shape[2], start_rows, causal)
    return dkv_from_scores(q, k, v,
                           scores_reference(q, k, v, do, lse, delta, vis))


def flashmask_attention_bwd_reference(q, k, v, o, lse, do, start_rows,
                                      causal=False, o_res=None):
    """Plain FlashMask backward from the saved LSE (not autograd through
    the forward), step for step what the kernels do: delta = rowsum(dO *
    O), O taken as o + o_res when the forward's rounding residual is
    given, then the dQ and dK/dV plain versions. Returns (dq, dk, dv)."""
    delta = _bwd_delta(o, do, o_res)
    return (flashmask_bwd_dq_reference(q, k, v, do, lse, delta, start_rows,
                                       causal),
            *flashmask_bwd_dkv_reference(q, k, v, do, lse, delta,
                                         start_rows, causal))


def _check_fm(q, k, v, start_rows):
    _check(q, k, v)
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"FlashMask takes Hq == Hkv (the reference's "
                         f"kernel indexes K by q's head), got Hq "
                         f"{q.shape[1]}, Hkv {k.shape[1]}")
    want = (q.shape[0], q.shape[1], k.shape[2])
    if start_rows.dtype != torch.int32 or tuple(start_rows.shape) != want \
            or not start_rows.is_contiguous() \
            or start_rows.device != q.device:
        raise ValueError(f"start_rows must be contiguous int32 {list(want)} "
                         f"on {q.device}, got {start_rows.dtype} "
                         f"{tuple(start_rows.shape)} on "
                         f"{start_rows.device}")


def tensor_core_route(name, dtype, d):
    """Whether the K9 C entry `name` runs a tensor-core body on `dtype`
    inputs of head dim `d`: every bf16 entry (forward, dQ, dK/dV) does
    when d padded to a multiple of 8 is at most 128; f32 and bf16 above
    128 run the CUDA-core bodies."""
    return _tensor_core_route(name, dtype, False, d)


def _launch(name, ptrs, q, k, causal, scale, ints=()):
    """Launch the K9 C entry `name` on the data pointers of `ptrs` (the
    start rows and tile bounds last, then the forward's nullable o_res;
    None passes a null pointer), the shape of q [B, H, Sq, D] and k,
    the entry's own `ints` and the softmax `scale` (1/sqrt(D) when
    None)."""
    fn = getattr(kernel_library(name), name)
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) \
        + [ctypes.c_int] * (7 + len(ints)) + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    b, h, sq, d = q.shape
    code = fn(*(0 if t is None else t.data_ptr() for t in ptrs), b, h, sq,
              k.shape[2], d, int(bool(causal)), _DTYPES[q.dtype], *ints,
              softmax_scale(d, scale), current_stream(q.device))
    check_launch(name, code)
    # the dense (row, column) pairs: the tiles a mask skips depend on the
    # start rows' values, which a cost count does not read
    products = {_FWD: 2, _BWD_DQ: 3, _BWD_DKV: 4}[name]
    count_launch(name, reads=ptrs,
                 flops=products * 2 * b * h * d * sq * k.shape[2])


def _launch_fwd(q, k, v, start_rows, smin, smax, causal, scale=None,
                residual=False):
    """(o, lse), and o_res with `residual`, by the K9 forward kernel
    (plain version `flashmask_attention_reference`). Takes only checked
    CUDA tensors and the tile bounds of `tile_bounds`; on the tensor-core
    route q, k and v must be 16-byte aligned with a head dim that is a
    multiple of 8."""
    if tensor_core_route(_FWD, q.dtype, q.shape[3]):
        _check_aligned(_FWD, q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    res = torch.empty_like(q) if residual else None
    _launch(_FWD, (q, k, v, o, lse, start_rows, smin, smax, res), q, k,
            causal, scale)
    return (o, lse, res) if residual else (o, lse)


def _launch_bwd_dq(q, k, v, do, lse, delta, start_rows, smin, smax, causal,
                   scale=None):
    """dQ by the K9 dQ kernel (plain version `flashmask_bwd_dq_reference`).
    Takes only checked CUDA tensors (delta f32 [B, H, Sq]); on the
    tensor-core route q, k, v and dO must be 16-byte aligned with a head
    dim that is a multiple of 8 (lse and delta are read by plain loads)."""
    if tensor_core_route(_BWD_DQ, q.dtype, q.shape[3]):
        _check_aligned(_BWD_DQ, q, k, v, do)
    dq = torch.empty_like(q)
    _launch(_BWD_DQ, (q, k, v, do, lse, delta, dq, start_rows, smin, smax),
            q, k, causal, scale)
    return dq


def _launch_bwd_dkv(q, k, v, do, lse, delta, start_rows, smin, smax,
                    causal, scale=None):
    """(dK, dV) by the K9 dK/dV kernel (plain version
    `flashmask_bwd_dkv_reference`). Takes only checked CUDA tensors; on
    the tensor-core route q, k, v and dO must be 16-byte aligned with a
    head dim that is a multiple of 8, and the lse and delta rows go out
    padded to a multiple of 4 floats (the body reads them by TMA)."""
    tc = tensor_core_route(_BWD_DKV, q.dtype, q.shape[3])
    (lse, stride), (delta, _) = (pad_rows(t, 4 if tc else 1)
                                 for t in (lse, delta))
    if tc:
        _check_aligned(_BWD_DKV, q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(_BWD_DKV, (q, k, v, do, lse, delta, dk, dv, start_rows, smin,
                       smax), q, k, causal, scale, ints=(stride,))
    return dk, dv


def flashmask_fwd(q, k, v, start_rows, causal=False, residual=False):
    """(o, lse) of FlashMask attention, and with `residual` (o, lse,
    o_res): what rounding O to q's dtype dropped, for the backward's delta
    (as `flash_attention_fwd` gives it). CPU tensors take
    `flashmask_attention_reference`; CUDA tensors run the tile-bounds prep
    and launch the K9 forward (on the tensor-core route with the head dim
    padded to a multiple of 8)."""
    if _on_cpu(q, k, v, start_rows):
        return flashmask_attention_reference(q, k, v, start_rows, causal,
                                             residual)
    _require_cuda("flashmask_fwd", q)
    _check_fm(q, k, v, start_rows)
    smin, smax = tile_bounds(start_rows, k.shape[2])
    if not tensor_core_route(_FWD, q.dtype, q.shape[3]):
        return _launch_fwd(q, k, v, start_rows, smin, smax, causal,
                           residual=residual)
    return with_head_pad(
        lambda q_, k_, v_, scale: _launch_fwd(q_, k_, v_, start_rows, smin,
                                              smax, causal, scale, residual),
        (q, k, v))


def flashmask_bwd(q, k, v, o, lse, do, start_rows, causal=False,
                  o_res=None):
    """(dq, dk, dv) of FlashMask attention from the forward's o and lse
    (and o's rounding residual o_res, when the forward gave it). CPU
    tensors take `flashmask_attention_bwd_reference`; CUDA tensors run
    delta = rowsum(dO * (o + o_res)) and the tile-bounds prep in plain
    torch, then
    the K9 dQ and dK/dV kernels (on the tensor-core route both under one
    `with_head_pad`, which pads q, k, v and dO to a head dim that is a
    multiple of 8 once for the two)."""
    if _on_cpu(q, k, v, o, lse, do, start_rows):
        return flashmask_attention_bwd_reference(q, k, v, o, lse, do,
                                                 start_rows, causal, o_res)
    _require_cuda("flashmask_bwd", q)
    _check_fm(q, k, v, start_rows)
    check_bwd_inputs(q, k, v, o, lse, do)
    smin, smax = tile_bounds(start_rows, k.shape[2])
    delta = _bwd_delta(o, do, o_res)
    fm = (start_rows, smin, smax, causal)

    def run(q_, k_, v_, do_, scale=None):
        return (_launch_bwd_dq(q_, k_, v_, do_, lse, delta, *fm, scale),
                *_launch_bwd_dkv(q_, k_, v_, do_, lse, delta, *fm, scale))

    if not tensor_core_route(_BWD_DQ, q.dtype, q.shape[3]):
        return run(q, k, v, do)
    return with_head_pad(run, (q, k, v, do))


class FlashMask(torch.autograd.Function):
    """Differentiable FlashMask attention: forward `flashmask_fwd` (with
    o's rounding residual), backward `flashmask_bwd` from the saved (q, k,
    v, o, lse, start_rows, o_res) — the port's counterpart of the
    reference's `_flashmask` custom VJP, with the backward's delta taken
    from the unrounded O as `FlashAttention`'s. The start rows carry no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, start_rows, causal):
        o, lse, res = flashmask_fwd(q, k, v, start_rows, causal,
                                    residual=True)
        ctx.save_for_backward(q, k, v, o, lse, start_rows, res)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, start_rows, res = ctx.saved_tensors
        dq, dk, dv = flashmask_bwd(q, k, v, o, lse, do.contiguous(),
                                   start_rows, ctx.causal, res)
        return dq, dk, dv, None, None


def flashmask_attention_raw(q, k, v, start_rows, causal=False):
    """Block-sparse FlashMask attention on [B, H, S, D] tensors with
    per-column start rows [B, H, Sk] int32 (the causal LTS form). Returns
    o [B, H, Sq, D], differentiable in q, k and v; forward and backward
    skip the kv tiles the start rows hide wholly. Raises ValueError for
    Hq != Hkv, which the reference's kernel does not take either. Without
    a gradient to take it is the forward alone."""
    if q.dim() != 4 or k.dim() != 4 or k.shape[1] != q.shape[1]:
        raise ValueError(f"flashmask_attention_raw takes [B, H, S, D] q, k "
                         f"and v with Hq == Hkv, got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if not (torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return flashmask_fwd(q, k, v, start_rows, causal)[0]
    return FlashMask.apply(q, k, v, start_rows, causal)
