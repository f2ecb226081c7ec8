"""Flash attention, forward and backward: the hand-written CUDA kernels,
their plain PyTorch versions, and the differentiable ops built from them.

Port of paddle_tpu/ops/pallas_attention.py: the forward (`_fwd_kernel`
through `_flash_forward_x32`, K1), the backward (`_bwd_dq_kernel` and
`_bwd_dkv_kernel` through `_flash_backward_x32`, K2), the custom VJP
`_flash` that `flash_attention_raw` calls (`FlashAttention` /
`flash_attention` here), and their varlen forms with per-batch kv lengths
(`has_lens`: K1v, K2v; the custom VJP `_flash_varlen` that
`flash_attention_varlen_raw` calls is `FlashAttentionVarlen` /
`flash_attention_varlen_raw` here). The kernels live in
csrc/flash_attention_fwd.cu and csrc/flash_attention_bwd.cu (their tile
bodies in csrc/flash_attention_tc.cuh for bf16 and
csrc/flash_attention_tiles.cuh for f32); their source notes say what
bounds them on the H100 and how their designs answer that.

Layout is the reference's [B, H, S, D]. K/V may carry fewer heads than Q
(GQA): the kernels index kv head h // (Hq / Hkv) and the dK/dV kernel sums
the q heads of its group; the plain versions repeat, as
`flash_attention_raw` does — the result is the same. Causal masking aligns
the last query row with the last key column. With `kv_lens` ([B] int32),
key columns >= kv_lens[b] are masked too. A query row that sees no key
(causal with Sq > Sk, or a sequence of length 0) gets O = 0 and LSE =
-1e30, as the TPU kernel and K1 give it, and contributes nothing to the
gradients.

Routing: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. There is no fallback. On the card the C entries route
statically, by dtype and head dim d padded to a multiple of 8
(`_tensor_core_route`):

    entry                  bf16, d <= 128     bf16, d > 128; f32
    forward (K1, K1v)      tensor cores       CUDA cores
    dQ, dK/dV (K2, K2v)    tensor cores       CUDA cores

Head dims up to 256 (`MAX_HEAD_DIM`) are taken, as the reference's kernel
takes them (it pads d to a multiple of 128). The tensor-core bodies
(csrc/flash_attention_tc.cuh) read Q, K, V and dO by TMA, so they need
16-byte-aligned tensors (`ValueError` otherwise; nothing is copied to mend
it) and a head dim that is a multiple of 8: `with_head_pad` pads other
head dims with zero columns and cuts the outputs back, the softmax scale
staying 1/sqrt of the original d (the reference pads d to 128 the same
way, `pallas_attention.py:215-218`). The CUDA-core bodies
(csrc/flash_attention_tiles.cuh) take any head dim up to 256 and any
alignment.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..amp import amp_op
from ._cuda_common import (ceil_to, check_launch, count_launch,
                           current_stream, kernel_library)

_NAME = "flash_attention_fwd"
_BWD_DQ = "flash_attention_bwd_dq"
_BWD_DKV = "flash_attention_bwd_dkv"
#: matrix products of each kernel, for the cost ledger's flops
_PRODUCTS = {_NAME: 2, _BWD_DQ: 3, _BWD_DKV: 4}
_VARLEN = {_NAME: "flash_attention_varlen_fwd",
           _BWD_DQ: "flash_attention_varlen_bwd_dq",
           _BWD_DKV: "flash_attention_varlen_bwd_dkv"}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_HEAD_DIM = 256
#: the largest padded head dim the tensor-core bodies take
TC_MAX_HEAD_DIM = 128
#: the LSE of a query row that sees no key (the TPU kernel's and K1's)
EMPTY_ROW_LSE = -1e30


def _repeat_kv(q, k, v):
    hq, hkv = q.shape[1], k.shape[1]
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
    return k, v


def _visible(sq, sk, device):
    """[Sq, Sk] bool: key column visible from query row under the causal
    mask (col <= row + Sk - Sq)."""
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    return cols <= rows + (sk - sq)


def _mask(sq, sk, device, causal, kv_lens=None):
    """Visibility of key columns from query rows, broadcastable to
    [B, H, Sq, Sk], or None when every pair is visible: the causal mask
    and, with kv_lens [B], col < kv_lens[b]."""
    vis = _visible(sq, sk, device) if causal else None
    if kv_lens is not None:
        cols = torch.arange(sk, device=device)
        inlen = (cols[None, :] < kv_lens.to(device)[:, None])[:, None, None]
        vis = inlen if vis is None else vis & inlen
    return vis


def softmax_scale(d, scale=None):
    """The softmax scale: `scale`, or 1/sqrt(d) when it is None."""
    return 1.0 / math.sqrt(d) if scale is None else scale


def attend_reference(q, k, v, vis, scale=None, residual=False):
    """Plain softmax(QK^T scale) V over [B, H, S, D] (scale 1/sqrt(D)
    unless given) with the visibility `vis` (bool, broadcastable to
    [B, Hq, Sq, Sk]; None: all visible), computed in f32 (f64 inputs in
    f64). A row that sees no key gets o = 0 and lse = -1e30. Returns (o in
    q.dtype, lse [B, Hq, Sq] in the compute dtype), and with `residual`
    also what rounding o to q.dtype dropped, in q.dtype (K1's `o_res`).
    Differentiable by torch autograd."""
    acc = torch.promote_types(q.dtype, torch.float32)
    k, v = _repeat_kv(q, k, v)
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) \
        * softmax_scale(q.shape[3], scale)
    seen = None
    if vis is not None:
        s = s.masked_fill(~vis, float("-inf"))
        # rows that see no key: softmax over a row of zeros (finite, so no
        # NaN reaches autograd), zeroed below
        seen = vis.any(dim=-1, keepdim=True)
        s = torch.where(seen, s, torch.zeros((), dtype=acc, device=q.device))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    if seen is not None:
        p = p * seen
        lse = torch.where(seen[..., 0], lse, torch.full(
            (), EMPTY_ROW_LSE, dtype=acc, device=q.device))
    oa = torch.matmul(p, v.to(acc))
    o = oa.to(q.dtype)
    if residual:
        return o, lse, (oa - o.to(acc)).to(q.dtype)
    return o, lse


def flash_attention_reference(q, k, v, causal=True, kv_lens=None,
                              scale=None, residual=False):
    """Plain PyTorch softmax(QK^T / sqrt(D)) V over [B, H, S, D] (`scale`
    in place of 1/sqrt(D) when given), computed in f32 (f64 inputs in
    f64), key columns >= kv_lens[b] masked when kv_lens ([B] int) is
    given. Returns (o in q.dtype, lse [B, Hq, Sq] in the compute dtype),
    and with `residual` o's rounding residual (`attend_reference`).
    Differentiable by torch autograd."""
    return attend_reference(q, k, v, _mask(q.shape[2], k.shape[2], q.device,
                                           causal, kv_lens), scale, residual)


def _bwd_delta(o, do, o_res=None):
    """delta = rowsum(dO * O) [B, Hq, Sq], in f32 (f64 inputs in f64), O
    taken as o + o_res when the forward's rounding residual is given (the
    forward's own f32 O: exact in the plain version and K1's CUDA-core
    body, P rounded to bf16 for PV in its tensor-core body). From a bf16 o
    alone delta is off by |dO| |O| 2^-9, which dS = P (dP - delta) cannot
    afford where dP and delta nearly cancel. The autograd Functions always
    give the residual; a direct caller without one takes o as exact."""
    acc = torch.promote_types(o.dtype, torch.float32)
    oa = o.to(acc) if o_res is None else o.to(acc) + o_res.to(acc)
    return (do.to(acc) * oa).sum(dim=-1)


def scores_reference(q, k, v, do, lse, delta, vis, scale=None):
    """What both backward kernels compute first, over the repeated kv heads
    in f32 (f64 inputs in f64): P = exp(S*scale - lse) (scale 1/sqrt(D)
    unless given), zeroed where `vis` (as in `attend_reference`) hides a
    pair, and dS = P * (dO V^T - delta). Returns (p, ds, q, k, dO, scale),
    the last four in the compute dtype."""
    acc = torch.promote_types(q.dtype, torch.float32)
    scale = softmax_scale(q.shape[3], scale)
    kr, vr = _repeat_kv(q, k, v)
    qf, kf, vf, dof = q.to(acc), kr.to(acc), vr.to(acc), do.to(acc)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - lse.to(acc)[..., None])
    if vis is not None:
        # masked (and empty-row) probabilities are zeroed, not left to
        # exp(-1e30 - lse): an empty row's lse cancels the mask value
        p = p.masked_fill(~vis, 0.0)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2))
              - delta.to(acc)[..., None])
    return p, ds, qf, kf, dof, scale


def dq_from_scores(q, scores):
    """dQ = dS K scale in q.dtype, from `scores_reference`'s output."""
    _, ds, _, kf, _, scale = scores
    return (torch.matmul(ds, kf) * scale).to(q.dtype)


def dkv_from_scores(q, k, v, scores):
    """(dK = dS^T Q scale, dV = P^T dO) in k's and v's dtypes, from
    `scores_reference`'s output, GQA summing the q heads of each kv
    head."""
    p, ds, qf, _, dof, scale = scores
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dv = torch.matmul(p.transpose(-1, -2), dof)
    b, hq = q.shape[:2]
    hkv, sk, d = k.shape[1:]
    if hq != hkv:
        dk = dk.reshape(b, hkv, hq // hkv, sk, d).sum(dim=2)
        dv = dv.reshape(b, hkv, hq // hkv, sk, d).sum(dim=2)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, causal=True,
                                     kv_lens=None, scale=None):
    """Plain version of the dQ kernel, from its inputs (delta [B, Hq, Sq]
    as `flash_attention_bwd` computes it): dQ = dS K scale, in q.dtype."""
    vis = _mask(q.shape[2], k.shape[2], q.device, causal, kv_lens)
    return dq_from_scores(q, scores_reference(q, k, v, do, lse, delta, vis,
                                              scale))


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, causal=True,
                                      kv_lens=None, scale=None):
    """Plain version of the dK/dV kernel, from its inputs: dK = dS^T Q
    scale and dV = P^T dO, GQA summing the q heads of each kv head.
    Returns (dk, dv) in k's and v's dtypes."""
    vis = _mask(q.shape[2], k.shape[2], q.device, causal, kv_lens)
    return dkv_from_scores(q, k, v, scores_reference(q, k, v, do, lse,
                                                     delta, vis, scale))


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal=True,
                                  kv_lens=None, scale=None, o_res=None):
    """Plain PyTorch flash-attention backward from the saved LSE (not
    autograd through the forward), step for step what the kernels do:
    delta = rowsum(dO * O), then with P = exp(S*scale - lse), zeroed where
    masked,
        dS = P * (dO V^T - delta);  dQ = dS K scale;  dV = P^T dO;
        dK = dS^T Q scale,
    computed in f32 (f64 inputs in f64). GQA dK/dV sum the q heads of each
    kv head (`scale` in place of 1/sqrt(D) when given; O taken as o +
    o_res when the forward's rounding residual is given). Returns (dq, dk,
    dv) in the inputs' dtypes."""
    delta = _bwd_delta(o, do, o_res)
    return (flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, causal,
                                             kv_lens, scale),
            *flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                               causal, kv_lens, scale))


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes [B, H, S, D] tensors")
    b, hq, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hq % k.shape[1]:
        raise ValueError(f"Hq {hq} is not a multiple of Hkv {k.shape[1]}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} > {MAX_HEAD_DIM} is not supported "
                         "by the kernel")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtype {q.dtype}/{k.dtype}/{v.dtype}: the kernel "
                         "takes float32, bfloat16 or float16, all alike")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash attention needs contiguous tensors")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")


def _check_lens(kv_lens, q):
    """kv_lens must be int32 [B], contiguous, on q's device."""
    if kv_lens.dtype != torch.int32 or kv_lens.shape != (q.shape[0],) \
            or not kv_lens.is_contiguous() or kv_lens.device != q.device:
        raise ValueError(f"kv_lens must be contiguous int32 [B] = "
                         f"[{q.shape[0]}] on {q.device}, got "
                         f"{kv_lens.dtype} {tuple(kv_lens.shape)} on "
                         f"{kv_lens.device}")


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _require_cuda(name, q):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")


def _entry(name, kv_lens):
    """(C entry point / counter name, extra pointer args): the varlen
    entry with the kv_lens pointer when kv_lens is given."""
    if kv_lens is None:
        return name, ()
    return _VARLEN[name], (kv_lens.data_ptr(),)


def _tensor_core_route(name, dtype, varlen, d):
    """Whether the C entry of kernel `name` (its varlen form when `varlen`)
    runs a tensor-core body on `dtype` inputs of head dim `d`: every bf16
    entry (K1, K1v, K2 and K2v dQ and dK/dV) does when d padded to a
    multiple of 8 is at most 128; f32, and bf16 above 128, run the
    CUDA-core bodies. The route depends on the dtype and head dim alone;
    `name` and `varlen` are kept so that each caller states which entry it
    asks about."""
    return dtype == torch.bfloat16 and ceil_to(d, 8) <= TC_MAX_HEAD_DIM


def _check_aligned(name, *tensors):
    """The tensor-core bodies read these tensors by TMA, which needs
    16-byte-aligned addresses (a view that starts mid-row may not be)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the bf16 kernel reads its inputs by "
                             f"TMA and needs 16-byte-aligned tensors; got an "
                             f"address {t.data_ptr() % 16} bytes past one")


def with_head_pad(run, tensors):
    """`run(*tensors, scale)` with the [..., d] `tensors` zero-padded to a
    head dim that is a multiple of 8 (the tensor-core bodies' TMA row
    stride must be a multiple of 16 bytes) and scale = 1/sqrt(d) of the
    original d, as the reference keeps it when it pads d to 128
    (`pallas_attention.py:215-218`). The 4-D results of `run` (O, dQ, dK,
    dV; not lse) are cut back to d."""
    d = tensors[0].shape[-1]
    dp = ceil_to(d, 8)
    scale = softmax_scale(d)
    if dp == d:
        return run(*tensors, scale)
    padded = [torch.nn.functional.pad(t, (0, dp - d)) for t in tensors]
    return tuple(x[..., :d].contiguous() if x.dim() == 4 else x
                 for x in run(*padded, scale))


def _launch(name, kv_lens, ptrs, q, k, causal, scale, tma=(), ints=()):
    """Launch the C entry of `name` (its varlen form with kv_lens) on the
    data pointers of `ptrs`, the shape of q [B, Hq, Sq, D] and k [B, Hkv,
    Sk, D] and the entry's own `ints`. On the tensor-core route the
    tensors `tma`, which the kernel reads by TMA, must be 16-byte
    aligned."""
    if _tensor_core_route(name, q.dtype, kv_lens is not None, q.shape[3]):
        _check_aligned(name, *tma)
    entry, lens = _entry(name, kv_lens)
    fn = getattr(kernel_library(entry), entry)
    fn.argtypes = [ctypes.c_void_p] * (len(ptrs) + len(lens)) \
        + [ctypes.c_int] * (8 + len(ints)) + [ctypes.c_float,
                                                ctypes.c_void_p]
    fn.restype = ctypes.c_int
    b, hq, sq, d = q.shape
    code = fn(*(0 if t is None else t.data_ptr() for t in ptrs), *lens, b,
              hq, k.shape[1], sq, k.shape[2], d, int(bool(causal)),
              _DTYPES[q.dtype], *ints, scale, current_stream(q.device))
    check_launch(entry, code)
    # the (row, column) pairs visited; each of the kernel's products
    # (forward 2, dQ 3, dK/dV 4) is 2 * D operations a pair and head
    sk = k.shape[2]
    pairs = sq * (sq + 1) // 2 if causal and sq == sk else sq * sk
    count_launch(entry, reads=(*ptrs, kv_lens),
                 flops=_PRODUCTS[name] * 2 * b * hq * d * pairs)


def _launch_fwd(q, k, v, causal, kv_lens, scale, residual=False):
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    res = torch.empty_like(q) if residual else None
    _launch(_NAME, kv_lens, (q, k, v, o, lse, res), q, k, causal, scale,
            tma=(q, k, v))
    return (o, lse, res) if residual else (o, lse)


def flash_attention_fwd(q, k, v, causal=True, kv_lens=None, residual=False):
    """(o, lse) for q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D], key columns >=
    kv_lens[b] masked when kv_lens ([B] int32) is given. CPU tensors take
    `flash_attention_reference`; CUDA tensors launch the kernel (K1, or
    K1v with kv_lens). With `residual`, (o, lse, o_res): o_res is what
    rounding O to q's dtype dropped (zero in f32), on every route, for
    the backward's delta from the forward's f32 O (`_bwd_delta`)."""
    if _on_cpu(q, k, v):
        return flash_attention_reference(q, k, v, causal, kv_lens,
                                         residual=residual)
    _require_cuda("flash_attention_fwd", q)
    _check(q, k, v)
    if kv_lens is not None:
        _check_lens(kv_lens, q)
    if not _tensor_core_route(_NAME, q.dtype, kv_lens is not None,
                              q.shape[3]):
        return _launch_fwd(q, k, v, causal, kv_lens,
                           softmax_scale(q.shape[3]), residual)
    return with_head_pad(
        lambda q_, k_, v_, scale: _launch_fwd(q_, k_, v_, causal, kv_lens,
                                              scale, residual),
        (q, k, v))


def check_bwd_inputs(q, k, v, o, lse, do):
    """The checks `flash_attention_bwd` (and K9's backward) make on CUDA
    inputs beyond `_check`'s."""
    _check(q, k, v)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"o {tuple(o.shape)} {o.dtype} and do "
                         f"{tuple(do.shape)} {do.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 [B, Hq, Sq], got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if not (o.is_contiguous() and do.is_contiguous()
            and lse.is_contiguous()):
        raise ValueError("flash attention needs contiguous tensors")
    if not (o.device == do.device == lse.device == q.device):
        raise ValueError("all inputs must lie on one device")


def flash_attention_bwd(q, k, v, o, lse, do, causal=True, kv_lens=None,
                        o_res=None):
    """(dq, dk, dv) of flash attention from the forward's o and lse (and
    o's rounding residual o_res, when the forward gave it) and the output
    gradient do (key columns >= kv_lens[b] masked when kv_lens is given).
    CPU tensors take `flash_attention_bwd_reference`; CUDA tensors launch
    the two K2 kernels (`flash_attention_bwd_dq`, then
    `flash_attention_bwd_dkv`; K2v's varlen entries with kv_lens), after
    delta = rowsum(dO * (o + o_res)) in f32 (plain torch, as the reference
    computes it outside its kernels; `_bwd_delta`)."""
    if _on_cpu(q, k, v, o, lse, do):
        return flash_attention_bwd_reference(q, k, v, o, lse, do, causal,
                                             kv_lens, o_res=o_res)
    _require_cuda("flash_attention_bwd", q)
    check_bwd_inputs(q, k, v, o, lse, do)
    # from the unpadded tensors: head padding adds zero columns
    delta = _bwd_delta(o, do, o_res)

    def run(q_, k_, v_, do_, scale):
        return (_launch_bwd_dq(q_, k_, v_, do_, lse, delta, causal, kv_lens,
                               scale),
                *_launch_bwd_dkv(q_, k_, v_, do_, lse, delta, causal,
                                 kv_lens, scale))

    if kv_lens is not None:
        _check_lens(kv_lens, q)
    if not any(_tensor_core_route(n, q.dtype, kv_lens is not None,
                                  q.shape[3]) for n in (_BWD_DQ, _BWD_DKV)):
        return run(q, k, v, do, softmax_scale(q.shape[3]))
    return with_head_pad(run, (q, k, v, do))


def _launch_bwd_dq(q, k, v, do, lse, delta, causal, kv_lens=None,
                   scale=None):
    """dQ by the K2 dQ kernel (K2v's with kv_lens; plain version
    `flash_attention_bwd_dq_reference`). Takes only the CUDA tensors
    `flash_attention_bwd` has checked (delta f32 [B, Hq, Sq])."""
    dq = torch.empty_like(q)
    _launch(_BWD_DQ, kv_lens, (q, k, v, do, lse, delta, dq), q, k, causal,
            softmax_scale(q.shape[3], scale), tma=(q, k, v, do))
    return dq


def pad_rows(rows, to_multiple):
    """(rows [..., Sq] padded with zero columns to a stride that is the next
    multiple of `to_multiple`, that stride)."""
    sq = rows.shape[-1]
    stride = ceil_to(sq, to_multiple)
    if stride == sq:
        return rows, stride
    return torch.nn.functional.pad(rows, (0, stride - sq)), stride


def _launch_bwd_dkv(q, k, v, do, lse, delta, causal, kv_lens=None,
                    scale=None):
    """(dK, dV) by the K2 dK/dV kernel (K2v's with kv_lens; plain version
    `flash_attention_bwd_dkv_reference`). Takes only the CUDA tensors
    `flash_attention_bwd` has checked (delta f32 [B, Hq, Sq])."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    # the tensor-core body reads lse and delta rows by TMA, whose row
    # stride is a multiple of 16 bytes: pad Sq to a multiple of 4 floats
    tc = _tensor_core_route(_BWD_DKV, q.dtype, kv_lens is not None,
                            q.shape[3])
    (lse, stride), (delta, _) = (pad_rows(t, 4 if tc else 1)
                                 for t in (lse, delta))
    _launch(_BWD_DKV, kv_lens, (q, k, v, do, lse, delta, dk, dv), q, k,
            causal, softmax_scale(q.shape[3], scale),
            tma=(q, k, v, do, lse, delta), ints=(stride,))
    return dk, dv


@torch.library.custom_op("paddle_tpu_torch::flash_attention_fwd",
                         mutates_args=())
def flash_attention_fwd_op(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        causal: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`flash_attention_fwd` with o's rounding residual, as a dispatcher
    op, so that a selective activation-checkpoint policy sees it (a ctypes
    launch is invisible to the dispatcher). Both routes carry this one
    name: the plain version for CPU tensors, K1 for CUDA ones."""
    return flash_attention_fwd(q, k, v, causal, residual=True)


@flash_attention_fwd_op.register_fake
def _(q, k, v, causal):
    return torch.empty_like(q), q.new_empty(
        q.shape[:3], dtype=torch.promote_types(q.dtype, torch.float32)), \
        torch.empty_like(q)


#: the ops whose outputs the "flash_resident" recompute policy keeps (the
#: counterpart of the reference's FLASH_RESIDUAL_NAMES): the forward's o,
#: lse and o's rounding residual, so a recomputed layer's backward never
#: runs K1 again
FLASH_RESIDUAL_OPS = (torch.ops.paddle_tpu_torch.flash_attention_fwd.default,)


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: forward `flash_attention_fwd_op` (K1,
    with o's rounding residual), backward `flash_attention_bwd` (K2) from
    the saved (q, k, v, o, lse, o_res) — the port's counterpart of the
    reference's `_flash` custom VJP, with the backward's delta taken from
    the unrounded O (`_bwd_delta`). The lse output carries no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse, res = flash_attention_fwd_op(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse, res)
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, res = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.causal, o_res=res)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal=True):
    """(o, lse) like `flash_attention_fwd`, differentiable in q, k and v.
    When no gradient is needed (under `torch.no_grad()`, or no input
    requires one) it is `flash_attention_fwd` itself: nothing is saved and
    exactly the forward kernel launches. Under `amp.auto_cast` it is the
    reference's "scaled_dot_product_attention" (a WHITE_LIST op)."""
    return amp_op("scaled_dot_product_attention", _flash_attention, q, k, v,
                  causal)


def _flash_attention(q, k, v, causal):
    if not (torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return flash_attention_fwd(q, k, v, causal)
    return FlashAttention.apply(q, k, v, causal)


class FlashAttentionVarlen(torch.autograd.Function):
    """Differentiable varlen flash attention: forward `flash_attention_fwd`
    with kv_lens (K1v, with o's rounding residual), backward
    `flash_attention_bwd` with kv_lens (K2v) from the saved (q, k, v, o,
    lse, kv_lens, o_res) — the port's counterpart of the reference's
    `_flash_varlen` custom VJP. kv_lens carries no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, causal):
        o, lse, res = flash_attention_fwd(q, k, v, causal, kv_lens,
                                          residual=True)
        ctx.save_for_backward(q, k, v, o, lse, kv_lens, res)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kv_lens, res = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.causal, kv_lens, res)
        return dq, dk, dv, None, None


def flash_attention_varlen_raw(q, k, v, kv_lens, causal=False):
    """Varlen flash attention over a padded batch: q [B, Hq, S, D], k/v
    [B, Hkv, S, D] and kv_lens [B] int32 on their device; key columns >=
    kv_lens[b] are masked inside the kernel, the causal mask ANDed in.
    Returns o [B, Hq, S, D], differentiable in q, k and v. Query rows past
    a sequence's length are computed all the same (with causal masking
    they are not zero); callers drop them. Counterpart of the reference's
    `flash_attention_varlen_raw`. Without a gradient to take it is the
    forward alone (K1v)."""
    if not (torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return flash_attention_fwd(q, k, v, causal, kv_lens)[0]
    return FlashAttentionVarlen.apply(q, k, v, kv_lens, causal)
