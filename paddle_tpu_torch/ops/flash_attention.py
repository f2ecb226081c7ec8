"""Flash attention, forward and backward: the hand-written CUDA kernels,
their plain PyTorch versions, and the differentiable op built from them.

Port of paddle_tpu/ops/pallas_attention.py, non-varlen: the forward
(`_fwd_kernel` through `_flash_forward_x32`, K1), the backward
(`_bwd_dq_kernel` and `_bwd_dkv_kernel` through `_flash_backward_x32`,
K2), and the custom VJP `_flash` that `flash_attention_raw` calls
(`FlashAttention` / `flash_attention` here). The kernels live in
csrc/flash_attention_fwd.cu and csrc/flash_attention_bwd.cu; their source
notes say what bounds them on the H100 and how their designs answer that.

Layout is the reference's [B, H, S, D]. K/V may carry fewer heads than Q
(GQA): the kernels index kv head h // (Hq / Hkv) and the dK/dV kernel sums
the q heads of its group; the plain versions repeat, as
`flash_attention_raw` does — the result is the same. Causal masking aligns
the last query row with the last key column. A query row that sees no key
(causal with Sq > Sk) gets O = 0 and LSE = -1e30, as the TPU kernel and K1
give it, and contributes nothing to the gradients.

Routing: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. There is no fallback.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ._cuda_common import (check_launch, count_launch, current_stream,
                           kernel_library)

_NAME = "flash_attention_fwd"
_BWD_DQ = "flash_attention_bwd_dq"
_BWD_DKV = "flash_attention_bwd_dkv"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
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


def flash_attention_reference(q, k, v, causal=True):
    """Plain PyTorch softmax(QK^T / sqrt(D)) V over [B, H, S, D], computed
    in f32 (f64 inputs in f64). Returns (o in q.dtype, lse [B, Hq, Sq] in
    the compute dtype). Differentiable by torch autograd."""
    d, sq, sk = q.shape[3], q.shape[2], k.shape[2]
    acc = torch.promote_types(q.dtype, torch.float32)
    k, v = _repeat_kv(q, k, v)
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) / math.sqrt(d)
    seen = None
    if causal:
        vis = _visible(sq, sk, q.device)
        s = s.masked_fill(~vis, float("-inf"))
        if sq > sk:
            # rows that see no key: softmax over a row of zeros (finite,
            # so no NaN reaches autograd), zeroed below
            seen = vis.any(dim=-1)[:, None]                    # [Sq, 1]
            s = torch.where(seen, s, torch.zeros((), dtype=acc,
                                                 device=q.device))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    if seen is not None:
        p = p * seen
        lse = torch.where(seen[:, 0], lse, torch.full(
            (), EMPTY_ROW_LSE, dtype=acc, device=q.device))
    return torch.matmul(p, v.to(acc)).to(q.dtype), lse


def _bwd_delta(o, do):
    """delta = rowsum(dO * O) [B, Hq, Sq], in f32 (f64 inputs in f64)."""
    acc = torch.promote_types(o.dtype, torch.float32)
    return (do.to(acc) * o.to(acc)).sum(dim=-1)


def _bwd_scores(q, k, v, do, lse, delta, causal):
    """What both backward kernels compute first, over the repeated kv heads
    in f32 (f64 inputs in f64): P = exp(S*scale - lse), zeroed where masked,
    and dS = P * (dO V^T - delta). Returns (p, ds, q, k, dO, scale), the
    last four in the compute dtype."""
    d, sq, sk = q.shape[3], q.shape[2], k.shape[2]
    acc = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / math.sqrt(d)
    kr, vr = _repeat_kv(q, k, v)
    qf, kf, vf, dof = q.to(acc), kr.to(acc), vr.to(acc), do.to(acc)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - lse.to(acc)[..., None])
    if causal:
        # masked (and empty-row) probabilities are zeroed, not left to
        # exp(-1e30 - lse): an empty row's lse cancels the mask value
        p = p.masked_fill(~_visible(sq, sk, q.device), 0.0)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2))
              - delta.to(acc)[..., None])
    return p, ds, qf, kf, dof, scale


def flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, causal=True):
    """Plain version of the dQ kernel, from its inputs (delta [B, Hq, Sq]
    as `flash_attention_bwd` computes it): dQ = dS K scale, in q.dtype."""
    _, ds, _, kf, _, scale = _bwd_scores(q, k, v, do, lse, delta, causal)
    return (torch.matmul(ds, kf) * scale).to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, causal=True):
    """Plain version of the dK/dV kernel, from its inputs: dK = dS^T Q
    scale and dV = P^T dO, GQA summing the q heads of each kv head.
    Returns (dk, dv) in k's and v's dtypes."""
    p, ds, qf, _, dof, scale = _bwd_scores(q, k, v, do, lse, delta, causal)
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dv = torch.matmul(p.transpose(-1, -2), dof)
    b, hq = q.shape[:2]
    hkv, sk, d = k.shape[1:]
    if hq != hkv:
        dk = dk.reshape(b, hkv, hq // hkv, sk, d).sum(dim=2)
        dv = dv.reshape(b, hkv, hq // hkv, sk, d).sum(dim=2)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal=True):
    """Plain PyTorch flash-attention backward from the saved LSE (not
    autograd through the forward), step for step what the kernels do:
    delta = rowsum(dO * O), then with P = exp(S*scale - lse), zeroed where
    masked,
        dS = P * (dO V^T - delta);  dQ = dS K scale;  dV = P^T dO;
        dK = dS^T Q scale,
    computed in f32 (f64 inputs in f64). GQA dK/dV sum the q heads of each
    kv head. Returns (dq, dk, dv) in the inputs' dtypes."""
    delta = _bwd_delta(o, do)
    return (flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, causal),
            *flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                               causal))


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
                         "takes float32 or bfloat16, all alike")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash attention needs contiguous tensors")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _require_cuda(name, q):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")


def flash_attention_fwd(q, k, v, causal=True):
    """(o, lse) for q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D]. CPU tensors take
    `flash_attention_reference`; CUDA tensors launch the kernel."""
    if _on_cpu(q, k, v):
        return flash_attention_reference(q, k, v, causal)
    _require_cuda("flash_attention_fwd", q)
    _check(q, k, v)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    fn = kernel_library(_NAME).flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
              lse.data_ptr(), b, hq, hkv, sq, sk, d, int(bool(causal)),
              _DTYPES[q.dtype], current_stream(q.device))
    check_launch(_NAME, code)
    count_launch(_NAME)
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, causal=True):
    """(dq, dk, dv) of flash attention from the forward's o and lse and the
    output gradient do. CPU tensors take `flash_attention_bwd_reference`;
    CUDA tensors launch the two K2 kernels (`flash_attention_bwd_dq`, then
    `flash_attention_bwd_dkv`), after delta = rowsum(dO * O) in f32 (plain
    torch, as the reference computes it outside its kernels)."""
    if _on_cpu(q, k, v, o, lse, do):
        return flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
    _require_cuda("flash_attention_bwd", q)
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
    delta = _bwd_delta(o, do)
    dq = _launch_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = _launch_bwd_dkv(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


def _bwd_args(q, k, causal):
    b, hq, sq, d = q.shape
    return (b, hq, k.shape[1], sq, k.shape[2], d, int(bool(causal)),
            _DTYPES[q.dtype], current_stream(q.device))


def _launch_bwd_dq(q, k, v, do, lse, delta, causal):
    """dQ by the K2 dQ kernel (plain version
    `flash_attention_bwd_dq_reference`). Takes only the CUDA tensors
    `flash_attention_bwd` has checked (delta f32 [B, Hq, Sq])."""
    dq = torch.empty_like(q)
    fn = kernel_library(_BWD_DQ).flash_attention_bwd_dq
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
              *_bwd_args(q, k, causal))
    check_launch(_BWD_DQ, code)
    count_launch(_BWD_DQ)
    return dq


def _launch_bwd_dkv(q, k, v, do, lse, delta, causal):
    """(dK, dV) by the K2 dK/dV kernel (plain version
    `flash_attention_bwd_dkv_reference`). Takes only the CUDA tensors
    `flash_attention_bwd` has checked (delta f32 [B, Hq, Sq])."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = kernel_library(_BWD_DKV).flash_attention_bwd_dkv
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
              dv.data_ptr(), *_bwd_args(q, k, causal))
    check_launch(_BWD_DKV, code)
    count_launch(_BWD_DKV)
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: forward `flash_attention_fwd` (K1),
    backward `flash_attention_bwd` (K2) from the saved (q, k, v, o, lse) —
    the port's counterpart of the reference's `_flash` custom VJP. The lse
    output carries no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal=True):
    """(o, lse) like `flash_attention_fwd`, differentiable in q, k and v.
    When no gradient is needed (under `torch.no_grad()`, or no input
    requires one) it is `flash_attention_fwd` itself: nothing is saved and
    exactly the forward kernel launches."""
    if not (torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return flash_attention_fwd(q, k, v, causal)
    return FlashAttention.apply(q, k, v, causal)
