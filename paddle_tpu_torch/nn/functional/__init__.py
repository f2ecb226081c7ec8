"""The functional ops that `FLAGS_pallas_fused_ops` routes.

Port of paddle_tpu/nn/functional/__init__.py `rms_norm` (:366),
`fused_add_rms_norm` (:388), `rotary_position_embedding` (:1361) and
`swiglu` (:189). With the flag on (the default, as the reference's) each
takes its fused op (`ops.fused_norm`: K3, K4, K5 on CUDA tensors, their
plain versions on CPU ones); with it off, the reference's XLA composition
written in torch. The reference also gates on a TPU size threshold; the
port does not (see `ops.fused_norm`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.flags import flag
from ...ops import fused_norm


def swiglu(x, y=None):
    """silu(x) * y; with y None, x's last axis is split in two halves
    (gate, up) and the composition runs, as in the reference."""
    if y is None:
        a, b = x.chunk(2, dim=-1)
        return F.silu(a) * b
    if flag("FLAGS_pallas_fused_ops"):
        return fused_norm.swiglu_raw(x, y)
    return F.silu(x) * y


def rms_norm(x, weight=None, epsilon=1e-6, out_dtype=None):
    """rmsnorm over the last axis, times `weight` when given.
    `out_dtype=torch.float32` is the port's stand-in for the reference's
    O2 autocast of this op (its BLACK_LIST: x and weight upcast to f32,
    f32 out); None keeps the reference's dtypes without autocast."""
    if flag("FLAGS_pallas_fused_ops"):
        return fused_norm.rms_norm_raw(x, weight, epsilon, out_dtype)
    if out_dtype is not None:
        x = x.to(out_dtype)
        weight = None if weight is None else weight.to(out_dtype)
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + epsilon)).to(x.dtype)
    return out if weight is None else out * weight


def fused_add_rms_norm(x, residual, weight=None, epsilon=1e-6):
    """(normed, summed): normed = rmsnorm(x + residual) * weight, summed =
    x + residual — the pre-norm residual chain in one K3 launch when the
    flag is on."""
    if flag("FLAGS_pallas_fused_ops"):
        return fused_norm.add_rms_norm_raw(x, residual, weight, epsilon)
    summed = x + residual
    return rms_norm(summed, weight, epsilon), summed


def _rotate(a, cos, sin):
    a1, a2 = a.chunk(2, dim=-1)
    return a * cos + torch.cat([-a2, a1], dim=-1) * sin


def rotary_position_embedding(q, k, cos, sin):
    """Neox rotary on q and k [B, S, H, D] with tables broadcastable to
    them ([1, S, 1, D]); k may be None. Q and K rotate in one K4 launch
    only when they have one shape (the reference's gate: GQA, with fewer
    kv heads, takes the composition for both)."""
    if k is not None and flag("FLAGS_pallas_fused_ops") and q.dim() == 4 \
            and q.shape[-1] % 2 == 0 and q.shape == k.shape:
        return fused_norm.rope_qk_raw(q, k, cos, sin)
    return (_rotate(q, cos, sin),
            None if k is None else _rotate(k, cos, sin))
