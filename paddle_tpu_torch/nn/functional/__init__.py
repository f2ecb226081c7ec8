"""The functional ops that `FLAGS_pallas_fused_ops` routes, and the few
plain ones the GPT and BERT forwards need beside them.

Port of paddle_tpu/nn/functional/__init__.py `rms_norm` (:366),
`fused_add_rms_norm` (:388), `layer_norm` (:326), `fused_add_layer_norm`
(:405), `fused_dropout_add` (:272), `rotary_position_embedding` (:1361)
and `swiglu` (:189). With the flag on (the default, as the reference's)
each takes its fused op (`ops.fused_norm`: K3 (RMS and LayerNorm kinds),
K4, K5, K6 on CUDA tensors, their plain versions on CPU ones); with it
off, the reference's XLA composition written in torch. The reference also
gates on a TPU size threshold; the port does not (see `ops.fused_norm`).
Plain: `dropout` (:253), `gelu` (:36) and `scaled_dot_product_attention`
(`nn/functional/attention.py`), whose unmasked, dropout-free form is the
flash op (K1 forward, K2 backward on CUDA). The varlen and FlashMask APIs
(`nn/functional/extended.py`) are in `.extended` and exported here.

Each op runs through `amp.amp_op` under the reference's op name (its
inputs cast by the AMP rule when `auto_cast` is on; one thread-local read
when it is off).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...amp import amp_op
from ...core.flags import flag
from ...ops import fused_norm
from ...ops.flash_attention import flash_attention


def _gelu(x, approximate=False):
    """x * Phi(x) (erf form), or its tanh approximation."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def gelu(x, approximate=False):
    """`_gelu` as the reference's op "gelu" (module note)."""
    return amp_op("gelu", _gelu, x, approximate)


def _keep_mask(x, p, generator):
    """A 0/1 tensor in x's dtype and shape, each element 1 with
    probability 1 - p, drawn with `generator` (torch's default generator
    of x's device when None)."""
    return torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)


def _dropout(x, p=0.5, training=True, mode="upscale_in_train",
            generator=None):
    """Zero each element with probability p and, in "upscale_in_train"
    mode, scale the kept ones by 1 / (1 - p); identity when not training
    or p == 0."""
    if not training or p == 0.0:
        return x
    keep = _keep_mask(x, p, generator).bool()
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, 0.0).to(x.dtype)


def dropout(x, p=0.5, training=True, mode="upscale_in_train",
            generator=None):
    """`_dropout` as the reference's op "dropout" (module note)."""
    return amp_op("dropout", _dropout, x, p, training, mode, generator)


def _fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      generator=None):
    """dropout(x) + y as one op: x + y, with nothing drawn, when not
    training or p == 0; else one mask drawn with `generator` and, with the
    flag on, K6 (`dropout_add_raw`: x * mask * scale + y in f32, rounded
    once), with it off the reference's composition (x * scale in x's
    dtype where kept, then + y). Both branches draw the same mask."""
    if not training or p == 0.0:
        return x + y
    scale = 1.0 / (1.0 - p) if mode == "upscale_in_train" else 1.0
    mask = _keep_mask(x, p, generator)
    if flag("FLAGS_pallas_fused_ops"):
        return fused_norm.dropout_add_raw(x, y, mask, scale)
    kept = x * x.new_full((), scale)
    return torch.where(mask.bool(), kept, 0.0).to(x.dtype) + y


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      generator=None):
    """`_fused_dropout_add` as the reference's op "fused_dropout_add" (module note)."""
    return amp_op("fused_dropout_add", _fused_dropout_add, x, y, p, training,
                  mode, generator)


def _scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """softmax(q k^T / sqrt(D) (+ mask)) v over [B, S, H, D] tensors; k/v
    may carry fewer heads than q (GQA). No mask and no dropout (p == 0 or
    not training): the differentiable flash op (K1 forward, K2 backward
    on CUDA). Otherwise the reference's plain composition `_xla_sdpa`:
    kv heads repeated, f32 softmax, probabilities in q's dtype, the mask
    (bool: True keeps; else added to the scores), then dropout on the
    probabilities with a keep mask drawn from `generator` (torch's
    default generator of q's device when None) and 1 / (1 - p) scaling."""
    p = dropout_p if training else 0.0
    if attn_mask is None and p == 0.0:
        out, _ = flash_attention(query.transpose(1, 2).contiguous(),
                                 key.transpose(1, 2).contiguous(),
                                 value.transpose(1, 2).contiguous(),
                                 causal=is_causal)
        return out.transpose(1, 2)
    q, k, v = (t.transpose(1, 2) for t in (query, key, value))
    if k.shape[1] != q.shape[1]:
        rep = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    low = torch.finfo(scores.dtype).min
    if is_causal:
        sq, sk = scores.shape[-2:]
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=scores.device).tril(sk - sq)
        scores = scores.masked_fill(~keep, low)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = torch.where(attn_mask, scores, low)
        else:
            scores = scores + attn_mask
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    if p > 0.0:
        keep = _keep_mask(probs, p, generator).bool()
        probs = torch.where(keep, probs / (1.0 - p), 0.0).to(probs.dtype)
    return (probs @ v).transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """`_scaled_dot_product_attention` as the reference's op "scaled_dot_product_attention" (module note)."""
    return amp_op("scaled_dot_product_attention",
                  _scaled_dot_product_attention, query, key, value,
                  attn_mask, dropout_p, is_causal, training, generator)


def _swiglu(x, y=None):
    """silu(x) * y; with y None, x's last axis is split in two halves
    (gate, up) and the composition runs, as in the reference."""
    if y is None:
        a, b = x.chunk(2, dim=-1)
        return F.silu(a) * b
    if flag("FLAGS_pallas_fused_ops"):
        return fused_norm.swiglu_raw(x, y)
    return F.silu(x) * y


def swiglu(x, y=None):
    """`_swiglu` as the reference's op "swiglu" (module note)."""
    return amp_op("swiglu", _swiglu, x, y)


def _fused_norm(x):
    """Whether a norm takes its fused op (K3): with the flag on, for a
    tensor with elements; an empty one takes the composition, as the
    reference's `use_pallas` sends it there."""
    return flag("FLAGS_pallas_fused_ops") and x.numel() > 0


def _rms_norm(x, weight=None, epsilon=1e-6, out_dtype=None):
    """rmsnorm over the last axis, times `weight` when given.
    `out_dtype=torch.float32` is the port's stand-in for the reference's
    O2 autocast of this op (its BLACK_LIST: x and weight upcast to f32,
    f32 out); None keeps the reference's dtypes without autocast."""
    if _fused_norm(x):
        return fused_norm.rms_norm_raw(x, weight, epsilon, out_dtype)
    if out_dtype is not None:
        x = x.to(out_dtype)
        weight = None if weight is None else weight.to(out_dtype)
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + epsilon)).to(x.dtype)
    return out if weight is None else out * weight


def rms_norm(x, weight=None, epsilon=1e-6, out_dtype=None):
    """`_rms_norm` as the reference's op "rms_norm" (module note)."""
    return amp_op("rms_norm", _rms_norm, x, weight, epsilon, out_dtype)


def _fused_add_rms_norm(x, residual, weight=None, epsilon=1e-6):
    """(normed, summed): normed = rmsnorm(x + residual) * weight, summed =
    x + residual — the pre-norm residual chain in one K3 launch when the
    flag is on."""
    if _fused_norm(x):
        return fused_norm.add_rms_norm_raw(x, residual, weight, epsilon)
    summed = x + residual
    return rms_norm(summed, weight, epsilon), summed


def fused_add_rms_norm(x, residual, weight=None, epsilon=1e-6):
    """`_fused_add_rms_norm` as the reference's op "fused_add_rms_norm" (module note)."""
    return amp_op("fused_add_rms_norm", _fused_add_rms_norm, x, residual,
                  weight, epsilon)


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
        return amp_op("rope_qk", fused_norm.rope_qk_raw, q, k, cos, sin)
    return (amp_op("rope", _rotate, q, cos, sin),
            None if k is None else amp_op("rope", _rotate, k, cos, sin))


def _layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               out_dtype=None):
    """LayerNorm over the trailing `normalized_shape` axes, times `weight`
    and plus `bias` when given. With the flag on and one normalized axis,
    K3-LN (`layer_norm_raw`); otherwise the reference's composition: f32
    mean and (two-pass) variance, the normalized value rounded to x's
    dtype, then * weight + bias. `out_dtype=torch.float32` is the port's
    stand-in for the reference's O2 autocast of this op (its BLACK_LIST:
    x, weight and bias upcast to f32, f32 out)."""
    nshape = (normalized_shape,) if isinstance(normalized_shape, int) \
        else tuple(normalized_shape)
    if len(nshape) == 1 and _fused_norm(x):
        return fused_norm.layer_norm_raw(x, weight, bias, epsilon, out_dtype)
    if out_dtype is not None:
        x = x.to(out_dtype)
        weight = None if weight is None else weight.to(out_dtype)
        bias = None if bias is None else bias.to(out_dtype)
    dims = tuple(range(-len(nshape), 0))
    xf = x.float()
    mean = xf.mean(dim=dims, keepdim=True)
    var = xf.var(dim=dims, correction=0, keepdim=True)
    out = ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               out_dtype=None):
    """`_layer_norm` as the reference's op "layer_norm" (module note)."""
    return amp_op("layer_norm", _layer_norm, x, normalized_shape, weight,
                  bias, epsilon, out_dtype)


def _fused_add_layer_norm(x, residual, weight=None, bias=None, epsilon=1e-5):
    """(normed, summed) for the LayerNorm streams (GPT's post-attention
    norm): one K3-LN launch when the flag is on, the add and `layer_norm`
    otherwise."""
    if _fused_norm(x):
        return fused_norm.add_layer_norm_raw(x, residual, weight, bias,
                                             epsilon)
    summed = x + residual
    return layer_norm(summed, summed.shape[-1:], weight, bias,
                      epsilon), summed


def fused_add_layer_norm(x, residual, weight=None, bias=None, epsilon=1e-5):
    """`_fused_add_layer_norm` as the reference's op "fused_add_layer_norm" (module note)."""
    return amp_op("fused_add_layer_norm", _fused_add_layer_norm, x,
                  residual, weight, bias, epsilon)


from .extended import (flash_attn_unpadded,  # noqa: E402,F401
                       flash_attn_varlen_qkvpacked, flashmask_attention)

from ...core.dispatch import boundary as _boundary  # noqa: E402

# the Tensor API's edge: each public op takes Tensors and returns Tensors
# (torch tensors in, torch tensors out, as before)
for _n in ("gelu", "dropout", "fused_dropout_add",
           "scaled_dot_product_attention", "swiglu", "rms_norm",
           "fused_add_rms_norm", "rotary_position_embedding", "layer_norm",
           "fused_add_layer_norm", "flash_attn_unpadded",
           "flash_attn_varlen_qkvpacked", "flashmask_attention"):
    globals()[_n] = _boundary(globals()[_n])
