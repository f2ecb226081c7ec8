"""paddle_tpu_torch.nn.functional: the reference's functional surface.

Port of paddle_tpu/nn/functional/__init__.py. Each function is an op of
the Tensor API (`core.dispatch.op`: Tensors in, Tensors out; torch
tensors in, torch tensors out; cast by the AMP rule under the reference's
op name when `auto_cast` is on), its body the reference's composition
written in torch.

Where the reference sends a call to a Pallas kernel, the port sends it to
the kernel's port (`ops.fused_norm`, `ops.flash_attention`): with
`FLAGS_pallas_fused_ops` on (the default, as the reference's) `rms_norm`,
`fused_add_rms_norm`, `layer_norm` (one normalized axis),
`fused_add_layer_norm`, two-operand `swiglu`, `fused_dropout_add` and
`rotary_position_embedding` take the fused ops (K3, K3-LN, K5, K6, K4 on
CUDA tensors, their plain versions on CPU ones); `scaled_dot_product_attention`
with no mask and no dropout takes the flash op (K1 forward, K2 backward;
`attention.py`). With the flag off they take the reference's XLA
compositions, written in torch. The reference also gates on a TPU size
threshold; the port does not (see `ops.fused_norm`). Everything else is
the composition: what XLA composed for the TPU is plain torch here.

The varlen, FlashMask and the long tail of the surface (the loss zoo,
vision sampling, fold, unpooling, fractional pooling, ...) are in
`.extended`, exported here as the reference's are.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from ...amp import amp_op
from ...core import dtype as dtypes
from ...core.dispatch import op
from ...core.flags import flag
from ...ops import fused_norm
from ...ops._helpers import inexact
from ...ops._helpers import inplace_variant as _inplace_variant
from .attention import _keep_mask
from .attention import scaled_dot_product_attention as _sdpa


# ------------------------------------------------------------ activations
@op("relu")
def relu(x, name=None):
    return torch.relu(x)


relu_ = _inplace_variant(relu)


@op("relu6")
def relu6(x, name=None):
    return F.relu6(x)


def _gelu(x, approximate=False):
    """x * Phi(x) (erf form), or its tanh approximation (an integer x in
    its width's float, as the reference's)."""
    if not x.is_floating_point():
        x = x.to(inexact(x.dtype))
    return F.gelu(x, approximate="tanh" if approximate else "none")


def gelu(x, approximate=False, name=None):
    """`_gelu` as the reference's op "gelu"."""
    return amp_op("gelu", _gelu, x, approximate)


@op("silu")
def silu(x, name=None):
    return F.silu(x)


swish = silu


@op("mish")
def mish(x, name=None):
    return x * torch.tanh(F.softplus(x))


@op("sigmoid")
def sigmoid(x, name=None):
    return torch.sigmoid(x)


@op("hardsigmoid")
def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


@op("hardswish")
def hardswish(x, name=None):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


@op("hardtanh")
def hardtanh(x, min=-1.0, max=1.0, name=None):
    return torch.clamp(x, min, max)


@op("hardshrink")
def hardshrink(x, threshold=0.5, name=None):
    return torch.where(x.abs() > threshold, x, 0.0).to(x.dtype)


@op("softshrink")
def softshrink(x, threshold=0.5, name=None):
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold,
                                   0.0)).to(x.dtype)


@op("tanhshrink")
def tanhshrink(x, name=None):
    return x - torch.tanh(x)


@op("elu")
def elu(x, alpha=1.0, name=None):
    return F.elu(x, alpha)


@op("celu")
def celu(x, alpha=1.0, name=None):
    return F.celu(x, alpha)


@op("selu")
def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772,
         name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


@op("leaky_relu")
def leaky_relu(x, negative_slope=0.01, name=None):
    return F.leaky_relu(x, negative_slope)


@op("prelu")
def prelu(x, weight, data_format="NCHW", name=None):
    if weight.numel() == 1:
        wb = weight.reshape(())
    else:
        ch = 1 if data_format == "NCHW" else x.dim() - 1
        shape = [1] * x.dim()
        shape[ch] = -1
        wb = weight.reshape(shape)
    return torch.where(x > 0, x, wb * x)


@op("rrelu")
def rrelu(x, lower=0.125, upper=0.3333333, training=False, name=None):
    """Negative inputs times a slope drawn uniformly from [lower, upper)
    while training (torch's default generator), times their mean
    otherwise."""
    if training:
        slope = torch.empty_like(x).uniform_(lower, upper)
        return torch.where(x >= 0, x, x * slope)
    return torch.where(x >= 0, x, x * ((lower + upper) / 2))


def softplus(x, beta=1, threshold=20, name=None):
    from ...ops.math import softplus as _sp

    return _sp(x, beta, threshold)


@op("softsign")
def softsign(x, name=None):
    return F.softsign(x)


@op("tanh")
def tanh(x, name=None):
    return torch.tanh(x)


@op("softmax")
def softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(dtypes.convert_dtype(dtype))
    return torch.softmax(x, axis)


softmax_ = _inplace_variant(softmax)


@op("log_softmax")
def log_softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(dtypes.convert_dtype(dtype))
    return torch.log_softmax(x, axis)


@op("gumbel_softmax")
def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """softmax((x + g) / temperature) with Gumbel noise g from torch's
    default generator; `hard`: the one-hot of the argmax with the soft
    value's gradient (straight through)."""
    u = torch.rand_like(x)
    g = -torch.log(-torch.log(u + 1e-20) + 1e-20)
    y = torch.softmax((x + g) / temperature, axis)
    if hard:
        idx = y.argmax(axis, keepdim=True)
        onehot = torch.zeros_like(y).scatter(axis, idx, 1.0)
        y = onehot + (-y).detach() + y
    return y


@op("glu")
def glu(x, axis=-1, name=None):
    a, b = x.chunk(2, dim=axis)
    return a * torch.sigmoid(b)


def _swiglu(x, y=None):
    """silu(x) * y; with y None, x's last axis is split in two halves
    (gate, up) and the composition runs, as in the reference."""
    if y is None:
        a, b = x.chunk(2, dim=-1)
        return F.silu(a) * b
    if flag("FLAGS_pallas_fused_ops"):
        return fused_norm.swiglu_raw(x, y)
    return F.silu(x) * y


def swiglu(x, y=None, name=None):
    """`_swiglu` as the reference's op "swiglu" (K5 for two operands
    with the flag on)."""
    return amp_op("swiglu", _swiglu, x, y)


@op("maxout")
def maxout(x, groups, axis=1, name=None):
    ax = axis % x.dim()
    c = x.shape[ax]
    shape = x.shape[:ax] + (c // groups, groups) + x.shape[ax + 1:]
    return x.reshape(shape).amax(ax + 1)


# ------------------------------------------------------------ linear / embed
@op("linear")
def linear(x, weight, bias=None, name=None):
    """x @ weight (+ bias), weight in Paddle's layout [in, out]."""
    return F.linear(x, weight.t(), bias)


@op("embedding")
def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of `weight` at the indices x; rows at `padding_idx` are 0 (and
    pass no gradient), as the reference's."""
    out = F.embedding(x.long(), weight)
    if padding_idx is not None:
        out = torch.where((x == padding_idx).unsqueeze(-1), 0.0,
                          out).to(out.dtype)
    return out


def one_hot(x, num_classes, name=None):
    from ...ops.manipulation import one_hot as _oh

    return _oh(x, num_classes)


@op("bilinear")
def bilinear(x1, x2, weight, bias=None, name=None):
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


# ------------------------------------------------------------ dropout
def _dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
             generator=None):
    """Zero each element (or, with `axis`, each slice along the other
    axes) with probability p and, in "upscale_in_train" mode, scale the
    kept ones by 1 / (1 - p); identity when not training or p == 0."""
    if not training or p == 0.0:
        return x
    if axis is None:
        keep = _keep_mask(x, p, generator).bool()
    else:
        axes = [a % x.dim() for a in (axis if isinstance(axis, (list, tuple))
                                       else [axis])]
        shape = [s if i in axes else 1 for i, s in enumerate(x.shape)]
        keep = torch.empty(shape, dtype=x.dtype, device=x.device).bernoulli_(
            1.0 - p, generator=generator).bool()
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, 0.0).to(x.dtype)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, generator=None):
    """`_dropout` as the reference's op "dropout"; the mask is drawn from
    `generator` (torch's default generator of x's device when None)."""
    return amp_op("dropout", _dropout, x, p, axis, training, mode, generator)


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
                      name=None, generator=None):
    """`_fused_dropout_add` as the reference's op "fused_dropout_add"."""
    return amp_op("fused_dropout_add", _fused_dropout_add, x, y, p, training,
                  mode, generator)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=axis, training=training)


@op("alpha_dropout")
def alpha_dropout(x, p=0.5, training=True, name=None):
    if not training or p == 0.0:
        return x
    alpha = -1.7580993408473766
    keep = _keep_mask(x, p, None).bool()
    q = 1.0 - p
    an = (q + alpha ** 2 * q * p) ** -0.5
    bn = -an * alpha * p
    return (torch.where(keep, x, alpha) * an + bn).to(x.dtype)


# ------------------------------------------------------------ normalization
def _fused_norm(x):
    """Whether a norm takes its fused op (K3): with the flag on, for a
    tensor with elements; an empty one takes the composition, as the
    reference's `use_pallas` sends it there."""
    return flag("FLAGS_pallas_fused_ops") and x.numel() > 0


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
               out_dtype=None, name=None):
    """`_layer_norm` as the reference's op "layer_norm"."""
    return amp_op("layer_norm", _layer_norm, x, normalized_shape, weight,
                  bias, epsilon, out_dtype)


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


def rms_norm(x, weight=None, epsilon=1e-6, out_dtype=None, name=None):
    """`_rms_norm` as the reference's op "rms_norm"."""
    return amp_op("rms_norm", _rms_norm, x, weight, epsilon, out_dtype)


def _fused_add_rms_norm(x, residual, weight=None, epsilon=1e-6):
    """(normed, summed): normed = rmsnorm(x + residual) * weight, summed =
    x + residual — the pre-norm residual chain in one K3 launch when the
    flag is on."""
    if _fused_norm(x):
        return fused_norm.add_rms_norm_raw(x, residual, weight, epsilon)
    summed = x + residual
    return rms_norm(summed, weight, epsilon), summed


def fused_add_rms_norm(x, residual, weight=None, epsilon=1e-6, name=None):
    """`_fused_add_rms_norm` as the reference's op "fused_add_rms_norm"."""
    return amp_op("fused_add_rms_norm", _fused_add_rms_norm, x, residual,
                  weight, epsilon)


def _fused_add_layer_norm(x, residual, weight=None, bias=None,
                          epsilon=1e-5):
    """(normed, summed) for the LayerNorm streams (GPT's post-attention
    norm): one K3-LN launch when the flag is on, the add and `layer_norm`
    otherwise."""
    if _fused_norm(x):
        return fused_norm.add_layer_norm_raw(x, residual, weight, bias,
                                             epsilon)
    summed = x + residual
    return layer_norm(summed, summed.shape[-1:], weight, bias,
                      epsilon), summed


def fused_add_layer_norm(x, residual, weight=None, bias=None, epsilon=1e-5,
                         name=None):
    """`_fused_add_layer_norm` as the reference's op
    "fused_add_layer_norm"."""
    return amp_op("fused_add_layer_norm", _fused_add_layer_norm, x,
                  residual, weight, bias, epsilon)


def _channel_shape(x, ch):
    shape = [1] * x.dim()
    shape[ch] = -1
    return shape


def _bn_apply(a, m, v, w, b, ch, epsilon):
    shape = _channel_shape(a, ch)
    out = (a - m.reshape(shape)) * torch.rsqrt(v.reshape(shape) + epsilon)
    if w is not None:
        out = out * w.reshape(shape)
    if b is not None:
        out = out + b.reshape(shape)
    return out


@op("batch_norm")
def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5, data_format="NCHW",
               use_global_stats=None, name=None):
    """Batch statistics while training (the running ones updated in
    place with the reference's momentum: running * momentum + batch *
    (1 - momentum), the variance unbiased), the running ones otherwise
    or with `use_global_stats`."""
    ch = 1 if data_format.startswith("NC") else x.dim() - 1
    red = tuple(i for i in range(x.dim()) if i != ch)
    if training and not use_global_stats:
        m = x.mean(red)
        v = x.var(red, correction=0)
        out = _bn_apply(x, m, v, weight, bias, ch, epsilon)
        with torch.no_grad():
            n = int(np.prod([x.shape[i] for i in red]))
            unbiased = v * (n / max(n - 1, 1))
            running_mean.mul_(momentum).add_(
                (m * (1 - momentum)).to(running_mean.dtype))
            running_var.mul_(momentum).add_(
                (unbiased * (1 - momentum)).to(running_var.dtype))
        return out
    return _bn_apply(x, running_mean.detach(), running_var.detach(), weight,
                     bias, ch, epsilon)


@op("instance_norm")
def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    ch = 1 if data_format.startswith("NC") else x.dim() - 1
    red = tuple(range(2, x.dim())) if ch == 1 else tuple(
        range(1, x.dim() - 1))
    use_running = not use_input_stats
    if use_running and (running_mean is None or running_var is None):
        raise ValueError(
            "instance_norm(use_input_stats=False) requires running_mean "
            "and running_var")
    track = not use_running and running_mean is not None \
        and running_var is not None
    shape = _channel_shape(x, ch)
    if use_running:
        m = running_mean.reshape(shape)
        v = running_var.reshape(shape)
    else:
        m = x.mean(red, keepdim=True)
        v = x.var(red, correction=0, keepdim=True)
    out = (x - m) * torch.rsqrt(v + eps)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    if track:
        stat = tuple(i for i in range(x.dim()) if i != ch)
        with torch.no_grad():
            running_mean.mul_(momentum).add_(
                (x.mean(stat) * (1 - momentum)).to(running_mean.dtype))
            running_var.mul_(momentum).add_(
                (x.var(stat, correction=0) * (1 - momentum)).to(
                    running_var.dtype))
    return out


@op("group_norm")
def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    a = x.movedim(-1, 1) if data_format == "NHWC" else x
    n, c = a.shape[0], a.shape[1]
    ag = a.reshape((n, num_groups, c // num_groups) + tuple(a.shape[2:]))
    axes = tuple(range(2, ag.dim()))
    m = ag.mean(axes, keepdim=True)
    v = ag.var(axes, correction=0, keepdim=True)
    out = ((ag - m) * torch.rsqrt(v + epsilon)).reshape(a.shape)
    shape = [1, -1] + [1] * (a.dim() - 2)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out.movedim(1, -1) if data_format == "NHWC" else out


@op("local_response_norm")
def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """x / (k + alpha * sum of the squares over a window of `size`
    channels) ** beta (the reference's composition: alpha is not divided
    by size)."""
    ch = 1 if data_format.startswith("NC") else x.dim() - 1
    sq = x.square()
    pads = [0, 0] * x.dim()
    j = x.dim() - 1 - ch
    pads[2 * j], pads[2 * j + 1] = size // 2, (size - 1) // 2
    sqp = F.pad(sq, pads)
    win = sum(sqp.narrow(ch, i, x.shape[ch]) for i in range(size))
    return x / torch.pow(k + alpha * win, beta)


@op("normalize")
def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    n = torch.pow(torch.sum(torch.pow(x.abs(), p), dim=axis, keepdim=True),
                  1.0 / p)
    return x / torch.clamp_min(n, epsilon)


# ------------------------------------------------------------ conv / pool
def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(int(i) for i in v)
    return (int(v),) * n


def _to_nc(x, data_format):
    """x in channel-first layout (a permuted view for channel-last)."""
    return x if data_format.startswith("NC") else x.movedim(-1, 1)


def _from_nc(x, data_format):
    return x if data_format.startswith("NC") else x.movedim(1, -1)


def _conv_pads(x, weight, stride, padding, dilation, nd):
    """(x padded where the padding is uneven or "SAME", torch padding):
    XLA's conv padding rules ("SAME", "VALID", ints, per-dim ints, pairs
    or 2 * nd values, first spatial dim first) in torch's terms."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return x, (0,) * nd
        pairs = []
        for i in range(nd):
            size, k = x.shape[2 + i], weight.shape[2 + i]
            out = -(-size // stride[i])
            total = max((out - 1) * stride[i] + (k - 1) * dilation[i] + 1
                        - size, 0)
            pairs.append((total // 2, total - total // 2))
    elif isinstance(padding, (list, tuple)) and padding and \
            isinstance(padding[0], (list, tuple)):
        pairs = [tuple(int(v) for v in pp) for pp in padding]
    else:
        p = _pair(padding, nd)
        if len(p) == nd:
            return x, p
        pairs = [(p[2 * i], p[2 * i + 1]) for i in range(nd)]
    if all(a == b for a, b in pairs):
        return x, tuple(a for a, _ in pairs)
    flat = [v for a, b in pairs[::-1] for v in (a, b)]
    return F.pad(x, flat), (0,) * nd


def f32_exact(x):
    """The context a convolution of x runs in: for f32 CUDA tensors,
    cuDNN without TF32 (torch's default lets cuDNN round f32 operands to
    TF32, 2^-11 relative, which the reference's f32 convolution and the
    CPU do not)."""
    if x.is_cuda and x.dtype == torch.float32:
        c = torch.backends.cudnn
        return c.flags(enabled=c.enabled, benchmark=c.benchmark,
                       deterministic=c.deterministic, allow_tf32=False)
    return contextlib.nullcontext()


class _ExactConv(torch.autograd.Function):
    """aten's convolution with its forward and backward under
    `f32_exact` (the backward runs outside any context the forward was
    called in)."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, dilation, transposed,
                output_padding, groups):
        ctx.args = (stride, padding, dilation, transposed, output_padding,
                    groups)
        ctx.has_bias = b is not None
        ctx.save_for_backward(x, w)
        with f32_exact(x):
            return torch.ops.aten.convolution(x, w, b, *ctx.args)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        with f32_exact(x):
            gx, gw, gb = torch.ops.aten.convolution_backward(
                g.contiguous(), x, w, [w.shape[0 if not ctx.args[3] else 1]
                                       * (ctx.args[5] if ctx.args[3] else 1)]
                if ctx.has_bias else None, *ctx.args,
                [need[0], need[1], ctx.has_bias and need[2]])
        return gx, gw, gb, None, None, None, None, None, None


def convolution(x, w, b, stride, padding, dilation, transposed=False,
                output_padding=0, groups=1):
    """N-d convolution (or its transpose) in torch's terms; f32 CUDA
    inputs go through `_ExactConv` (no TF32 either way)."""
    nd = x.dim() - 2
    args = (list(_pair(stride, nd)), list(_pair(padding, nd)),
            list(_pair(dilation, nd)), transposed,
            list(_pair(output_padding, nd)), groups)
    if x.is_cuda and x.dtype == torch.float32:
        return _ExactConv.apply(x, w, b, *args)
    return torch.ops.aten.convolution(x, w, b, *args)


def _conv_nd(x, weight, bias, stride, padding, dilation, groups,
             data_format, nd):
    st, dl = _pair(stride, nd), _pair(dilation, nd)
    a = _to_nc(x, data_format)
    a, pd = _conv_pads(a, weight, st, padding, dl, nd)
    return _from_nc(convolution(a, weight, bias, st, pd, dl, False, 0,
                                groups), data_format)


@op("conv1d")
def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    data_format, 1)


@op("conv2d")
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    data_format, 2)


@op("conv3d")
def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups,
                    data_format, 3)


@op("conv2d_transpose")
def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCHW", output_size=None, name=None):
    """Weight [in, out / groups, kh, kw] (Paddle's conv_transpose
    layout)."""
    out = convolution(_to_nc(x, data_format), weight, bias, stride,
                      padding, dilation, True, output_padding, groups)
    return _from_nc(out, data_format)


def _pool_nc(x, data_format, fn):
    return _from_nc(fn(_to_nc(x, data_format)), data_format)


_MAX = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _pool(x, kernel, stride, padding, nd, kind, data_format,
          ceil_mode=False, exclusive=True, divisor_override=None):
    """Max or average pooling (the reference's windows and counts are
    torch's: a ceil-mode window that would start in the right padding is
    dropped; `exclusive` counts only real elements)."""
    ks = _pair(kernel, nd)
    st = _pair(stride if stride is not None else kernel, nd)
    pd = _pair(padding, nd)
    if kind == "max":
        return _pool_nc(x, data_format, lambda a: _MAX[nd](
            a, ks, st, pd, ceil_mode=ceil_mode))
    kw = {} if nd == 1 else {"divisor_override": divisor_override}
    if x.dtype == torch.int32:
        # torch pools int64, not int32; the reference keeps the dtype
        return _pool(x.long(), kernel, stride, padding, nd, kind,
                     data_format, ceil_mode, exclusive,
                     divisor_override).to(torch.int32)
    return _pool_nc(x, data_format, lambda a: _AVG[nd](
        a, ks, st, pd, ceil_mode=ceil_mode, count_include_pad=not exclusive,
        **kw))


def _max_with_mask(x, kernel, stride, padding, nd, ceil_mode):
    """(out, mask): the argmax position of each window flattened over the
    input's spatial dims (int32, the format max_unpool* reads)."""
    ks = _pair(kernel, nd)
    st = _pair(stride if stride is not None else kernel, nd)
    out, idx = _MAX[nd](x, ks, st, _pair(padding, nd), ceil_mode=ceil_mode,
                        return_indices=True)
    return out, idx.to(torch.int32)


def _max_pool(nd, default_format):
    opname = f"max_pool{nd}d"

    @op(opname)
    def pool(x, kernel_size, stride=None, padding=0, ceil_mode=False,
             data_format=default_format):
        return _pool(x, kernel_size, stride, padding, nd, "max", data_format,
                     ceil_mode)

    @op(f"{opname}_with_index")
    def with_mask(x, kernel_size, stride=None, padding=0, ceil_mode=False):
        return _max_with_mask(x, kernel_size, stride, padding, nd, ceil_mode)

    def max_pool(x, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format=default_format, name=None):
        if return_mask:
            if not data_format.startswith("NC"):
                raise ValueError(f"{opname}(return_mask=True) requires "
                                 f"{default_format}")
            return with_mask(x, kernel_size, stride, padding, ceil_mode)
        return pool(x, kernel_size, stride, padding, ceil_mode, data_format)

    max_pool.__name__ = max_pool.__qualname__ = opname
    return max_pool


max_pool1d = _max_pool(1, "NCL")
max_pool2d = _max_pool(2, "NCHW")
max_pool3d = _max_pool(3, "NCDHW")


@op("avg_pool1d")
def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool(x, kernel_size, stride, padding, 1, "avg", data_format,
                 ceil_mode, exclusive)


def _check_divisor(divisor_override):
    if divisor_override is not None and float(divisor_override) <= 0:
        raise ValueError("divisor_override must be > 0")


@op("avg_pool2d")
def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    _check_divisor(divisor_override)
    return _pool(x, kernel_size, stride, padding, 2, "avg", data_format,
                 ceil_mode, exclusive, divisor_override)


@op("avg_pool3d")
def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    _check_divisor(divisor_override)
    return _pool(x, kernel_size, stride, padding, 3, "avg", data_format,
                 ceil_mode, exclusive, divisor_override)


_ADAPTIVE = {("avg", 1): F.adaptive_avg_pool1d,
             ("avg", 2): F.adaptive_avg_pool2d,
             ("avg", 3): F.adaptive_avg_pool3d,
             ("max", 1): F.adaptive_max_pool1d,
             ("max", 2): F.adaptive_max_pool2d,
             ("max", 3): F.adaptive_max_pool3d}


def _adaptive_pool(x, output_size, nd, kind, data_format, mask=False):
    """Adaptive pooling: window o of a dim covers [floor(o * in / O),
    ceil((o + 1) * in / O)) (torch's windows and the reference's); a None
    size keeps the dim."""
    a = _to_nc(x, data_format)
    size = tuple(int(a.shape[2 + i]) if o is None else int(o)
                 for i, o in enumerate(_pair_none(output_size, nd)))
    fn = _ADAPTIVE[(kind, nd)]
    if mask:
        out, idx = fn(a, size if nd > 1 else size[0], return_indices=True)
        return out, idx.to(torch.int32)
    return _from_nc(fn(a, size if nd > 1 else size[0]), data_format)


def _pair_none(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(None if i is None else int(i) for i in v)
    return (None if v is None else int(v),) * n


def _adaptive(kind, nd, default_format):
    @op(f"adaptive_{kind}_pool{nd}d")
    def pool(x, output_size, data_format=default_format):
        return _adaptive_pool(x, output_size, nd, kind, data_format)

    return pool


_aap1 = _adaptive("avg", 1, "NCL")
_aap2 = _adaptive("avg", 2, "NCHW")
_aap3 = _adaptive("avg", 3, "NCDHW")
_amp1 = _adaptive("max", 1, "NCL")
_amp2 = _adaptive("max", 2, "NCHW")
_amp3 = _adaptive("max", 3, "NCDHW")


def _adaptive_max_mask(x, output_size, nd):
    return _ADAPTIVE_MASK[nd](x, output_size)


def _adaptive_mask_op(nd):
    @op(f"adaptive_max_pool{nd}d_with_index")
    def pool(x, output_size):
        return _adaptive_pool(x, output_size, nd, "max", "NC", mask=True)

    return pool


_ADAPTIVE_MASK = {nd: _adaptive_mask_op(nd) for nd in (1, 2, 3)}


def adaptive_avg_pool1d(x, output_size, name=None):
    return _aap1(x, output_size, "NCL")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _aap2(x, output_size, data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _aap3(x, output_size, data_format)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    if return_mask:
        return _adaptive_max_mask(x, output_size, 1)
    return _amp1(x, output_size, "NCL")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    if return_mask:
        return _adaptive_max_mask(x, output_size, 2)
    return _amp2(x, output_size, "NCHW")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    if return_mask:
        return _adaptive_max_mask(x, output_size, 3)
    return _amp3(x, output_size, "NCDHW")


@op("unfold")
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: [N, C, H, W] -> [N, C * kh * kw, L]."""
    from .extended import _integral

    return _integral(x, lambda a: F.unfold(
        a, _pair(kernel_sizes), _pair(dilations), _pair(paddings),
        _pair(strides)))


# ------------------------------------------------------------ padding / resize
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """Paddle's nn.functional.pad: a list of 2 * (ndim - 2) values pads
    the spatial dims, pair i the i-th spatial dim from the end; any other
    list is the tensor-level `pad`."""
    from ...ops.manipulation import pad as _pad

    if isinstance(pad, (list, tuple)) and len(pad) == 2 * (x.ndim - 2) \
            and x.ndim >= 3:
        nd = x.ndim
        width = [(0, 0)] * nd
        last = nd - 1 if data_format.startswith("NC") else nd - 2
        for i in range(len(pad) // 2):
            width[last - i] = (int(pad[2 * i]), int(pad[2 * i + 1]))
        return _pad(x, [v for pr in width for v in pr], mode=mode,
                    value=value)
    return _pad(x, pad, mode=mode, value=value)


def _resample_taps(in_s, out_s, mode, align_corners, align_mode):
    """Per-dim taps [(index[out], weight[out]), ...] of separable
    resampling, as the reference's (`align_corners`: src = i * (in - 1) /
    (out - 1); `align_mode` 1: src = i * in / out; else half-pixel)."""
    i = np.arange(out_s, dtype=np.float64)
    if align_corners:
        src = i * ((in_s - 1) / max(out_s - 1, 1))
    elif align_mode == 1 and mode in ("linear", "bilinear", "trilinear"):
        src = i * (in_s / out_s)
    else:
        src = (i + 0.5) * (in_s / out_s) - 0.5
    if mode == "nearest":
        idx = np.round(src) if align_corners else np.floor(i * (in_s / out_s))
        return [(np.clip(idx, 0, in_s - 1).astype(np.int64),
                 np.ones(out_s))]
    if mode in ("linear", "bilinear", "trilinear"):
        i0 = np.floor(src)
        frac = src - i0
        return [(np.clip(i0, 0, in_s - 1).astype(np.int64), 1.0 - frac),
                (np.clip(i0 + 1, 0, in_s - 1).astype(np.int64), frac)]
    if mode == "bicubic":
        a = -0.75

        def w(d):
            d = np.abs(d)
            return np.where(
                d <= 1, ((a + 2) * d - (a + 3)) * d * d + 1,
                np.where(d < 2, (((d - 5) * d + 8) * d - 4) * a, 0.0))

        i0 = np.floor(src)
        return [(np.clip(i0 + t, 0, in_s - 1).astype(np.int64),
                 w(src - (i0 + t))) for t in range(-1, 3)]
    raise ValueError(f"interpolate: unsupported mode {mode!r}")


@op("interpolate")
def _interpolate(x, out_sz, mode, align_corners, align_mode, nchw):
    nd = x.dim() - 2
    a = x if nchw else x.movedim(-1, 1)
    spatial = a.shape[2:]
    for d in range(nd):
        ax = 2 + d
        acc = None
        for idx, w in _resample_taps(int(spatial[d]), out_sz[d], mode,
                                     align_corners, align_mode):
            g = a.index_select(ax, torch.as_tensor(idx, device=a.device))
            wshape = [1] * g.dim()
            wshape[ax] = -1
            term = g * torch.as_tensor(w, dtype=g.dtype,
                                       device=g.device).reshape(wshape)
            acc = term if acc is None else acc + term
        a = acc
    return a if nchw else a.movedim(1, -1)


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    nchw = data_format.startswith("NC")
    nd = x.ndim - 2
    spatial = tuple(int(s) for s in (x.shape[2:] if nchw else x.shape[1:-1]))
    if size is not None:
        out_sz = _pair_none(size, nd)
        out_sz = tuple(spatial[i] if out_sz[i] is None else out_sz[i]
                       for i in range(nd))
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else [scale_factor] * nd
        out_sz = tuple(int(s * f) for s, f in zip(spatial, sf))
    if mode == "area":
        # area is adaptive average pooling, as the reference routes it
        if nchw:
            return {1: _aap1, 2: _aap2, 3: _aap3}[nd](x, out_sz, "NC")
        return _area_channel_last(x, out_sz, nd)
    return _interpolate(x, out_sz, mode, align_corners, align_mode, nchw)


def _area_channel_last(x, out_sz, nd):
    from ...ops.manipulation import transpose

    perm_in = [0, nd + 1] + list(range(1, nd + 1))
    perm_out = [0] + list(range(2, nd + 2)) + [1]
    pool = {1: _aap1, 2: _aap2, 3: _aap3}[nd]
    return transpose(pool(transpose(x, perm_in), out_sz, "NC"), perm_out)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


@op("pixel_shuffle")
def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor
    a = x if data_format == "NCHW" else x.movedim(-1, 1)
    n, c, h, w = a.shape
    out = a.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    out = out.reshape(n, c // (r * r), h * r, w * r)
    return out if data_format == "NCHW" else out.movedim(1, -1)


@op("pixel_unshuffle")
def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = downscale_factor
    a = x if data_format == "NCHW" else x.movedim(-1, 1)
    n, c, h, w = a.shape
    out = a.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
    out = out.reshape(n, c * r * r, h // r, w // r)
    return out if data_format == "NCHW" else out.movedim(1, -1)


# ------------------------------------------------------------ losses
def _reduce(v, reduction):
    if reduction == "mean":
        return v.mean()
    if reduction == "sum":
        return v.sum()
    return v


@op("mse_loss")
def mse_loss(input, label, reduction="mean", name=None):
    return _reduce((input - label).square(), reduction)


@op("l1_loss")
def l1_loss(input, label, reduction="mean", name=None):
    return _reduce((input - label).abs(), reduction)


@op("smooth_l1_loss")
def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    d = (input - label).abs()
    loss = torch.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta))
    return _reduce(loss, reduction)


@op("cross_entropy")
def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """The reference's cross entropy: hard labels (ignore_index, class
    weights: "mean" divides by the weights of the valid labels) or soft
    ones (a label of the logits' shape), label smoothing, log_softmax or,
    without `use_softmax`, log of probabilities. The logits alone get a
    gradient."""
    if weight is not None:
        weight = weight.detach()
    lp = torch.log_softmax(input, axis) if use_softmax \
        else torch.log(torch.clamp_min(input, 1e-30))
    if soft_label or (label.dim() == input.dim()
                      and label.shape == input.shape):
        tgt = label.detach()
        if label_smoothing:
            tgt = tgt * (1 - label_smoothing) + label_smoothing / \
                input.shape[axis]
        return _reduce(-(tgt * lp).sum(axis), reduction)
    li = label
    if li.dim() == input.dim():
        li = li.squeeze(axis)
    valid = li != ignore_index
    safe = torch.where(valid, li, 0).long()
    picked = lp.gather(axis % lp.dim(), safe.unsqueeze(axis % lp.dim())) \
        .squeeze(axis % lp.dim())
    if label_smoothing:
        loss = -(1 - label_smoothing) * picked - label_smoothing * \
            lp.mean(axis)
    else:
        loss = -picked
    loss = torch.where(valid, loss, 0.0).to(lp.dtype)
    if weight is not None:
        wt = weight[safe.clamp(0, weight.shape[0] - 1)]
        wv = torch.where(valid, wt, 0.0).to(wt.dtype)
        loss = loss * wv
        if reduction == "mean":
            return loss.sum() / torch.clamp_min(wv.sum(), 1e-12)
    if reduction == "mean":
        return loss.sum() / torch.clamp_min(valid.sum().to(loss.dtype), 1.0)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1, name=None):
    from ...ops.manipulation import unsqueeze

    loss = unsqueeze(cross_entropy(logits, label, soft_label=soft_label,
                                   ignore_index=ignore_index,
                                   reduction="none", axis=axis), axis)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    return cross_entropy(input, label, weight=weight,
                         ignore_index=ignore_index, reduction=reduction,
                         use_softmax=False, soft_label=False)


@op("binary_cross_entropy")
def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    label = label.detach()
    eps = 1e-12
    loss = -(label * torch.log(torch.clamp_min(input, eps))
             + (1 - label) * torch.log(torch.clamp_min(1 - input, eps)))
    if weight is not None:
        loss = loss * weight.detach()
    return _reduce(loss, reduction)


@op("bce_with_logits")
def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    b = label.detach()
    base = torch.clamp_min(logit, 0) - logit * b + torch.log1p(
        torch.exp(-logit.abs()))
    if pos_weight is not None:
        pw = pos_weight.detach()
        base = -(pw * b * -F.softplus(-logit) + (1 - b) * -F.softplus(logit))
    if weight is not None:
        base = base * weight.detach()
    return _reduce(base, reduction)


@op("kl_div")
def kl_div(input, label, reduction="mean", log_target=False, name=None):
    if log_target:
        loss = torch.exp(label) * (label - input)
    else:
        loss = label * (torch.log(torch.clamp_min(label, 1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


@op("cosine_similarity")
def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    num = (x1 * x2).sum(axis)
    den = torch.clamp_min(torch.linalg.vector_norm(x1, dim=axis)
                          * torch.linalg.vector_norm(x2, dim=axis), eps)
    return num / den


@op("cosine_embedding_loss")
def cosine_embedding_loss(input1, input2, label, margin=0, reduction="mean",
                          name=None):
    cos = (input1 * input2).sum(-1) / torch.clamp_min(
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1), 1e-12)
    loss = torch.where(label == 1, 1 - cos, torch.clamp_min(cos - margin, 0))
    return _reduce(loss, reduction)


@op("margin_ranking_loss")
def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _reduce(torch.clamp_min(-label.detach() * (input - other)
                                   + margin, 0), reduction)


def _pdist(a, b, p, epsilon):
    return torch.pow(torch.pow((a - b).abs() + epsilon, p).sum(-1), 1 / p)


@op("triplet_margin_loss")
def triplet_margin_loss(input, positive, negative, margin=1.0, p=2,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    dp = _pdist(input, positive, p, epsilon)
    dn = _pdist(input, negative, p, epsilon)
    if swap:
        dn = torch.minimum(dn, _pdist(positive, negative, p, epsilon))
    return _reduce(torch.clamp_min(dp - dn + margin, 0), reduction)


@op("hinge_embedding_loss")
def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    return _reduce(torch.where(label == 1, input,
                               torch.clamp_min(margin - input, 0)), reduction)


@op("sigmoid_focal_loss")
def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    y = label.detach()
    p = torch.sigmoid(logit)
    ce = torch.clamp_min(logit, 0) - logit * y + torch.log1p(
        torch.exp(-logit.abs()))
    pt = p * y + (1 - p) * (1 - y)
    at = alpha * y + (1 - alpha) * (1 - y)
    loss = at * torch.pow(1 - pt, gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer.detach()
    return _reduce(loss, reduction)


@op("square_error_cost")
def square_error_cost(input, label, name=None):
    return (input - label).square()


@op("log_loss")
def log_loss(input, label, epsilon=1e-4, name=None):
    return -label * torch.log(input + epsilon) - (1 - label) * torch.log(
        1 - input + epsilon)


@op("ctc_loss")
def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False, name=None):
    """CTC over logits [max_T, B, C] (the reference normalizes them with
    log_softmax, as optax does) and labels [B, max_U]; "mean" divides
    each loss by its label length first, as Paddle's."""
    lsm = torch.log_softmax(log_probs.float(), -1)
    tl, ul = input_lengths.long(), label_lengths.long()
    losses = F.ctc_loss(lsm, labels.long(), tl, ul, blank=blank,
                        reduction="none").to(log_probs.dtype)
    if norm_by_times:
        losses = losses / torch.clamp_min(tl, 1).to(losses.dtype)
    if reduction == "mean":
        return (losses / torch.clamp_min(ul, 1).to(losses.dtype)).mean()
    if reduction == "sum":
        return losses.sum()
    return losses


# ------------------------------------------------------------ attention
def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, generator=None):
    """Attention over [B, S, H, D] (`attention.py`): the flash op (K1
    forward, K2 backward on CUDA) with no mask and no dropout, the
    reference's composition otherwise."""
    return _sdpa(query, key, value, attn_mask, dropout_p, is_causal,
                 training, generator)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, rng_name="",
                    training=True, name=None):
    out = scaled_dot_product_attention(query, key, value, None, dropout,
                                       causal, training)
    if return_softmax:
        from .extended import _dense_softmax_weights

        return out, _dense_softmax_weights(query, key, causal)
    return out, None


# ------------------------------------------------------------ rotary
def _rotate(a, cos, sin):
    a1, a2 = a.chunk(2, dim=-1)
    return a * cos + torch.cat([-a2, a1], dim=-1) * sin


def rotary_position_embedding(q, k, cos, sin, name=None):
    """Neox rotary on q and k [B, S, H, D] with tables broadcastable to
    them ([1, S, 1, D]); k may be None. Q and K rotate in one K4 launch
    only when they have one shape (the reference's gate: GQA, with fewer
    kv heads, takes the composition for both)."""
    if k is not None and flag("FLAGS_pallas_fused_ops") and q.dim() == 4 \
            and q.shape[-1] % 2 == 0 and q.shape == k.shape:
        return amp_op("rope_qk", fused_norm.rope_qk_raw, q, k, cos, sin)
    return (amp_op("rope", _rotate, q, cos, sin),
            None if k is None else amp_op("rope", _rotate, k, cos, sin))


# ------------------------------------------------------------ misc
@op("label_smooth")
def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


@op("temporal_shift")
def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    a = x if data_format == "NCHW" else x.movedim(-1, 1)
    nt, c, h, w = a.shape
    v = a.reshape(nt // seg_num, seg_num, c, h, w)
    fold = int(c * shift_ratio)
    left = torch.cat([v[:, 1:, :fold], torch.zeros_like(v[:, :1, :fold])], 1)
    right = torch.cat([torch.zeros_like(v[:, :1, fold:2 * fold]),
                       v[:, :-1, fold:2 * fold]], 1)
    out = torch.cat([left, right, v[:, :, 2 * fold:]], 2).reshape(nt, c, h, w)
    return out if data_format == "NCHW" else out.movedim(1, -1)


def linear_compat(x, weight, bias=None, name=None):
    return linear(x, weight, bias)


def embedding_renorm_(*args, **kwargs):
    raise NotImplementedError("embedding_renorm_: the reference does not "
                              "implement it either")


@op("sequence_mask", n_diff=0)
def sequence_mask(lengths, maxlen=None, dtype="int64", name=None):
    m = maxlen or int(lengths.max())
    return (torch.arange(m, device=lengths.device)
            < lengths.unsqueeze(-1)).to(dtypes.convert_dtype(dtype))


def class_center_sample(*args, **kwargs):
    raise NotImplementedError("class_center_sample: planned in the "
                              "reference too")


@op("npair_loss")
def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    sim = anchor @ positive.t()
    tgt = (labels[:, None] == labels[None, :]).to(anchor.dtype)
    tgt = tgt / tgt.sum(1, keepdim=True)
    ce = (-tgt * torch.log_softmax(sim, -1)).sum(-1).mean()
    reg = l2_reg * ((anchor * anchor).sum(-1).mean()
                    + (positive * positive).sum(-1).mean()) / 2
    return ce + reg


from .extended import (  # noqa: E402,F401
    adaptive_log_softmax_with_loss, affine_grid, channel_shuffle,
    conv1d_transpose, conv3d_transpose, dice_loss, elu_,
    feature_alpha_dropout, flash_attn_qkvpacked, flash_attn_unpadded,
    flash_attn_varlen_qkvpacked, flashmask_attention, fold,
    fractional_max_pool2d, fractional_max_pool3d, gather_tree,
    gaussian_nll_loss, grid_sample, hardtanh_, hsigmoid_loss, leaky_relu_,
    log_sigmoid, lp_pool1d, lp_pool2d, margin_cross_entropy, max_unpool1d,
    max_unpool2d, max_unpool3d, multi_label_soft_margin_loss,
    multi_margin_loss, pairwise_distance, poisson_nll_loss, rnnt_loss,
    soft_margin_loss, sparse_attention, tanh_, thresholded_relu,
    thresholded_relu_, triplet_margin_with_distance_loss, zeropad2d)

from ...core.dispatch import boundary as _boundary  # noqa: E402

# the Tensor API's edge for the ops that run their own `amp_op`: Tensors
# in, Tensors out (torch tensors in, torch tensors out)
for _n in ("gelu", "dropout", "fused_dropout_add",
           "scaled_dot_product_attention", "swiglu", "rms_norm",
           "fused_add_rms_norm", "rotary_position_embedding", "layer_norm",
           "fused_add_layer_norm", "flash_attn_unpadded",
           "flash_attn_varlen_qkvpacked", "flashmask_attention"):
    globals()[_n] = _boundary(globals()[_n])
