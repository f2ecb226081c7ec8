"""The long tail of nn.functional, and the varlen and FlashMask attention
APIs.

Port of paddle_tpu/nn/functional/extended.py. The long tail (activations
and their in-place twins, channel shuffle, zero padding, pairwise
distance, feature alpha dropout, fold, Lp pooling, max unpooling,
fractional max pooling, the 1-D and 3-D transposed convolutions, affine
grids and grid sampling, the loss zoo, RNN-T, gather_tree and the packed
attention wrapper) is the reference's composition written in torch, each
an op of the Tensor API (`core.dispatch.op`) under the reference's op
name. `sparse_attention` raises, citing its ROADMAP.md item.

The attention APIs are `_host_cu` (:908),
`flash_attn_unpadded` (:914), `flash_attn_varlen_qkvpacked` (:1001) and
`flashmask_attention` (:1020), with the reference's signatures, errors and
routing:

  * varlen: the packed [total, H, D] tokens are gathered into a padded
    [B, S_bucket, H, D] batch (S_bucket = `default_buckets(max_seqlen)`),
    attention runs batched, and the output is gathered back. Self-attention
    (cu_q == cu_k, equal buckets) with no dropout runs the varlen flash op
    (K1v forward, K2v backward on CUDA: key columns past a sequence's
    length masked inside the kernel); the rest runs the reference's
    composition (a per-sequence validity mask, bottom-right causal by
    actual lengths) through the masked `scaled_dot_product_attention`.
  * FlashMask: the single-column causal form ([B, Hm, S, 1] start rows)
    with no dropout, S == Sk and Hq == Hkv runs the block-sparse op (K9
    forward and backward on CUDA); the start+end forms (2 or 4 columns),
    dropout and GQA build the reference's dense additive mask and run the
    masked `scaled_dot_product_attention`.

The reference takes its kernels only on a TPU, and FlashMask's only at
S >= 4096; the port takes them at any size on every device, as it does for
the fused ops: the kernels compute the same function at any S. On the CPU
the same route runs the kernels' plain versions.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ...core.dispatch import op
from ...jit.api import default_buckets
from ...ops._helpers import inplace_variant
from ...ops.flash_attention import flash_attention_varlen_raw
from ...ops.flashmask import flashmask_attention_raw
# the package's __init__ defines these before it imports this module
from . import _pair, elu, hardtanh, leaky_relu, tanh


def _host_cu(x):
    """cu_seqlens as host ints (a tensor, array or list; int64)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).astype(np.int64)


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale=None, dropout=0.0,
                        causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """Varlen ("unpadded") attention: query/key/value packed [total, H, D]
    with cu_seqlens boundaries [B + 1]. Returns (out [total_q, H, D],
    None). `scale` multiplies the scores in place of 1/sqrt(D). Routes as
    the module docstring says: K1v/K2v for self-attention with no dropout,
    the masked composition otherwise."""
    from . import scaled_dot_product_attention

    if return_softmax:
        raise NotImplementedError(
            "flash_attn_unpadded(return_softmax=True): ragged per-segment "
            "weights; run flash_attn_qkvpacked on a padded batch to inspect "
            "attention weights")
    cu_q = _host_cu(cu_seqlens_q)
    cu_k = _host_cu(cu_seqlens_k)
    total_q = int(cu_q[-1])
    sq = default_buckets(int(max_seqlen_q))
    sk = default_buckets(int(max_seqlen_k))
    # gather indices [B, S]: row b position i <- packed index cu[b] + i
    iq = np.minimum(cu_q[:-1, None] + np.arange(sq)[None, :], total_q - 1)
    ik = np.minimum(cu_k[:-1, None] + np.arange(sk)[None, :],
                    int(cu_k[-1]) - 1)
    lens_k = (cu_k[1:] - cu_k[:-1]).astype(np.int32)
    lens_q = (cu_q[1:] - cu_q[:-1]).astype(np.int32)
    # gather-back map: packed token t lives at (seq_id[t], pos[t])
    tpos = np.arange(total_q)
    seq_id = np.searchsorted(cu_q, tpos, side="right") - 1
    pos = tpos - cu_q[seq_id]
    drop = dropout if training else 0.0
    use_flash = drop == 0.0 and np.array_equal(cu_q, cu_k) and sq == sk

    dev = query.device

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    qp = query[on_dev(iq)]                  # [B, Sq, H, D]
    kp = key[on_dev(ik)]
    vp = value[on_dev(ik)]
    if scale is not None:
        d = query.shape[-1]
        qp = qp * torch.tensor(float(scale) * math.sqrt(d), dtype=qp.dtype,
                               device=dev)
    lk = on_dev(lens_k)
    if use_flash:
        out = flash_attention_varlen_raw(
            qp.transpose(1, 2).contiguous(), kp.transpose(1, 2).contiguous(),
            vp.transpose(1, 2).contiguous(), lk, causal=causal)
        out = out.transpose(1, 2)
    else:
        mask = (torch.arange(sk, device=dev)[None, :]
                < lk[:, None])[:, None, None, :]     # [B, 1, 1, Sk]
        if causal:
            # bottom-right aligned per sequence by actual lengths: query
            # row i of sequence b sees key columns j <= i + len_k - len_q
            rows = torch.arange(sq, device=dev)[None, :, None]
            cols = torch.arange(sk, device=dev)[None, None, :]
            off = (lk - on_dev(lens_q))[:, None, None]
            mask = mask & (cols <= rows + off)[:, None]
        out = scaled_dot_product_attention(qp, kp, vp, mask, drop, False)
    return out[on_dev(seq_id), on_dev(pos)], None


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                                max_seqlen_k, scale=None, dropout=0.0,
                                causal=False, return_softmax=False,
                                training=True, name=None):
    """Varlen attention on packed [total, 3, H, D] q/k/v, routed through
    `flash_attn_unpadded`. Returns (out [total, H, D], None)."""
    if return_softmax:
        raise NotImplementedError(
            "flash_attn_varlen_qkvpacked(return_softmax=True): per-segment "
            "softmax weights are ragged; use flash_attn_qkvpacked on padded "
            "batches to inspect attention weights")
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    return flash_attn_unpadded(q, k, v, cu_seqlens_q, cu_seqlens_k,
                               max_seqlen_q, max_seqlen_k, scale, dropout,
                               causal, return_softmax, training=training,
                               name=name)


def flashmask_attention(query, key, value, startend_row_indices=None,
                        dropout=0.0, causal=False, name=None):
    """FlashMask sparse attention over [B, S, H, D] tensors.
    startend_row_indices [B, Hm, S, {1, 2, 4}] (Hm 1 or H): causal takes
    [LTS] (key column j hidden from query rows i >= start[j]) and
    [LTS, LTE]; non-causal [LTS, UTE] and [LTS, LTE, UTS, UTE]. The
    single-column causal form with no dropout, S == Sk and Hq == Hkv runs
    the block-sparse op (K9); the rest the dense additive mask through the
    masked `scaled_dot_product_attention`. A row that every column hides
    is 0 on the K9 route and NaN on the dense one, as in the reference."""
    from . import scaled_dot_product_attention

    if startend_row_indices is None:
        return scaled_dot_product_attention(query, key, value, None, dropout,
                                            causal)
    s = query.shape[1]
    sk = key.shape[1]
    nc = int(startend_row_indices.shape[-1])
    allowed = (1, 2) if causal else (2, 4)
    if nc not in allowed:
        raise ValueError(
            f"flashmask_attention: startend_row_indices last dim must be "
            f"{allowed} for causal={causal}, got {nc} "
            f"(≙ flashmask_attention shape contract, "
            f"nn/functional/flash_attention.py)")
    hq = query.shape[2]
    if dropout == 0.0 and s == sk and nc == 1 and key.shape[2] == hq:
        sr = startend_row_indices[..., 0]          # [B, Hm, S]
        if sr.shape[1] != hq:
            sr = sr.expand(sr.shape[0], hq, sr.shape[2])
        out = flashmask_attention_raw(
            query.transpose(1, 2).contiguous(),
            key.transpose(1, 2).contiguous(),
            value.transpose(1, 2).contiguous(),
            sr.to(torch.int32).contiguous(), causal=causal)
        return out.transpose(1, 2)

    idx = startend_row_indices
    rows = torch.arange(s, device=idx.device)[None, None, :, None]

    def col(j):                                    # [B, Hm, 1, S]
        return idx[..., j:j + 1].transpose(2, 3)

    # a key column j is BLOCKED for query rows inside the named bands
    if causal:
        if nc == 1:
            blocked = rows >= col(0)
        else:
            blocked = (rows >= col(0)) & (rows < col(1))
    else:
        if nc == 2:
            blocked = (rows >= col(0)) | (rows < col(1))
        else:
            blocked = ((rows >= col(0)) & (rows < col(1))) \
                | ((rows >= col(2)) & (rows < col(3)))
    amask = torch.zeros(blocked.shape, dtype=query.dtype,
                        device=query.device).masked_fill(blocked,
                                                         float("-inf"))
    return scaled_dot_product_attention(query, key, value, amask, dropout,
                                        causal)


def _reduce(v, reduction):
    if reduction == "mean":
        return v.mean()
    if reduction == "sum":
        return v.sum()
    if reduction == "none":
        return v
    raise ValueError(f"bad reduction {reduction}")


# ----------------------------------------------------------------- activations
@op("log_sigmoid")
def log_sigmoid(x, name=None):
    return F.logsigmoid(x)


@op("thresholded_relu")
def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return torch.where(x > threshold, x, value).to(x.dtype)


thresholded_relu_ = inplace_variant(thresholded_relu)
tanh_ = inplace_variant(tanh)
elu_ = inplace_variant(elu)
leaky_relu_ = inplace_variant(leaky_relu)
hardtanh_ = inplace_variant(hardtanh)


# ------------------------------------------------------------ shapes / padding
@op("channel_shuffle")
def channel_shuffle(x, groups, data_format="NCHW", name=None):
    if x.dim() != 4:
        raise ValueError("channel_shuffle expects a 4-D tensor")
    c = x.shape[1 if data_format == "NCHW" else 3]
    if c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    if data_format == "NCHW":
        n, _, h, w = x.shape
        return x.reshape(n, groups, c // groups, h, w).transpose(1, 2) \
            .reshape(n, c, h, w)
    n, h, w, _ = x.shape
    return x.reshape(n, h, w, groups, c // groups).transpose(3, 4) \
        .reshape(n, h, w, c)


@op("zeropad2d")
def zeropad2d(x, padding, data_format="NCHW", name=None):
    pl, pr, pt, pb = _pair(padding, 4)
    if data_format == "NCHW":
        return F.pad(x, (pl, pr, pt, pb))
    return F.pad(x, (0, 0, pl, pr, pt, pb))


@op("pairwise_distance")
def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    return torch.linalg.vector_norm(x - y + epsilon, ord=p, dim=-1,
                                    keepdim=keepdim)


@op("feature_alpha_dropout")
def feature_alpha_dropout(x, p=0.5, training=True, name=None):
    """Alpha dropout over whole channel maps (SELU-preserving statistics;
    the mask from torch's default generator)."""
    if not training or p == 0.0:
        return x
    if not 0 <= p < 1:
        raise ValueError(f"p must be in [0,1), got {p}")
    alpha_p = -1.7580993408473766
    a = (1 - p + p * alpha_p ** 2 * (1 - p)) ** -0.5
    b = -a * alpha_p * p
    shape = (x.shape[0], x.shape[1]) + (1,) * (x.dim() - 2)
    keep = torch.empty(shape, device=x.device).bernoulli_(1 - p).bool()
    return a * torch.where(keep, x, alpha_p) + b


# ----------------------------------------------------------------- fold / pool
@op("fold")
def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the inverse of unfold: x [N, C * kh * kw, L]."""
    H, W = _pair(output_sizes, 2)
    kh, kw = _pair(kernel_sizes, 2)
    sh, sw = _pair(strides, 2)
    ph, pw = _pair(paddings, 2)
    dh, dw = _pair(dilations, 2)
    oh = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    ow = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    if x.shape[-1] != oh * ow:
        raise ValueError(f"fold: expected L={oh * ow} windows, got "
                         f"{x.shape[-1]}")
    return _integral(x, lambda a: F.fold(a, (H, W), (kh, kw), (dh, dw),
                                          (ph, pw), (sh, sw)))


def _integral(x, fn):
    """fn(x), an integer x through float64 and back (torch's kernel takes
    floats only; the reference's sums stay in x's dtype)."""
    if x.is_floating_point() or x.is_complex():
        return fn(x)
    return fn(x.to(torch.float64)).to(x.dtype)


@op("lp_pow")
def _lp_pow(x, p):
    return x.abs() ** p


@op("lp_root")
def _lp_root(x, count, p):
    return (x * count) ** (1.0 / p)


def _lp_pool(x, norm_type, kernel, stride, padding, nd, ceil_mode,
             data_format):
    from . import avg_pool1d, avg_pool2d, max_pool1d, max_pool2d

    p = float(norm_type)
    if math.isinf(p):
        mp = max_pool1d if nd == 1 else max_pool2d
        return mp(x, kernel, stride, padding, ceil_mode=ceil_mode)
    ap = avg_pool1d if nd == 1 else avg_pool2d
    avg = ap(_lp_pow(x, p), kernel, stride, padding, ceil_mode=ceil_mode,
             exclusive=False)
    return _lp_root(avg, int(np.prod(_pair(kernel, nd))), p)


def lp_pool1d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCL", name=None):
    return _lp_pool(x, norm_type, kernel_size, stride, padding, 1, ceil_mode,
                    data_format)


def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW", name=None):
    return _lp_pool(x, norm_type, kernel_size, stride, padding, 2, ceil_mode,
                    data_format)


def _unpool(nd, opname):
    @op(opname)
    def unpool(x, indices, kernel_size, stride=None, padding=0,
               data_format=None, output_size=None, name=None):
        """Each value of x written at its flat spatial index into zeros of
        the output size ((in - 1) * stride - 2 * padding + kernel by
        default); an index past the output is dropped, as jax's scatter
        drops it."""
        ks = _pair(kernel_size, nd)
        st = _pair(stride if stride is not None else kernel_size, nd)
        pd = _pair(padding, nd)
        if output_size is None:
            size = tuple((x.shape[2 + i] - 1) * st[i] - 2 * pd[i] + ks[i]
                         for i in range(nd))
        else:
            size = tuple(int(v) for v in tuple(output_size)[-nd:])
        n, c = x.shape[0], x.shape[1]
        flat = int(np.prod(size))
        idx = indices.reshape(n, c, -1).long()
        idx = torch.where(idx < 0, idx + flat, idx)
        idx = torch.where((idx < 0) | (idx >= flat), flat, idx)
        # where indices repeat, the last value written wins, as jax's
        # scatter on the CPU: each position takes the largest source slot
        # that targets it (deterministic on every device)
        src = torch.arange(idx.shape[-1], device=x.device).expand_as(idx)
        winner = torch.full((n, c, flat + 1), -1, dtype=torch.long,
                            device=x.device).scatter_reduce(
            2, idx, src, "amax")[..., :flat]
        vals = x.reshape(n, c, -1).gather(2, winner.clamp_min(0))
        out = torch.where(winner >= 0, vals, 0.0).to(x.dtype)
        return out.reshape((n, c) + size)

    return unpool


_unpool1d = _unpool(1, "max_unpool1d")
_unpool2d = _unpool(2, "max_unpool2d")
_unpool3d = _unpool(3, "max_unpool3d")


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    return _unpool1d(x, indices, kernel_size, stride, padding, data_format,
                     output_size)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _unpool2d(x, indices, kernel_size, stride, padding, data_format,
                     output_size)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _unpool3d(x, indices, kernel_size, stride, padding, data_format,
                     output_size)


def _fractional_bounds(in_size, out_size, u):
    """Window boundaries of fractional max pooling without a kernel size
    (the reference's floor variant, every window non-empty)."""
    alpha = in_size / out_size
    idx = np.arange(out_size + 1)
    b = np.floor(alpha * (idx + u)).astype(np.int64) - int(np.floor(alpha * u))
    b[0], b[-1] = 0, in_size
    b = np.clip(b, 0, in_size)
    for i in range(1, len(b)):
        if b[i] <= b[i - 1]:
            b[i] = min(b[i - 1] + 1, in_size)
    return b


def _fractional_starts(in_size, out_size, k, u):
    """torch's pseudorandom window starts for kernel size k:
    floor((i + u) * alpha) - floor(u * alpha), the last at in - k."""
    if out_size == 1:
        return np.array([0], np.int64)
    alpha = (in_size - k) / (out_size - 1)
    i = np.arange(out_size - 1)
    seq = (np.floor((i + u) * alpha) - np.floor(u * alpha)).astype(np.int64)
    return np.append(seq, in_size - k)


def _window_max_pool(x, nd, starts_list, lens_list, return_mask=False):
    """Max pooling over per-dim windows [start, start + len) given on the
    host (fractional pooling): positions outside the input never win.
    Returns the values, or (values, the argmax flattened over the
    input's spatial dims, int32)."""
    spatial = tuple(int(s) for s in x.shape[2:])
    out_sz = [len(s) for s in starts_list]
    gidx, gmask, kmax = [], [], []
    for d in range(nd):
        starts = np.asarray(starts_list[d], np.int64)
        lens = np.asarray(lens_list[d], np.int64)
        km = int(lens.max())
        kmax.append(km)
        idx = starts[:, None] + np.arange(km)[None, :]
        gmask.append((np.arange(km)[None, :] < lens[:, None])
                     & (idx >= 0) & (idx < spatial[d]))
        gidx.append(np.clip(idx, 0, spatial[d] - 1))
    out = x
    for d in range(nd):
        ax = 2 + 2 * d
        g = out.index_select(ax, torch.as_tensor(gidx[d].reshape(-1),
                                                 device=x.device))
        out = g.reshape(tuple(out.shape[:ax]) + (out_sz[d], kmax[d])
                        + tuple(out.shape[ax + 1:]))
    perm = [0, 1] + [2 + 2 * d for d in range(nd)] \
        + [3 + 2 * d for d in range(nd)]
    out = out.permute(perm)
    full = np.einsum(*sum(([gmask[d], [d, nd + d]] for d in range(nd)), []),
                     range(2 * nd)).astype(bool)
    keep = torch.as_tensor(full, device=x.device).reshape(
        (1, 1) + tuple(out_sz) + tuple(kmax))
    out = torch.where(keep, out, float("-inf")).to(x.dtype)
    flatk = out.reshape(tuple(out.shape[:2 + nd]) + (-1,))
    vals = flatk.amax(-1)
    if not return_mask:
        return vals
    rem = flatk.argmax(-1)
    flat_idx = torch.zeros(rem.shape, dtype=torch.int32, device=x.device)
    for d in range(nd - 1, -1, -1):
        off = rem % kmax[d]
        rem = rem // kmax[d]
        osh = [1] * rem.dim()
        osh[2 + d] = out_sz[d]
        starts = torch.as_tensor(np.asarray(starts_list[d], np.int32),
                                 device=x.device).reshape(osh)
        stride = int(np.prod(spatial[d + 1:], initial=1))
        flat_idx = flat_idx + (starts + off.to(torch.int32)) * stride
    return vals, flat_idx


def _fractional_pool(nd, opname):
    @op(opname)
    def pool(x, output_size, kernel_size=None, random_u=None,
             return_mask=False, name=None):
        out_sz = _pair(output_size, nd)
        spatial = tuple(x.shape[2:])
        if random_u is None:
            u = float(torch.rand(()))
        else:
            u = float(random_u)
            if not 0 < u < 1:
                raise ValueError(f"random_u must be in (0,1), got {random_u}")
        starts_list, lens_list = [], []
        for d in range(nd):
            if kernel_size is not None:
                k = _pair(kernel_size, nd)[d]
                starts_list.append(_fractional_starts(spatial[d], out_sz[d],
                                                      k, u))
                lens_list.append(np.full(out_sz[d], k, np.int64))
            else:
                b = _fractional_bounds(spatial[d], out_sz[d], u)
                starts_list.append(b[:-1])
                lens_list.append(b[1:] - b[:-1])
        return _window_max_pool(x, nd, starts_list, lens_list, return_mask)

    return pool


fractional_max_pool2d = _fractional_pool(2, "fractional_max_pool2d")
fractional_max_pool3d = _fractional_pool(3, "fractional_max_pool3d")


# -------------------------------------------------------- transposed convs
def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCL", output_size=None, name=None):
    """1-D transposed convolution, weight [in, out / groups, k];
    `output_size` picks the output padding."""
    if data_format not in ("NCL", "NLC"):
        raise ValueError(f"bad data_format {data_format}")
    st = _pair(stride, 1)[0]
    pd = _pair(padding, 1)[0]
    dl = _pair(dilation, 1)[0]
    opad = _pair(output_padding, 1)[0]
    if output_size is not None:
        osz = output_size[-1] if isinstance(output_size, (list, tuple)) \
            else int(output_size)
        lin = int(x.shape[-1] if data_format == "NCL" else x.shape[1])
        base = (lin - 1) * st - 2 * pd + dl * (int(weight.shape[-1]) - 1) + 1
        opad = int(osz) - base
        if not 0 <= opad < st and opad != 0:
            raise ValueError(f"output_size {osz} is not reachable: base "
                             f"length {base}, stride {st}")
    return _conv1d_t(x, weight, bias, st, pd, opad, groups, dl, data_format)


@op("conv2d_transpose")
def _conv1d_t(x, weight, bias, st, pd, opad, groups, dl, data_format):
    from . import convolution

    a = x if data_format == "NCL" else x.transpose(1, 2)
    out = convolution(a, weight, bias, st, pd, dl, True, opad, groups)
    return out if data_format == "NCL" else out.transpose(1, 2)


@op("conv3d_transpose")
def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCDHW", output_size=None, name=None):
    from . import convolution

    a = x if data_format == "NCDHW" else x.movedim(-1, 1)
    out = convolution(a, weight, bias, stride, padding, dilation, True,
                      output_padding, groups)
    return out if data_format == "NCDHW" else out.movedim(1, -1)


# ------------------------------------------------------------ vision sampling
@op("affine_grid")
def affine_grid(theta, out_shape, align_corners=True, name=None):
    """theta [N, 2, 3] -> sampling grid [N, H, W, 2] in [-1, 1]."""
    n, c, h, w = (int(s) for s in out_shape)
    return _integral(theta, lambda t: F.affine_grid(
        t, [n, c, h, w], align_corners=align_corners))


@op("grid_sample")
def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"bad mode {mode}")
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(f"bad padding_mode {padding_mode}")
    return F.grid_sample(x, grid.to(x.dtype), mode=mode,
                         padding_mode=padding_mode,
                         align_corners=align_corners)


# ------------------------------------------------------------------ loss zoo
@op("dice_loss")
def dice_loss(input, label, epsilon=1e-5, name=None):
    """input [N, ..., C] probabilities, label [N, ..., 1] ints."""
    oh = F.one_hot(label[..., 0].long(), input.shape[-1]).to(input.dtype)
    dims = tuple(range(1, input.dim()))
    inter = (input * oh).sum(dims)
    union = input.sum(dims) + oh.sum(dims)
    return (1 - (2 * inter + epsilon) / (union + epsilon)).mean()


@op("soft_margin_loss")
def soft_margin_loss(input, label, reduction="mean", name=None):
    y = label.detach().to(input.dtype)
    return _reduce(torch.log1p(torch.exp(-y * input)), reduction)


@op("multi_label_soft_margin_loss")
def multi_label_soft_margin_loss(input, label, weight=None, reduction="mean",
                                 name=None):
    y = label.detach().to(input.dtype)
    term = y * F.logsigmoid(input) + (1 - y) * F.logsigmoid(-input)
    if weight is not None:
        term = term * weight.detach()
    return _reduce(-term.mean(-1), reduction)


@op("multi_margin_loss")
def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    n, c = input.shape
    y = label.long()
    tgt = input.gather(1, y[:, None])
    m = torch.clamp_min(margin - tgt + input, 0) ** p
    if weight is not None:
        m = m * weight.detach()[y][:, None]
    m = m * (1 - F.one_hot(y, c).to(m.dtype))
    return _reduce(m.sum(1) / c, reduction)


@op("poisson_nll_loss")
def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean", name=None):
    y = label.detach().to(input.dtype)
    if log_input:
        loss = torch.exp(input) - y * input
    else:
        loss = input - y * torch.log(input + epsilon)
    if full:
        y1 = torch.clamp_min(y, 1.0)
        stirling = y * torch.log(y1) - y + 0.5 * torch.log(2 * math.pi * y1)
        loss = loss + torch.where(y > 1, stirling, 0.0)
    return _reduce(loss, reduction)


@op("gaussian_nll_loss")
def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    """Differentiable in the mean and the variance."""
    var = torch.clamp_min(variance, epsilon)
    loss = 0.5 * (torch.log(var) + (label.to(input.dtype) - input) ** 2 / var)
    if full:
        loss = loss + 0.5 * math.log(2 * math.pi)
    return _reduce(loss, reduction)


@op("triplet_margin_with_distance_loss")
def _triplet_distance(a, p, n, margin, swap, reduction):
    d_ap = torch.linalg.vector_norm(a - p, dim=-1)
    d_an = torch.linalg.vector_norm(a - n, dim=-1)
    if swap:
        d_an = torch.minimum(d_an, torch.linalg.vector_norm(p - n, dim=-1))
    return _reduce(torch.clamp_min(d_ap - d_an + margin, 0), reduction)


@op("triplet_margin_with_distance_loss")
def _triplet_given(d_ap, d_an, margin, reduction):
    return _reduce(torch.clamp_min(d_ap - d_an + margin, 0), reduction)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    """With `distance_function` (called on the inputs as given) its
    distances; the Euclidean distance otherwise."""
    if distance_function is None:
        return _triplet_distance(input, positive, negative, margin, swap,
                                 reduction)
    from ...ops.math import minimum

    d_ap = distance_function(input, positive)
    d_an = distance_function(input, negative)
    if swap:
        d_an = minimum(d_an, distance_function(positive, negative))
    return _triplet_given(d_ap, d_an, margin, reduction)


def _default_tree_paths(num_classes):
    """Codes of the complete binary tree of hierarchical sigmoid: leaf c
    at heap position c + num_classes - 1; internal nodes 0..C-2."""
    depth = max(1, int(np.ceil(np.log2(max(num_classes, 2)))) + 1)
    table = np.full((num_classes, depth), -1, dtype=np.int64)
    code = np.zeros((num_classes, depth), dtype=np.float32)
    for cidx in range(num_classes):
        pos = cidx + num_classes - 1
        path = []
        while pos > 0:
            parent = (pos - 1) // 2
            path.append((parent, 1.0 if pos == 2 * parent + 2 else 0.0))
            pos = parent
        for d, (node, bit) in enumerate(reversed(path)):
            table[cidx, d] = node
            code[cidx, d] = bit
    return table, code


@op("hsigmoid_loss")
def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid loss [N, 1]: the default complete-binary-tree
    coding, or a custom (path_table, path_code)."""
    dev = input.device
    if path_table is None:
        tbl, code = _default_tree_paths(num_classes)
        tbl, code = torch.as_tensor(tbl, device=dev), \
            torch.as_tensor(code, device=dev)
    else:
        tbl, code = path_table.long(), path_code.to(torch.float32)
    y = label.long()
    nodes, codes = tbl[y], code[y].to(input.dtype)
    valid = (nodes >= 0).to(input.dtype)
    safe = torch.clamp_min(nodes, 0)
    logits = torch.einsum("nf,ndf->nd", input, weight[safe])
    if bias is not None:
        logits = logits + bias.reshape(-1)[safe]
    lose = -(codes * F.logsigmoid(logits)
             + (1 - codes) * F.logsigmoid(-logits))
    return (lose * valid).sum(1, keepdim=True)


@op("adaptive_log_softmax_with_loss")
def adaptive_log_softmax_with_loss(input, label, head_weight, tail_weights,
                                   cutoffs, head_bias=None, name=None):
    """The adaptive softmax: a head over the shortlist [0, cutoffs[0])
    and one logit per tail cluster, each tail a (projection, cluster)
    pair. Returns (each sample's target log-probability, the mean
    loss)."""
    shortlist = list(cutoffs)[0]
    head = input @ head_weight
    if head_bias is not None:
        head = head + head_bias
    head_lsm = torch.log_softmax(head, -1)
    y = label.long()
    out = head_lsm.gather(1, y.clamp(0, shortlist - 1)[:, None])[:, 0]
    result = torch.where(y < shortlist, out, 0.0)
    lo = shortlist
    for i, (proj, cls_w) in enumerate(tail_weights):
        hi = lo + cls_w.shape[-1]
        in_cluster = (y >= lo) & (y < hi)
        tail_lsm = torch.log_softmax((input @ proj) @ cls_w, -1)
        rel = (y - lo).clamp(0, cls_w.shape[-1] - 1)
        contrib = head_lsm[:, shortlist + i] + tail_lsm.gather(
            1, rel[:, None])[:, 0]
        result = torch.where(in_cluster, contrib, result)
        lo = hi
    return result, -result.mean()


@op("margin_cross_entropy")
def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean", name=None):
    """ArcFace / CosFace margin softmax on cosine logits."""
    cos = torch.clamp(logits, -1.0, 1.0)
    tgt = torch.cos(margin1 * torch.acos(cos) + margin2) - margin3
    oh = F.one_hot(label.long(), logits.shape[-1]).to(logits.dtype)
    lsm = torch.log_softmax(torch.where(oh > 0, tgt, cos) * scale, -1)
    loss = -(oh * lsm).sum(-1, keepdim=True)
    if reduction == "mean":
        loss = loss.mean()
    elif reduction == "sum":
        loss = loss.sum()
    if return_softmax:
        return loss, torch.exp(lsm)
    return loss


def _rnnt_one(lpb, yb, tb, ub, blank, fastemit_lambda):
    """One sequence's transducer loss over its log-probabilities [T, U+1,
    V] (the reference's alpha recursion; with FastEmit, lambda times the
    emission term weighted by the detached emission posteriors from the
    beta recursion)."""
    T, U1 = lpb.shape[0], lpb.shape[1]
    neg = torch.tensor(-1e30, dtype=lpb.dtype, device=lpb.device)
    blank_lp = lpb[:, :, blank]                                # [T, U+1]
    lab_lp = lpb[:, :-1, :].gather(2, yb[None, :, None].expand(
        T, U1 - 1, 1).long())[..., 0]                          # [T, U]
    alpha = [[None] * U1 for _ in range(T)]
    for t in range(T):
        for u in range(U1):
            if t == 0 and u == 0:
                alpha[t][u] = lpb.new_zeros(())
                continue
            top = alpha[t - 1][u] + blank_lp[t - 1, u] if t > 0 else neg
            left = alpha[t][u - 1] + lab_lp[t, u - 1] if u > 0 else neg
            alpha[t][u] = torch.logaddexp(top, left)
    base = -(alpha[tb - 1][ub] + blank_lp[tb - 1, ub])
    if fastemit_lambda == 0.0:
        return base
    beta = [[None] * U1 for _ in range(T)]
    for t in range(T - 1, -1, -1):
        for u in range(U1 - 1, -1, -1):
            if t > tb - 1 or u > ub:
                beta[t][u] = neg
                continue
            if t == tb - 1:
                down = blank_lp[t, u] if u == ub else neg
            else:
                down = beta[t + 1][u] + blank_lp[t, u]
            right = beta[t][u + 1] + lab_lp[t, u] if u + 1 <= ub else neg
            beta[t][u] = torch.logaddexp(down, right)
    logz = beta[0][0]
    l_emit = lpb.new_zeros(())
    for t in range(tb):
        for u in range(ub):
            gam = torch.exp(torch.clamp(alpha[t][u] + lab_lp[t, u]
                                        + beta[t][u + 1] - logz, -60.0, 0.0))
            l_emit = l_emit - gam.detach() * lab_lp[t, u]
    return base + fastemit_lambda * l_emit


@op("rnnt_loss")
def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.001, reduction="mean", name=None):
    """RNN-T loss over logits [B, T, U+1, V] (log_softmax inside), labels
    [B, U], lengths [B]; the lattice recursions run on the host's loop
    (the lengths are read)."""
    logp = torch.log_softmax(input, -1)
    tls, uls = input_lengths.tolist(), label_lengths.tolist()
    losses = torch.stack([
        _rnnt_one(logp[b], label[b], int(tls[b]), int(uls[b]), blank,
                  fastemit_lambda) for b in range(input.shape[0])])
    return _reduce(losses, reduction)


# --------------------------------------------------------------- seq decode
@op("gather_tree", n_diff=0)
def gather_tree(ids, parents, name=None):
    """Beam-search backtrace: ids / parents [T, B, beam] -> the full
    paths."""
    T = ids.shape[0]
    beams = torch.arange(ids.shape[-1], device=ids.device).expand(
        ids.shape[1:]).to(parents.dtype)
    out = [None] * T
    for t in range(T - 1, -1, -1):
        idx = beams.long()
        out[t] = ids[t].gather(-1, idx)
        beams = parents[t].gather(-1, idx)
    return torch.stack(out)


# ------------------------------------------------------- attention wrappers
@op("attention_softmax")
def _dense_softmax_weights(q, k, causal):
    """Attention weights [B, H, Sq, Sk] of [B, S, H, D] inputs by the
    dense path (for return_softmax)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return torch.softmax(s, -1)


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False,
                         return_softmax=False, training=True, name=None):
    """Packed-QKV attention: qkv [B, S, 3, H, D]."""
    from . import scaled_dot_product_attention

    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out = scaled_dot_product_attention(q, k, v, None, dropout, causal,
                                       training)
    if return_softmax:
        return out, _dense_softmax_weights(q, k, causal)
    return out, None


def sparse_attention(*args, **kwargs):
    raise NotImplementedError(
        "sparse_attention: the sparse surface is ported with the long tail "
        "(ROADMAP.md Queue 1, 'After these': `sparse`)")
