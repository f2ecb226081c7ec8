"""The long tail of tensor ops (special functions, scatter family, extra
linalg, distances, sampling helpers).

Port of paddle_tpu/ops/extras.py. `gammainc` / `gammaincc` carry their
gradient in the shape parameter too (torch's `igamma` has none there;
`_IncGamma` computes it from the series of the regularized incomplete
gamma function in float64). `stft` / `istft` belong to `signal`, ported
with the long tail (ROADMAP.md Queue 1).
"""
from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from ..core.dispatch import op
from ..core.tensor import Tensor
from ._helpers import norm_axis, public, raw, tie_abs, tie_clamp
from .random import _gen


# ------------------------------------------------------------- complex views
@op("as_complex")
def as_complex(x, name=None):
    return torch.complex(x[..., 0], x[..., 1])


@op("as_real")
def as_real(x, name=None):
    return torch.stack([x.real, torch.imag(x) if x.is_complex()
                        else torch.zeros_like(x)], -1)


@op("isreal", n_diff=0)
def isreal(x, name=None):
    return torch.isreal(x)


@op("sgn")
def sgn(x, name=None):
    return torch.sgn(x)


# ------------------------------------------------------------------- bitwise
@op("bitwise_invert", n_diff=0)
def bitwise_invert(x, name=None):
    return torch.bitwise_not(x)


@op("bitwise_left_shift", n_diff=0)
def bitwise_left_shift(x, y, is_arithmetic=True, name=None):
    return torch.bitwise_left_shift(x, y)


@op("bitwise_right_shift", n_diff=0)
def bitwise_right_shift(x, y, is_arithmetic=True, name=None):
    if is_arithmetic or not torch.is_signed(x):
        return torch.bitwise_right_shift(x, y)
    bits = torch.iinfo(x.dtype).bits
    y = y.to(x.dtype)
    mask = torch.where(y > 0, (torch.ones_like(x) << (bits - y)) - 1, -1)
    return torch.bitwise_right_shift(x, y) & mask


# ------------------------------------------------------------------ special
@op("gammaln")
def gammaln(x, name=None):
    return torch.lgamma(x)


def _log_series(a, x, n_terms):
    """log of sum_{n>=0} x^n / ((a+1)...(a+n)), float64, differentiable
    in a."""
    n = torch.arange(n_terms, dtype=torch.float64, device=a.device)
    logx = torch.log(x).unsqueeze(-1)
    steps = torch.log(a.unsqueeze(-1) + n[1:])
    cum = torch.cat([torch.zeros_like(steps[..., :1]),
                     torch.cumsum(steps, -1)], -1)
    return torch.logsumexp(n * logx - cum, -1)


def _dgammainc_da(a, x):
    """d P(a, x) / d a, from P = x^a e^-x / Gamma(a+1) * series."""
    a64 = a.detach().double().requires_grad_(True)
    x64 = x.detach().double().clamp_min(1e-300)
    n_terms = int(min(4000, 64 + 4 * float(x64.max()) + 8 * math.sqrt(
        float(x64.max()) + 1)))
    with torch.enable_grad():
        logp = a64 * torch.log(x64) - x64 - torch.lgamma(a64 + 1) \
            + _log_series(a64, x64, n_terms)
        p = torch.exp(logp)
        (g,) = torch.autograd.grad(p.sum(), a64)
    return g


class _IncGamma(torch.autograd.Function):
    """P(a, x) (upper=False) or Q(a, x) = 1 - P (upper=True), with
    gradients in both arguments."""

    @staticmethod
    def forward(ctx, a, x, upper):
        ctx.save_for_backward(a, x)
        ctx.upper = upper
        return torch.special.gammaincc(a, x) if upper \
            else torch.special.gammainc(a, x)

    @staticmethod
    def backward(ctx, g):
        a, x = ctx.saved_tensors
        sign = -1.0 if ctx.upper else 1.0
        ga = gx = None
        if ctx.needs_input_grad[0]:
            ga = (g * sign * _dgammainc_da(*torch.broadcast_tensors(a, x))
                  .to(g.dtype))
            ga = _sum_to(ga, a.shape)
        if ctx.needs_input_grad[1]:
            dx = torch.exp((a - 1) * torch.log(x) - x - torch.lgamma(a))
            gx = _sum_to(g * sign * dx, x.shape)
        return ga, gx, None


def _sum_to(g, shape):
    while g.dim() > len(shape):
        g = g.sum(0)
    for i, s in enumerate(shape):
        if s == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


_LOW = (torch.bfloat16, torch.float16)


def _f32(fn, *args):
    """fn through float32 when an argument is a low-precision float
    (torch has no bfloat16 / float16 kernel for some special functions,
    on the card or on both devices), the result cast back to that dtype,
    the reference's."""
    low = [a.dtype for a in args
           if isinstance(a, torch.Tensor) and a.dtype in _LOW]
    if not low:
        return fn(*args)
    return fn(*[a.float() if isinstance(a, torch.Tensor) and a.dtype in _LOW
                else a for a in args]).to(low[0])


@op("gammainc")
def gammainc(x, y, name=None):
    return _f32(lambda a, b: _IncGamma.apply(a, b, False), x, y)


@op("gammaincc")
def gammaincc(x, y, name=None):
    return _f32(lambda a, b: _IncGamma.apply(a, b, True), x, y)


@op("multigammaln")
def multigammaln(x, p, name=None):
    return _f32(torch.special.multigammaln, x, p)


@op("polygamma")
def polygamma(x, n, name=None):
    return _f32(lambda a: torch.special.polygamma(n, a), x)


@op("i0e")
def i0e(x, name=None):
    return _f32(torch.special.i0e, x)


@op("i1")
def i1(x, name=None):
    return _f32(torch.special.i1, x)


@op("i1e")
def i1e(x, name=None):
    return _f32(torch.special.i1e, x)


@op("sinc")
def sinc(x, name=None):
    return torch.sinc(x)


@op("isneginf", n_diff=0)
def isneginf(x, name=None):
    return torch.isneginf(x)


@op("isposinf", n_diff=0)
def isposinf(x, name=None):
    return torch.isposinf(x)


@op("frexp", n_diff=0)
def frexp(x, name=None):
    return tuple(torch.frexp(x))


# ----------------------------------------------------------------- reductions
@op("trace")
def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


@op("diagonal")
def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(x, offset, axis1, axis2)


@op("trapezoid")
def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return torch.trapezoid(y, x, dim=axis)
    return torch.trapezoid(y, dx=1.0 if dx is None else dx, dim=axis)


@op("cumulative_trapezoid")
def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    a = y.movedim(axis, -1)
    avg = (a[..., 1:] + a[..., :-1]) / 2.0
    if x is not None:
        xs = x.broadcast_to(y.shape).movedim(axis, -1) \
            if x.dim() == y.dim() else x
        seg = avg * torch.diff(xs, dim=-1)
    else:
        seg = avg * (1.0 if dx is None else dx)
    return torch.cumsum(seg, -1).movedim(-1, axis)


@op("diff")
def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    return torch.diff(x, n, axis, prepend, append)


@op("reduce_as")
def reduce_as(x, target, name=None):
    tshape = tuple(target.shape)
    a = x
    extra = a.dim() - len(tshape)
    if extra:
        a = a.sum(tuple(range(extra)))
    keep = tuple(i for i, (s, t) in enumerate(zip(a.shape, tshape))
                 if s != t)
    if keep:
        a = a.sum(keep, keepdim=True)
    return a.reshape(tshape)


@op("is_empty", n_diff=0)
def is_empty(x, name=None):
    return torch.tensor(x.numel() == 0, device=x.device)


@op("isin", n_diff=0)
def isin(x, test_x, assume_unique=False, invert=False, name=None):
    return torch.isin(x, test_x, invert=invert)


@op("histogram_bin_edges", n_diff=0)
def histogram_bin_edges(x, bins=100, min=0, max=0, name=None):  # noqa: A002
    a = x.double()
    if min == 0 and max == 0:
        lo, hi = float(a.min()), float(a.max())
    else:
        lo, hi = float(min), float(max)
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    out_dt = x.dtype if x.is_floating_point() else torch.float64
    return torch.linspace(lo, hi, bins + 1, dtype=torch.float64,
                          device=x.device).to(out_dt)


# -------------------------------------------------------------- manipulation
def reverse(x, axis, name=None):
    from .manipulation import flip

    return flip(x, axis)


def less(x, y, name=None):
    from .math import less_than

    return less_than(x, y)


@op("unstack")
def unstack(x, axis=0, num=None, name=None):
    ax = axis % x.dim()
    n = x.shape[ax]
    if num is not None and num != n:
        raise ValueError(f"unstack: num={num} != dim size {n}")
    return list(torch.unbind(x, ax))


@op("unflatten")
def unflatten(x, axis, shape, name=None):
    ax = axis % x.dim()
    shape = [int(raw(s)) for s in shape]
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1])) or 1
        shape[shape.index(-1)] = x.shape[ax] // known
    return x.reshape(list(x.shape[:ax]) + shape + list(x.shape[ax + 1:]))


@op("tensor_split")
def tensor_split(x, num_or_indices, axis=0, name=None):
    ax = norm_axis(axis) or 0
    return list(torch.tensor_split(x, num_or_indices, ax))


@op("vander")
def vander(x, n=None, increasing=False, name=None):
    n = x.shape[0] if n is None else n
    p = torch.arange(n, device=x.device)
    if not increasing:
        p = p.flip(0)
    return torch.pow(x[:, None], p.to(x.dtype))


@op("block_diag")
def block_diag(inputs, name=None):
    return torch.block_diag(*inputs)


@op("shard_index", n_diff=0)
def shard_index(input, index_num, nshards, shard_id, ignore_value=-1,
                name=None):
    if not 0 <= shard_id < nshards:
        raise ValueError(
            f"shard_id {shard_id} out of range for nshards {nshards}")
    size = (index_num + nshards - 1) // nshards
    in_shard = torch.div(input, size, rounding_mode="floor") == shard_id
    return torch.where(in_shard, torch.remainder(input, size), ignore_value)


# ------------------------------------------------------------ scatter family
@op("index_fill")
def index_fill(x, index, axis, value, name=None):
    return torch.index_fill(x, axis % x.dim(), index.long(), value)


@op("select_scatter")
def select_scatter(x, values, axis, index, name=None):
    return torch.select_scatter(x, values.to(x.dtype), axis % x.dim(),
                                index)


@op("slice_scatter")
def slice_scatter(x, value, axes, starts, ends, strides, name=None):
    idx = [slice(None)] * x.dim()
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        idx[ax % x.dim()] = slice(st, en, sd)
    out = x.clone()
    out[tuple(idx)] = value.to(x.dtype)
    return out


@op("diagonal_scatter")
def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal_scatter(x, y.to(x.dtype), offset, axis1, axis2)


# ------------------------------------------------------------------- linalg+
@op("cholesky_inverse")
def cholesky_inverse(x, upper=False, name=None):
    return torch.cholesky_inverse(x, upper=upper)


@op("lu_unpack", n_diff=0)
def _lu_unpack(x, y):
    return tuple(torch.lu_unpack(x, y.to(torch.int32)))


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """(lu factor, 1-based pivots) -> (P, L, U); a suppressed part is
    None, as the reference's."""
    p_, l_, u_ = _lu_unpack(x, y)
    return (p_ if unpack_pivots else None, l_ if unpack_ludata else None,
            u_ if unpack_ludata else None)


@op("ormqr")
def ormqr(x, tau, other, left=True, transpose=False, name=None):
    return torch.ormqr(x, tau, other, left=left, transpose=transpose)


@op("cdist")
def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    if p == 2.0 and "use_mm" in compute_mode:
        aa = torch.sum(x * x, -1)[..., :, None]
        bb = torch.sum(y * y, -1)[..., None, :]
        ab = torch.matmul(x, y.mT)
        d2 = torch.clamp_min(aa + bb - 2 * ab, 0)
        safe = torch.where(d2 > 0, d2, 1.0)
        return torch.where(d2 > 0, torch.sqrt(safe), 0.0)
    d = x[..., :, None, :] - y[..., None, :, :]
    if p == 0:
        return torch.sum(d != 0, -1).to(x.dtype)
    if math.isinf(p):
        return torch.amax(tie_abs(d), -1)
    return torch.sum(tie_abs(d) ** p, -1) ** (1.0 / p)


@op("renorm")
def renorm(x, p, axis, max_norm, name=None):
    ax = axis % x.dim()
    moved = x.movedim(ax, 0)
    flat = moved.reshape(moved.shape[0], -1)
    norms = torch.sum(tie_abs(flat) ** p, 1) ** (1.0 / p)
    scale = torch.where(norms > max_norm, max_norm / (norms + 1e-7), 1.0)
    out = flat * scale[:, None]
    return out.reshape(moved.shape).movedim(0, ax)


@op("svd_lowrank")
def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    """Randomized low-rank SVD (subspace iteration)."""
    qq = min(q, *x.shape[-2:])
    a = x if M is None else x - M
    g = torch.randn(a.shape[:-2] + (a.shape[-1], qq), dtype=a.dtype,
                    device=a.device, generator=_gen(a.device))
    y = a @ g
    for _ in range(niter):
        y = a @ (a.mT @ y)
    qmat, _ = torch.linalg.qr(y)
    b = qmat.mT @ a
    u, s, vh = torch.linalg.svd(b, full_matrices=False)
    return qmat @ u, s, vh.mT


@op("top_p_sampling", n_diff=0)
def top_p_sampling(x, ps, threshold=None, topp_seed=None, seed=-1, k=0,
                   mode="truncated", return_top=False, name=None):
    """Nucleus sampling per row: the smallest prefix of the sorted
    probabilities whose sum reaches p (and the top k, and those at least
    `threshold`), renormalized, sampled. (scores, ids), or with
    return_top (scores, ids, top scores, top ids)."""
    if mode != "truncated":
        raise NotImplementedError(
            "top_p_sampling(mode='non-truncated') is not supported; the "
            "truncated nucleus strategy is the shipped path")
    srt, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    cum = torch.cumsum(srt, -1)
    pcol = ps.reshape(-1, 1) if ps.dim() else ps
    keep = cum - srt < pcol
    pos = torch.arange(srt.shape[-1], device=x.device)
    kk = int(k)
    if kk > 0:
        keep = keep & (pos[None, :] < kk)
    if threshold is not None:
        keep = keep & (srt >= threshold.reshape(-1, 1))
    keep[..., 0] = True
    masked = torch.where(keep, srt, 0.0)
    masked = masked / masked.sum(-1, keepdim=True)
    flat = masked.reshape(-1, masked.shape[-1])
    if topp_seed is not None:
        rows = [torch.multinomial(
            r.float(), 1, generator=torch.Generator(device=x.device)
            .manual_seed(int(s))) for r, s in zip(flat,
                                                  topp_seed.reshape(-1))]
        picks = torch.cat(rows)
    else:
        g = _gen(x.device, seed if seed >= 0 else 0)
        picks = torch.multinomial(flat.float(), 1, generator=g)[:, 0]
    picks = picks.reshape(masked.shape[:-1])
    ids = torch.take_along_dim(idx, picks[..., None], -1)[..., 0]
    scores = torch.take_along_dim(x, ids[..., None], -1)[..., 0]
    if not return_top:
        return scores, ids[..., None]
    nt = max(kk, 1)
    return scores, ids[..., None], srt[..., :nt], idx[..., :nt]


def create_tensor(dtype="float32", name=None, persistable=False):
    """An empty placeholder tensor (a legacy static-graph helper)."""
    from .creation import zeros

    return zeros([0], dtype=dtype)


@op("positive")
def positive(x, name=None):
    return +x


@op("vecdot")
def vecdot(x, y, axis=-1, name=None):
    return torch.sum(torch.conj(x) * y, axis)


@op("pdist")
def pdist(x, p=2.0, name=None):
    n = x.shape[0]
    iu = torch.triu_indices(n, n, 1, device=x.device)
    d = x[:, None, :] - x[None, :, :]
    if math.isinf(p):
        full = torch.amax(tie_abs(d), -1)
    elif p == 0:
        full = torch.sum(d != 0, -1).to(x.dtype)
    else:
        full = torch.sum(tie_abs(d) ** p, -1) ** (1.0 / p)
    return full[iu[0], iu[1]]


def cartesian_prod(x, name=None):
    tensors = x if isinstance(x, (list, tuple)) else [x]
    if len(tensors) == 1:
        return tensors[0]
    return _cartesian(list(tensors))


@op("cartesian_prod")
def _cartesian(tensors):
    grids = torch.meshgrid(*tensors, indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids], -1)


@op("combinations")
def combinations(x, r=2, with_replacement=False, name=None):
    n = x.shape[0]
    combo = itertools.combinations_with_replacement(range(n), r) \
        if with_replacement else itertools.combinations(range(n), r)
    idx = np.array(list(combo), dtype=np.int64).reshape(-1, r)
    return x[torch.as_tensor(idx, device=x.device)]


@op("standard_gamma")
def standard_gamma(x, name=None):
    """Samples of Gamma(alpha=x, 1), elementwise."""
    return torch._standard_gamma(x.float(),
                                 generator=_gen(x.device)).to(x.dtype)


def check_shape(x, expected_shape, name=None):
    got = tuple(x.shape)
    want = tuple(int(s) if s is not None else None for s in expected_shape)
    if len(got) != len(want):
        raise ValueError(f"check_shape failed: rank {len(got)} != "
                         f"expected rank {len(want)} (got {got}, want {want})")
    for g, w in zip(got, want):
        if w is not None and w != -1 and g != w:
            raise ValueError(f"check_shape failed: got {got}, expected {want}")
    return x


def stft(x, n_fft, hop_length=None, win_length=None, window=None,
         center=True, pad_mode="reflect", normalized=False, onesided=True,
         name=None):
    raise NotImplementedError(
        "stft belongs to paddle.signal, ported with the long tail "
        "(ROADMAP.md Queue 1 item 1f)")


def istft(x, n_fft, hop_length=None, win_length=None, window=None,
          center=True, normalized=False, onesided=True, length=None,
          return_complex=False, name=None):
    raise NotImplementedError(
        "istft belongs to paddle.signal, ported with the long tail "
        "(ROADMAP.md Queue 1 item 1f)")


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None, name=None):
    """Levenshtein distance per batch row (a host-side DP, as the
    reference's). Returns (distance [B, 1] float32, sequence count)."""
    hyp = np.asarray(Tensor._wrap(raw(input)).numpy())
    ref = np.asarray(Tensor._wrap(raw(label)).numpy())
    dev = raw(input).device
    if hyp.ndim == 1:
        hyp = hyp[None]
    if ref.ndim == 1:
        ref = ref[None]

    def lens(t, arr):
        if t is None:
            return np.full(arr.shape[0], arr.shape[1], np.int64)
        return np.asarray(Tensor._wrap(raw(t)).numpy()).reshape(-1)

    hl, rl = lens(input_length, hyp), lens(label_length, ref)
    ignored = set(ignored_tokens or ())
    out = np.zeros((hyp.shape[0], 1), np.float32)
    for b in range(hyp.shape[0]):
        h = [t for t in hyp[b, :hl[b]] if t not in ignored]
        r = [t for t in ref[b, :rl[b]] if t not in ignored]
        m, n = len(h), len(r)
        d = np.arange(n + 1, dtype=np.float64)
        for i in range(1, m + 1):
            prev = d.copy()
            d[0] = i
            for j in range(1, n + 1):
                d[j] = min(prev[j] + 1, d[j - 1] + 1,
                           prev[j - 1] + (h[i - 1] != r[j - 1]))
        dist = d[n]
        if normalized:
            dist = dist / max(n, 1)
        out[b, 0] = dist
    return (Tensor._wrap(torch.as_tensor(out, device=dev)),
            Tensor._wrap(torch.tensor(hyp.shape[0], device=dev)))


@op("hinge_loss")
def hinge_loss(input, label, name=None):
    return tie_clamp(1.0 - input * (2.0 * label.detach() - 1.0), 0.0)


def fill_diagonal_(x, value, offset=0, wrap=False, name=None):
    """Fill the diagonal in place (2-D: at `offset`, restarting every
    ncols + 1 rows with wrap; N-D: x[i, i, ..., i])."""
    a = raw(x)
    if a.dim() == 2:
        h, w = a.shape
        rows = np.arange(h)
        cols = rows + offset
        if wrap and h > w:
            cols = cols % (w + 1)
            keep = cols < w
        else:
            keep = (cols >= 0) & (cols < w)
        idx = (torch.as_tensor(rows[keep], device=a.device),
               torch.as_tensor(cols[keep], device=a.device))
    else:
        r = torch.arange(min(a.shape), device=a.device)
        idx = (r,) * a.dim()
    new = a.detach().index_put(idx, torch.tensor(value, dtype=a.dtype,
                                                 device=a.device))
    return x._write(new) if isinstance(x, Tensor) else a.copy_(new)


@op("fill_diagonal_tensor")
def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1, name=None):
    d1, d2 = dim1 % x.dim(), dim2 % x.dim()
    n1, n2 = x.shape[d1], x.shape[d2]
    rows = np.arange(n1)
    keep = (rows + offset >= 0) & (rows + offset < n2)
    rr = torch.as_tensor(rows[keep], device=x.device)
    cc = rr + offset
    rest = [i for i in range(x.dim()) if i not in (d1, d2)]
    perm = rest + [d1, d2]
    at = x.permute(perm)
    out = at.clone()
    out[..., rr, cc] = y.detach()[..., :rr.shape[0]].to(x.dtype)
    return out.permute([int(i) for i in np.argsort(perm)])


def fill_diagonal_tensor_(x, y, offset=0, dim1=0, dim2=1, name=None):
    out = fill_diagonal_tensor(x, y, offset, dim1, dim2)
    return x._write(raw(out)) if isinstance(x, Tensor) else x.copy_(out)


@op("shuffle_batch")
def shuffle_batch(x, seed=0, name=None):
    perm = torch.randperm(x.shape[0], generator=_gen(x.device, seed),
                          device=x.device)
    return x[perm]


@op("truncated_gaussian_random")
def truncated_gaussian_random(shape, mean=0.0, std=1.0, a=-2.0, b=2.0,
                              dtype="float32", seed=0, name=None):
    """N(mean, std) truncated to [a, b] std units (the inverse-CDF
    draw)."""
    from ..core import dtype as dtypes
    from ..core.device import current_device

    dev = current_device()
    cdf = lambda v: 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))  # noqa: E731
    u = torch.rand(tuple(int(s) for s in shape), generator=_gen(dev, seed),
                   dtype=torch.float64, device=dev)
    u = cdf(a) + (cdf(b) - cdf(a)) * u
    z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return (z.clamp(a, b) * std + mean).to(dtypes.convert_dtype(dtype))


@op("affine_channel")
def affine_channel(x, scale, bias, data_format="NCHW", name=None):
    ch_axis = 1 if data_format == "NCHW" else -1
    shape = [1] * x.dim()
    shape[ch_axis] = -1
    return x * scale.reshape(shape) + bias.reshape(shape)


__all__ = public(globals())
