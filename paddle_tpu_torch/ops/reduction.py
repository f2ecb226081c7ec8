"""Reduction and search ops.

Port of paddle_tpu/ops/reduction.py. The reference's semantics where
torch's differ: `max` / `min` return the values only and split a tie's
gradient among the tied elements (`torch.amax`, as `jnp.max`); an empty
axis list reduces nothing (torch reads it as all axes); `median` averages
the two middle elements of an even count and `mode` picks the first most
frequent value in input order; `sum` and `prod` of integers are int64
and `mean` of integers floating (`_helpers.inexact`).
"""
from __future__ import annotations

import torch

from ..core import dtype as dtypes
from ..core.dispatch import op
from ._helpers import dims, inexact, norm_axis, public, tie_abs


def _each_dim(fn, a, ax, keepdim):
    """Apply a one-dim reduction `fn(a, dim, keepdim)` over every dim of
    ax (descending, so the indices stay valid)."""
    for d in sorted((d % a.dim() for d in ax), reverse=True) if a.dim() \
            else []:
        a = fn(a, d, keepdim)
    return a


def _red(tfn, opname, int_promote=False, float_ints=False, multi=True):
    @op(opname)
    def f(x, axis=None, keepdim=False, name=None, dtype=None):
        ax = norm_axis(axis)
        a = x
        if int_promote and dtype is None and dtypes.is_integer(a.dtype):
            a = a.to(torch.int64)
        if float_ints and not (a.is_floating_point() or a.is_complex()):
            a = a.to(inexact(a.dtype))
        if ax == ():
            out = a
        elif multi:
            out = tfn(a, dims(ax, a.dim()), keepdim)
        else:
            out = _each_dim(tfn, a, dims(ax, a.dim()), keepdim)
        if dtype is not None:
            out = out.to(dtypes.convert_dtype(dtype))
        return out

    f.__name__ = f.__qualname__ = opname
    return f


def _sum(a, d, k):
    return torch.sum(a, d, keepdim=k)


def _prod(a, d, k):
    return torch.prod(a, d, keepdim=k)


sum = _red(_sum, "sum", int_promote=True)
mean = _red(lambda a, d, k: torch.mean(a, d, keepdim=k), "mean",
            float_ints=True)
prod = _red(_prod, "prod", int_promote=True, multi=False)
amax = _red(lambda a, d, k: torch.amax(a, d, keepdim=k), "amax")
amin = _red(lambda a, d, k: torch.amin(a, d, keepdim=k), "amin")
nansum = _red(lambda a, d, k: torch.nansum(a, d, keepdim=k), "nansum")
nanmean = _red(lambda a, d, k: torch.nanmean(a, d, keepdim=k), "nanmean")
logsumexp = _red(lambda a, d, k: torch.logsumexp(a, d, keepdim=k),
                 "logsumexp")


@op("max")
def max(x, axis=None, keepdim=False, name=None):
    """The largest values along axis (a tensor, not a pair)."""
    ax = norm_axis(axis)
    return x if ax == () else torch.amax(x, dims(ax, x.dim()), keepdim)


@op("min")
def min(x, axis=None, keepdim=False, name=None):
    """The smallest values along axis (a tensor, not a pair)."""
    ax = norm_axis(axis)
    return x if ax == () else torch.amin(x, dims(ax, x.dim()), keepdim)


def _bool_red(tfn, opname):
    @op(opname, n_diff=0)
    def f(x, axis=None, keepdim=False, name=None):
        ax = norm_axis(axis)
        a = x.bool()
        if ax == ():
            return a
        return _each_dim(lambda t, d, k: tfn(t, d, keepdim=k), a,
                         dims(ax, a.dim()), keepdim)

    f.__name__ = f.__qualname__ = opname
    return f


all = _bool_red(torch.all, "all")
any = _bool_red(torch.any, "any")


def _arg(tfn, opname):
    @op(opname, n_diff=0)
    def f(x, axis=None, keepdim=False, dtype="int64", name=None):
        ax = norm_axis(axis)
        if ax is None:
            out = tfn(x.reshape(-1), 0)
            if keepdim:
                out = out.reshape([1] * x.dim())
        else:
            out = tfn(x, ax, keepdim=keepdim)
        return out.to(dtypes.convert_dtype(dtype))

    f.__name__ = f.__qualname__ = opname
    return f


argmax = _arg(torch.argmax, "argmax")
argmin = _arg(torch.argmin, "argmin")


@op("count_nonzero", n_diff=0)
def count_nonzero(x, axis=None, keepdim=False, name=None):
    ax = dims(norm_axis(axis), x.dim())
    out = torch.count_nonzero(x, ax) if ax else (x != 0).to(torch.int64)
    if keepdim and ax:
        for d in sorted(d % x.dim() for d in ax):
            out = out.unsqueeze(d)
    return out.to(torch.int64)


@op("std")
def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return torch.std(x, dims(norm_axis(axis), x.dim()),
                     correction=1 if unbiased else 0, keepdim=keepdim)


@op("var")
def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return torch.var(x, dims(norm_axis(axis), x.dim()),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def _to_last(a, ax):
    """a with the axes of ax (None: all) flattened into one last axis."""
    if ax is None:
        return a.reshape(-1)
    axes = sorted(d % a.dim() for d in (ax if isinstance(ax, tuple)
                                        else (ax,)))
    rest = [d for d in range(a.dim()) if d not in axes]
    moved = a.permute(rest + axes)
    return moved.reshape([a.shape[d] for d in rest] + [-1])


def _keep(out, a, ax, keepdim):
    if not keepdim:
        return out
    axes = range(a.dim()) if ax is None else \
        [d % a.dim() for d in (ax if isinstance(ax, tuple) else (ax,))]
    for d in sorted(axes):
        out = out.unsqueeze(d)
    return out


def _median_sorted(s, n):
    """The average of the two middle elements of sorted rows `s` whose
    first `n` entries (a tensor or int) count."""
    if isinstance(n, int):
        return (s[..., (n - 1) // 2] + s[..., n // 2]) / 2
    lo = torch.div(n - 1, 2, rounding_mode="floor")
    hi = torch.div(n, 2, rounding_mode="floor")
    lo = lo.clamp_min(0).unsqueeze(-1)
    hi = hi.clamp_min(0).unsqueeze(-1)
    v = (s.gather(-1, lo) + s.gather(-1, hi)) / 2
    return v.squeeze(-1)


@op("median")
def _median_avg(x, ax, keepdim):
    a = _to_last(x, ax)
    s = torch.sort(a, dim=-1, stable=True).values
    return _keep(_median_sorted(s, s.shape[-1]), x, ax, keepdim)


@op("median_min", n_diff=0)
def _median_min(x, ax, keepdim):
    if ax is None:
        flat = x.reshape(-1)
        val = torch.sort(flat).values[(flat.shape[0] - 1) // 2]
        return val.reshape((1,) * x.dim()) if keepdim else val
    mid = (x.shape[ax] - 1) // 2
    order = torch.argsort(x, dim=ax, stable=True)
    ind = order.select(ax, mid)
    val = torch.take_along_dim(x, ind.unsqueeze(ax), ax)
    if not keepdim:
        val = val.squeeze(ax)
    else:
        ind = ind.unsqueeze(ax)
    return val, ind.to(torch.int64)


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    ax = norm_axis(axis)
    if mode == "avg":
        return _median_avg(x, ax, keepdim)
    if mode != "min":
        raise ValueError(f"median mode must be 'avg' or 'min', got {mode!r}")
    return _median_min(x, ax, keepdim)


@op("nanmedian")
def nanmedian(x, axis=None, keepdim=False, name=None):
    ax = norm_axis(axis)
    a = _to_last(x, ax)
    s = torch.sort(a, dim=-1, stable=True).values      # NaNs sort last
    n = (~torch.isnan(a)).sum(-1)
    out = _median_sorted(s, n)
    out = torch.where(n == 0, torch.full_like(out, float("nan")), out)
    return _keep(out, x, ax, keepdim)


def _quantile(tfn, a, q, ax, keepdim, interpolation):
    qv = q if isinstance(q, torch.Tensor) else torch.as_tensor(
        q, dtype=torch.float32 if a.dtype != torch.float64 else a.dtype,
        device=a.device)
    work = a if a.dtype in (torch.float32, torch.float64) else a.float()
    out = tfn(_to_last(work, ax), qv.to(work.dtype), dim=-1,
              interpolation=interpolation)
    if qv.dim():                     # q axis leads, as jnp's
        out = torch.stack([_keep(o, a, ax, keepdim) for o in out])
    else:
        out = _keep(out, a, ax, keepdim)
    return out.to(a.dtype) if a.is_floating_point() else out


@op("quantile")
def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    return _quantile(torch.quantile, x, q, norm_axis(axis), keepdim,
                     interpolation)


@op("nanquantile")
def nanquantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile(torch.nanquantile, x, q, norm_axis(axis), keepdim,
                     "linear")


@op("kthvalue")
def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    ax = axis % x.dim()
    srt, idx = torch.sort(x, dim=ax, stable=True)
    val = srt.select(ax, k - 1)
    ind = idx.select(ax, k - 1)
    if keepdim:
        val, ind = val.unsqueeze(ax), ind.unsqueeze(ax)
    return val, ind.to(torch.int64)


@op("mode")
def mode(x, axis=-1, keepdim=False, name=None):
    ax = axis % x.dim()
    av = x.movedim(ax, -1)
    cnt = (av[..., :, None] == av[..., None, :]).sum(-1)
    best = torch.argmax(cnt, -1)
    val = torch.take_along_dim(av, best[..., None], -1)[..., 0]
    idx = torch.argmax((av == val[..., None]).to(torch.int8), -1)
    if keepdim:
        val, idx = val.unsqueeze(ax), idx.unsqueeze(ax)
    return val, idx.to(torch.int64)


@op("topk")
def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    if isinstance(k, torch.Tensor):
        k = int(k.item())
    # a stable sort: among ties the lowest index comes first, as in the
    # reference's top_k (torch.topk leaves their order open)
    ax = axis % x.dim()
    v, i = torch.sort(x, stable=True, dim=ax, descending=largest)
    return v.narrow(ax, 0, k), i.narrow(ax, 0, k)


@op("norm")
def norm(x, p="fro", axis=None, keepdim=False, name=None):
    ax = norm_axis(axis)
    a = x
    if p in ("fro", None) and (ax is None or isinstance(ax, tuple)):
        return torch.sqrt(torch.sum(a * a, dims(ax, a.dim()),
                                    keepdim=keepdim))
    if p == "nuc":
        return torch.sum(torch.linalg.svdvals(a), -1, keepdim=keepdim)
    d = dims(ax, a.dim())
    pv = float(p)
    if pv == float("inf"):
        return torch.amax(tie_abs(a), d, keepdim=keepdim)
    if pv == float("-inf"):
        return torch.amin(tie_abs(a), d, keepdim=keepdim)
    if pv == 0:
        return torch.sum(a != 0, d, keepdim=keepdim).to(a.dtype)
    return torch.pow(torch.sum(torch.pow(tie_abs(a), pv), d,
                               keepdim=keepdim), 1.0 / pv)


def dist(x, y, p=2, name=None):
    return norm(x - y, p=p)


@op("histogram", n_diff=0)
def histogram(x, bins=100, min=0, max=0, name=None):
    a = x.float() if x.dtype != torch.float64 else x
    lo, hi = (min, max) if (min != 0 or max != 0) else \
        (a.min().item(), a.max().item())
    return torch.histc(a, bins, lo, hi).to(torch.int64)


@op("bincount", n_diff=0)
def bincount(x, weights=None, minlength=0, name=None):
    if weights is None:
        return torch.bincount(x, minlength=minlength)
    return torch.bincount(x, weights, minlength=minlength).to(weights.dtype)


__all__ = public(globals())
