"""Shape, layout and indexing ops.

Port of paddle_tpu/ops/manipulation.py. The reference's meanings where
torch's differ: `split(x, n)` cuts n pieces (not pieces of size n);
`gather(x, index, axis)` is `index_select` (index of any shape, as
`jnp.take`); `scatter(x, index, updates, overwrite)` writes (or adds)
whole rows; `sort` returns the values only (a descending sort reverses a
stable ascending one, as the reference's); `flatten(start_axis,
stop_axis)`; `transpose(perm)`; `unique` sorts, as numpy's.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.dispatch import op
from ..core.tensor import Tensor
from ._helpers import inplace_variant, like, norm_axis, pair, public, raw


def _static_shape(shape):
    if isinstance(shape, (Tensor, torch.Tensor)):
        return tuple(int(v) for v in raw(shape).reshape(-1).tolist())
    return tuple(int(raw(s).item()) if isinstance(raw(s), torch.Tensor)
                 else int(s) for s in shape)


def _axis(axis):
    return int(raw(axis).item()) if isinstance(raw(axis), torch.Tensor) \
        else int(axis)


@op("cast")
def _cast_float(x, dt):
    return x.to(dt)


@op("cast", n_diff=0)
def _cast_other(x, dt):
    return x.to(dt)


def cast(x, dtype, name=None):
    dt = dtypes.convert_dtype(dtype)
    if x.dtype == dt:
        return x
    if dtypes.is_floating_point(dt) or dtypes.is_complex(dt):
        return _cast_float(x, dt)
    return _cast_other(x, dt)


@op("reshape")
def reshape(x, shape, name=None):
    return torch.reshape(x, _static_shape(shape))


@op("transpose")
def transpose(x, perm, name=None):
    return x.permute([int(p) for p in perm])


@op("t")
def t(x, name=None):
    return x.permute(list(range(x.dim()))[::-1]) if x.dim() >= 2 else x


@op("flatten")
def flatten(x, start_axis=0, stop_axis=-1, name=None):
    nd = x.dim()
    if nd == 0:
        return x.reshape(1)
    s0, s1 = start_axis % nd, stop_axis % nd
    return x.reshape(tuple(x.shape[:s0]) + (-1,) + tuple(x.shape[s1 + 1:]))


@op("squeeze")
def squeeze(x, axis=None, name=None):
    ax = norm_axis(axis)
    if ax is None:
        return torch.squeeze(x)
    axes = ax if isinstance(ax, tuple) else (ax,)
    axes = tuple(a % x.dim() for a in axes if x.shape[a % x.dim()] == 1)
    return torch.squeeze(x, axes) if axes else x


@op("unsqueeze")
def unsqueeze(x, axis, name=None):
    ax = norm_axis(axis)
    axes = ax if isinstance(ax, tuple) else (ax,)
    for a in sorted(a % (x.dim() + 1) for a in axes):
        x = x.unsqueeze(a)
    return x


@op("concat")
def concat(x, axis=0, name=None):
    return torch.cat(list(x), _axis(axis))


@op("stack")
def stack(x, axis=0, name=None):
    return torch.stack(list(x), axis)


@op("split")
def split(x, num_or_sections, axis=0, name=None):
    """num_or_sections: an int n cuts n equal pieces (the reference does
    not check that n divides the axis: each piece is dim // n); a list
    gives the sizes, one of them may be -1."""
    ax = _axis(axis)
    dim = x.shape[ax]
    if isinstance(num_or_sections, int):
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = [int(raw(s)) for s in num_or_sections]
        if builtins.any(s < 0 for s in sizes):
            known = builtins.sum(s for s in sizes if s >= 0)
            sizes = [s if s >= 0 else dim - known for s in sizes]
    offs = np.cumsum([0] + sizes[:-1])
    return [x.narrow(ax, int(o), int(s)) for o, s in zip(offs, sizes)]


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


@op("unbind")
def unbind(x, axis=0, name=None):
    return list(torch.unbind(x, axis))


@op("tile")
def tile(x, repeat_times, name=None):
    return torch.tile(x, _static_shape(repeat_times))


@op("expand")
def expand(x, shape, name=None):
    target = list(_static_shape(shape))
    off = len(target) - x.dim()
    for i in range(len(target)):
        if target[i] == -1:
            target[i] = x.shape[i - off]
    return x.broadcast_to(target)


@op("expand_as")
def expand_as(x, y, name=None):
    return x.broadcast_to(y.shape)


broadcast_to = expand


@op("broadcast_tensors")
def broadcast_tensors(inputs, name=None):
    return list(torch.broadcast_tensors(*inputs))


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


@op("flip")
def flip(x, axis, name=None):
    ax = norm_axis(axis)
    ax = tuple(range(x.dim())) if ax is None else (
        ax if isinstance(ax, tuple) else (ax,))
    return torch.flip(x, ax)


@op("rot90")
def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(x, k, list(axes))


@op("roll")
def roll(x, shifts, axis=None, name=None):
    ax = norm_axis(axis)
    sh = tuple(int(raw(s)) for s in shifts) if isinstance(
        shifts, (list, tuple)) else int(raw(shifts))
    if ax is None and isinstance(sh, tuple):
        sh = builtins.sum(sh)        # rolls of the flattened tensor add up
    return torch.roll(x, sh, ax)


@op("moveaxis")
def moveaxis(x, source, destination, name=None):
    return torch.movedim(x, source, destination)


@op("swapaxes")
def swapaxes(x, axis0, axis1, name=None):
    return torch.swapaxes(x, axis0, axis1)


def _take(a, idx, ax):
    """jnp.take along ax with an index of any shape."""
    ax = ax % a.dim()
    idx = idx.long()
    out = torch.index_select(a, ax, idx.reshape(-1))
    return out.reshape(tuple(a.shape[:ax]) + tuple(idx.shape)
                       + tuple(a.shape[ax + 1:]))


@op("gather")
def gather(x, index, axis=0, name=None):
    return _take(x, index, _axis(axis))


def _nd_index(a, idx):
    idx = idx.long()
    flat = idx.reshape(-1, idx.shape[-1])
    return tuple(flat[:, i] for i in range(idx.shape[-1]))


@op("gather_nd")
def gather_nd(x, index, name=None):
    k = index.shape[-1]
    out = x[_nd_index(x, index)]
    return out.reshape(tuple(index.shape[:-1]) + tuple(x.shape[k:]))


def _last_wins(target, v, size):
    """v (one row per entry of the 1-D `target`, ids below `size`) with
    the rows of every repeated target made the last one's, detached: a
    write of them gives one value per target on any device (the card's
    scatter picks an arbitrary duplicate), the last as a sequential
    write does, and the gradient reaches the written rows only."""
    pos = torch.arange(target.numel(), device=target.device)
    win = torch.full((size,), -1, dtype=torch.long, device=target.device)
    win = win.scatter_reduce(0, target, pos, "amax")[target]
    keep = (win == pos).reshape((-1,) + (1,) * (v.dim() - 1))
    return torch.where(keep, v, v.detach()[win])


@op("scatter")
def scatter(x, index, updates, overwrite=True, name=None):
    """Rows `index` of x set to (or, overwrite=False, added with)
    `updates`; a repeated row takes its last update."""
    idx = index.long().reshape(-1)
    upd = updates.to(x.dtype)
    if overwrite:
        upd = _last_wins(idx, upd.reshape((idx.numel(),) + tuple(
            x.shape[1:])), x.shape[0])
    return torch.index_put(x, (idx,), upd, accumulate=not overwrite)


def scatter_(x, index, updates, overwrite=True, name=None):
    out = scatter(x, index, updates, overwrite)
    return x._write(out._data) if isinstance(x, Tensor) else x.copy_(out)


@op("scatter_nd_add")
def scatter_nd_add(x, index, updates, name=None):
    k = index.shape[-1]
    upd = updates.reshape((-1,) + tuple(x.shape[k:])).to(x.dtype)
    return torch.index_put(x, _nd_index(x, index), upd, accumulate=True)


@op("scatter_nd")
def scatter_nd(index, updates, shape, name=None):
    z = torch.zeros(_static_shape(shape), dtype=updates.dtype,
                    device=updates.device)
    return scatter_nd_add(z, index, updates)


def index_select(x, index, axis=0, name=None):
    return gather(x, index, axis)


@op("index_sample")
def index_sample(x, index, name=None):
    return torch.gather(x, 1, index.long())


@op("index_add")
def index_add(x, index, axis, value, name=None):
    return torch.index_add(x, axis, index.long(), value.to(x.dtype))


@op("index_put")
def index_put(x, indices, value, accumulate=False, name=None):
    idxs = tuple(i if i.dtype == torch.bool else i.long() for i in indices)
    v = like(value, x).to(x.dtype)
    if not accumulate and all(i.dtype != torch.bool for i in idxs):
        k = len(idxs)
        ids = torch.arange(int(np.prod(x.shape[:k])), device=x.device)
        ids = ids.reshape(x.shape[:k])[idxs]
        rest = tuple(x.shape[k:])
        v = _last_wins(ids.reshape(-1), v.broadcast_to(
            tuple(ids.shape) + rest).reshape((-1,) + rest),
            int(np.prod(x.shape[:k]))).reshape(tuple(ids.shape) + rest)
    return torch.index_put(x, idxs, v, accumulate=accumulate)


@op("take_along_axis")
def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    ax = axis % arr.dim()
    idx = indices.long()
    if broadcast:
        sa, si = list(arr.shape), list(idx.shape)
        na, ni = sa[ax], si[ax]
        sa[ax] = si[ax] = 1
        b = list(torch.broadcast_shapes(sa, si))
        arr = arr.broadcast_to(b[:ax] + [na] + b[ax + 1:])
        idx = idx.broadcast_to(b[:ax] + [ni] + b[ax + 1:])
    return torch.gather(arr, ax, idx)


_REDUCE = {"add": "sum", "sum": "sum", "mul": "prod", "multiply": "prod",
           "amax": "amax", "amin": "amin", "mean": "mean"}


@op("put_along_axis")
def put_along_axis(arr, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True, name=None):
    a = arr
    ax = axis % a.dim()
    idx = indices.long()
    v = values if isinstance(values, torch.Tensor) else None
    if v is None or v.dim() == 0:
        v = torch.as_tensor(values if v is None else v, dtype=a.dtype,
                            device=a.device).broadcast_to(idx.shape)
    if broadcast:
        tgt = list(a.shape)
        tgt[ax] = idx.shape[ax] if idx.dim() == a.dim() else idx.shape[-1]
        idx = idx.broadcast_to(tgt)
        v = v.broadcast_to(tgt)
    v = v.to(a.dtype)
    if reduce == "assign":
        flat = torch.arange(a.numel(), device=a.device).reshape(a.shape)
        target = torch.gather(flat, ax, idx).reshape(-1)
        v = _last_wins(target, v.reshape(-1), a.numel()).reshape(idx.shape)
        return torch.scatter(a, ax, idx, v)
    if reduce not in _REDUCE:
        raise ValueError(reduce)
    return torch.scatter_reduce(a, ax, idx, v, _REDUCE[reduce],
                                include_self=include_self)


@op("take")
def take(x, index, mode="raise", name=None):
    flat = x.reshape(-1)
    n = flat.shape[0]
    i = index.long()
    if mode == "wrap":
        i = torch.remainder(i, n)
    elif mode == "clip":
        i = torch.clamp(i, 0, n - 1)
    else:
        i = torch.where(i < 0, i + n, i)
    return flat[i]


@op("masked_select", n_diff=0)
def masked_select(x, mask, name=None):
    return torch.masked_select(x, mask.bool())


@op("masked_fill")
def masked_fill(x, mask, value, name=None):
    v = value.detach() if isinstance(value, torch.Tensor) else value
    return torch.where(mask.bool(), like(v, x).to(x.dtype), x)


@op("masked_scatter", n_diff=0)
def masked_scatter(x, mask, value, name=None):
    return torch.masked_scatter(x, mask.bool(),
                                value.reshape(-1).to(x.dtype))


@op("where")
def _where(condition, x, y):
    if not isinstance(condition, torch.Tensor):
        condition = torch.as_tensor(condition)
    c = condition if condition.dtype == torch.bool else condition != 0
    if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
        x, y = pair(x, y)
    return torch.where(c, x, y)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    return _where(condition, x, y)


@op("nonzero", n_diff=0)
def nonzero(x, as_tuple=False, name=None):
    if as_tuple:
        return tuple(torch.nonzero(x, as_tuple=True))
    return torch.nonzero(x)


def _clip_bound(v, dim):
    v = int(raw(v))
    return builtins.max(v + dim, 0) if v < 0 else builtins.min(v, dim)


@op("slice")
def slice(input, axes, starts, ends, name=None):
    out = input
    for ax, s, e in zip(axes, starts, ends):
        dim = out.shape[ax]
        s, e = _clip_bound(s, dim), _clip_bound(e, dim)
        out = out.narrow(ax, s, builtins.max(e - s, 0))
    return out


def _strided(a, ax, s, e, st):
    if st > 0:
        return a[(builtins.slice(None),) * (ax % a.dim())
                 + (builtins.slice(s, e, st),)]
    idx = range(*builtins.slice(s, e, st).indices(a.shape[ax]))
    return torch.index_select(a, ax, torch.tensor(list(idx),
                                                  dtype=torch.long,
                                                  device=a.device))


@op("strided_slice")
def strided_slice(x, axes, starts, ends, strides, name=None):
    for ax, s, e, st in zip(axes, starts, ends, strides):
        x = _strided(x, ax, int(raw(s)), int(raw(e)), int(raw(st)))
    return x


def _pad_widths(nd, padv, data_format):
    if len(padv) == 2 * nd:
        return [(padv[2 * i], padv[2 * i + 1]) for i in range(nd)]
    k = len(padv) // 2
    pairs = [(padv[2 * i], padv[2 * i + 1]) for i in range(k)][::-1]
    if len(padv) == 2 * (nd - 2) and nd >= 3 \
            and not data_format.startswith("NC"):
        return [(0, 0)] + pairs + [(0, 0)]
    return [(0, 0)] * (nd - k) + pairs


def _edge_index(n, before, after, mode):
    """The source index of every padded position along one axis
    (numpy's reflect / edge / wrap)."""
    j = np.arange(-before, n + after)
    if mode == "edge":
        return np.clip(j, 0, n - 1)
    if mode == "wrap":
        return np.mod(j, n)
    period = 2 * (n - 1) if n > 1 else 1        # reflect
    j = np.mod(j, period)
    return np.where(j >= n, period - j, j)


@op("pad")
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    width = _pad_widths(x.dim(), _static_shape(pad), data_format)
    if mode == "constant":
        flat = [v for b, a in width[::-1] for v in (b, a)]
        return torch.nn.functional.pad(x, flat, value=value)
    jmode = {"reflect": "reflect", "replicate": "edge",
             "circular": "wrap"}[mode]
    for ax, (b, a) in enumerate(width):
        if b or a:
            idx = torch.as_tensor(_edge_index(x.shape[ax], b, a, jmode),
                                  device=x.device)
            x = torch.index_select(x, ax, idx)
    return x


@op("repeat_interleave")
def repeat_interleave(x, repeats, axis=None, name=None):
    if isinstance(repeats, torch.Tensor):
        return torch.repeat_interleave(x, repeats, axis).detach()
    return torch.repeat_interleave(x, repeats, axis)


def _first_index(inv, n):
    """The first position of each of n unique values (numpy's
    return_index) from the inverse map of a flattened input."""
    pos = torch.arange(inv.numel(), device=inv.device)
    big = torch.full((n,), inv.numel(), dtype=torch.long, device=inv.device)
    return big.scatter_reduce(0, inv.reshape(-1), pos, "amin")


@op("unique", n_diff=0)
def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    a = x.reshape(-1) if axis is None else x
    vals, inv, cnt = torch.unique(a, sorted=True, return_inverse=True,
                                  return_counts=True, dim=axis)
    idt = dtypes.convert_dtype(dtype)
    outs = [vals]
    if return_index:
        outs.append(_first_index(inv, cnt.numel()).to(idt))
    if return_inverse:
        outs.append((inv.reshape(x.shape) if axis is None else inv).to(idt))
    if return_counts:
        outs.append(cnt.to(idt))
    return outs[0] if len(outs) == 1 else tuple(outs)


@op("unique_consecutive", n_diff=0)
def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    if axis is not None:
        raise NotImplementedError("unique_consecutive with axis")
    vals, inv, cnt = torch.unique_consecutive(
        x.reshape(-1), return_inverse=True, return_counts=True)
    idt = dtypes.convert_dtype(dtype)
    outs = [vals]
    if return_inverse:
        outs.append(inv.to(idt))
    if return_counts:
        outs.append(cnt.to(idt))
    return outs[0] if len(outs) == 1 else tuple(outs)


@op("sort")
def sort(x, axis=-1, descending=False, stable=False, name=None):
    """The sorted values only (no indices), as the reference's."""
    out = torch.sort(x, dim=axis, stable=True).values
    return torch.flip(out, (axis,)) if descending else out


@op("argsort", n_diff=0)
def argsort(x, axis=-1, descending=False, stable=False, name=None):
    if not descending:
        return torch.argsort(x, dim=axis, stable=True).to(torch.int64)
    if stable:
        return torch.sort(x, dim=axis, descending=True,
                          stable=True).indices.to(torch.int64)
    return torch.flip(torch.argsort(x, dim=axis, stable=True),
                      (axis,)).to(torch.int64)


def _bsearch(seq, v, right):
    """jnp.searchsorted's default method (a binary search of
    ceil(log2(n + 1)) halvings), which gives the reference's answer also
    on an unsorted sequence."""
    n = seq.shape[-1]
    low = torch.zeros(v.shape, dtype=torch.long, device=v.device)
    high = torch.full(v.shape, n, dtype=torch.long, device=v.device)
    for _ in range(int(np.ceil(np.log2(n + 1)))):
        mid = torch.div(low + high, 2, rounding_mode="floor")
        s = torch.gather(seq, -1, mid.clamp_max(n - 1)) if seq.dim() > 1 \
            else seq[mid.clamp_max(n - 1)]
        left = v < s if right else v <= s
        low, high = torch.where(left, low, mid), torch.where(left, mid, high)
    return high


@op("searchsorted", n_diff=0)
def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    seq, v = sorted_sequence, values
    if seq.dim() > 1:
        out = _bsearch(seq.reshape(-1, seq.shape[-1]),
                       v.reshape(-1, v.shape[-1]), right).reshape(v.shape)
    else:
        out = _bsearch(seq, v, right)
    return out.to(torch.int32 if out_int32 else torch.int64)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32, right)


@op("one_hot", n_diff=0)
def one_hot(x, num_classes, name=None):
    valid = (x >= 0) & (x < num_classes)
    out = torch.nn.functional.one_hot(torch.where(valid, x, 0).long(),
                                      num_classes)
    return (out * valid.unsqueeze(-1)).to(torch.float32)


@op("tensordot")
def tensordot(x, y, axes=2, name=None):
    ax = axes
    if isinstance(ax, (list, tuple)):
        ax = [[int(i) for i in part] if isinstance(part, (list, tuple))
              else [int(part)] for part in ax]
    return torch.tensordot(x, y, dims=ax)


@op("as_strided")
def as_strided(x, shape, stride, offset=0, name=None):
    idx = np.zeros(tuple(shape), dtype=np.int64) + offset
    for d, (s, st) in enumerate(zip(shape, stride)):
        idx += (np.arange(s) * st).reshape(
            [-1 if i == d else 1 for i in range(len(shape))])
    return x.reshape(-1)[torch.as_tensor(idx, device=x.device)]


@op("view", n_diff=0)
def _bitcast(x, dt):
    return x.view(dt)


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return _bitcast(x, dtypes.convert_dtype(shape_or_dtype))


def view_as(x, other, name=None):
    return reshape(x, other.shape)


@op("unfold")
def unfold(x, axis, size, step, name=None):
    """Windows of `size` every `step` along `axis`: that axis becomes the
    window count and the windows a new last axis (Paddle's meaning; the
    reference's composition gives it at axis 0 only, ROADMAP.md Queue 3
    F8)."""
    return x.unfold(axis, size, step)


@op("crop")
def crop(x, shape=None, offsets=None, name=None):
    shp = _static_shape(shape)
    offs = _static_shape(offsets) if offsets is not None else (0,) * len(shp)
    for i, (o, s) in enumerate(zip(offs, shp)):
        x = x.narrow(i, o, s if s != -1 else x.shape[i] - o)
    return x


def _atleast(tfn, opname):
    @op(opname)
    def f(*xs, name=None):
        outs = [tfn(x) for x in xs]
        return outs[0] if len(outs) == 1 else outs

    f.__name__ = f.__qualname__ = opname
    return f


atleast_1d = _atleast(torch.atleast_1d, "atleast_1d")
atleast_2d = _atleast(torch.atleast_2d, "atleast_2d")
atleast_3d = _atleast(torch.atleast_3d, "atleast_3d")


def hsplit(x, num_or_indices, name=None):
    return split(x, num_or_indices, axis=1 if x.ndim > 1 else 0)


def vsplit(x, num_or_indices, name=None):
    return split(x, num_or_indices, axis=0)


def dsplit(x, num_or_indices, name=None):
    return split(x, num_or_indices, axis=2)


def hstack(x, name=None):
    return concat(x, axis=1 if x[0].ndim > 1 else 0)


def vstack(x, name=None):
    return concat([unsqueeze(t, 0) if t.ndim == 1 else t for t in x], axis=0)


def dstack(x, name=None):
    return concat([reshape(t, list(t.shape) + [1]) if t.ndim <= 2 else t
                   for t in x], axis=2)


def column_stack(x, name=None):
    return concat([unsqueeze(t, 1) if t.ndim == 1 else t for t in x], axis=1)


def row_stack(x, name=None):
    return vstack(x)


def number_of_elements(x):
    return raw(x).numel()


# in-place variants
reshape_ = inplace_variant(reshape)
squeeze_ = inplace_variant(squeeze)
unsqueeze_ = inplace_variant(unsqueeze)
flatten_ = inplace_variant(flatten)
transpose_ = inplace_variant(transpose)
cast_ = inplace_variant(cast)

__all__ = public(globals())
