"""Tensor creation ops.

Port of paddle_tpu/ops/creation.py. Ops that make a tensor from nothing
(`zeros`, `arange`, `eye`, ...) put it on the current device (the card
unless `set_device` chose another) and return a Tensor; the `*_like` ops
follow their input.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.device import current_device
from ..core.dispatch import op
from ..core.tensor import Parameter, Tensor
from ._helpers import public, raw


def _dt(dtype):
    return dtypes.convert_dtype(dtype) if dtype is not None \
        else dtypes.get_default_dtype()


def _shape(shape):
    if isinstance(shape, (Tensor, torch.Tensor)):
        return tuple(int(s) for s in raw(shape).reshape(-1).tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(raw(s)) for s in shape)


def _scalar(v):
    return raw(v).item() if isinstance(v, (Tensor, torch.Tensor)) else v


@op("zeros")
def zeros(shape, dtype=None, name=None):
    return torch.zeros(_shape(shape), dtype=_dt(dtype),
                       device=current_device())


@op("ones")
def ones(shape, dtype=None, name=None):
    return torch.ones(_shape(shape), dtype=_dt(dtype),
                      device=current_device())


@op("full")
def full(shape, fill_value, dtype=None, name=None):
    fill_value = _scalar(fill_value)
    if dtype is None and isinstance(fill_value, bool):
        dtype = dtypes.bool_
    elif dtype is None and isinstance(fill_value, int):
        dtype = dtypes.int64
    return torch.full(_shape(shape), fill_value, dtype=_dt(dtype),
                      device=current_device())


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype, name)


@op("zeros_like", n_diff=0)
def zeros_like(x, dtype=None, name=None):
    return torch.zeros_like(x, dtype=dtypes.convert_dtype(dtype))


@op("ones_like", n_diff=0)
def ones_like(x, dtype=None, name=None):
    return torch.ones_like(x, dtype=dtypes.convert_dtype(dtype))


@op("full_like", n_diff=0)
def full_like(x, fill_value, dtype=None, name=None):
    return torch.full_like(x, _scalar(fill_value),
                           dtype=dtypes.convert_dtype(dtype))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype, name)


@op("arange")
def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = (_scalar(v) for v in (start, end, step))
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = dtypes.int64 if all(
            isinstance(v, (int, np.integer)) for v in (start, end, step)) \
            else dtypes.get_default_dtype()
    return torch.arange(start, end, step, dtype=dtypes.convert_dtype(dtype),
                        device=current_device())


@op("linspace")
def linspace(start, stop, num, dtype=None, name=None):
    return torch.linspace(_scalar(start), _scalar(stop), int(_scalar(num)),
                          dtype=_dt(dtype), device=current_device())


@op("logspace")
def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return torch.logspace(_scalar(start), _scalar(stop), int(_scalar(num)),
                          base=base, dtype=_dt(dtype),
                          device=current_device())


@op("eye")
def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = int(num_rows)
    m = n if num_columns is None else int(num_columns)
    return torch.eye(n, m, dtype=_dt(dtype), device=current_device())


@op("diag")
def diag(x, offset=0, padding_value=0, name=None):
    if x.dim() == 1:
        out = torch.diag(x, offset)
        if padding_value != 0:
            mask = torch.diag(torch.ones_like(x, dtype=torch.bool), offset)
            out = torch.where(mask, out, padding_value)
        return out
    return torch.diagonal(x, offset)


@op("diagflat")
def diagflat(x, offset=0, name=None):
    return torch.diagflat(x, offset)


@op("diag_embed")
def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    return torch.diag_embed(x, offset, dim1, dim2)


@op("tril")
def tril(x, diagonal=0, name=None):
    return torch.tril(x, diagonal)


@op("triu")
def triu(x, diagonal=0, name=None):
    return torch.triu(x, diagonal)


@op("tril_indices")
def tril_indices(row, col, offset=0, dtype="int64", name=None):
    return torch.tril_indices(row, col, offset, device=current_device(),
                              dtype=dtypes.convert_dtype(dtype))


@op("triu_indices")
def triu_indices(row, col=None, offset=0, dtype="int64", name=None):
    return torch.triu_indices(row, col or row, offset,
                              device=current_device(),
                              dtype=dtypes.convert_dtype(dtype))


@op("meshgrid")
def meshgrid(*args, name=None):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = args[0]
    return list(torch.meshgrid(*args, indexing="ij"))


@op("assign")
def _assign(x):
    return x.clone()


def assign(x, output=None, name=None):
    """A copy of x (differentiable for a tensor; a Tensor from numpy or
    Python data); with `output`, written into it."""
    if isinstance(x, (Tensor, torch.Tensor)):
        out = _assign(x)
    else:
        out = Tensor(x)
    if output is not None:
        output._write(raw(out).detach() if not torch.is_grad_enabled()
                      else raw(out))
        return output
    return out


def clone(x, name=None):
    return assign(x)


@op("complex")
def complex(real, imag, name=None):
    return torch.complex(real, imag)


@op("polar")
def polar(abs_, angle, name=None):
    return torch.polar(abs_, angle)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A Parameter of `shape`: zeros for a bias, else N(0, 0.02) drawn
    from a generator seeded 0 (the reference draws from PRNGKey(0));
    `attr.initializer` or `default_initializer` when given."""
    attr_init = getattr(attr, "initializer", None) if attr is not None \
        else None
    dev = current_device()
    dt = dtypes.convert_dtype(dtype)
    if default_initializer is not None and attr_init is None:
        data = raw(default_initializer(shape, dtype))
        if not isinstance(data, torch.Tensor):
            data = torch.as_tensor(np.asarray(data), device=dev)
    elif is_bias:
        data = torch.zeros(_shape(shape), dtype=dt, device=dev)
    else:
        g = torch.Generator(device=dev).manual_seed(0)
        data = (torch.randn(_shape(shape), generator=g, device=dev)
                * 0.02).to(dt)
    p = Parameter(data.detach(), _internal=True)
    if name is not None:
        p.name = name
    if attr_init is not None:
        attr_init(p)
    if attr is not None and getattr(attr, "trainable", True) is False:
        p.stop_gradient = True
    return p


__all__ = public(globals())
