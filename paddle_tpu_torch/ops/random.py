"""Random ops on the Tensor API's generators (`core.rng`: one
`torch.Generator` per device, seeded by `seed(n)`).

Port of paddle_tpu/ops/random.py. The values cannot equal jax's; the
distributions, shapes and dtypes are the reference's (`normal` and
`log_normal` without tensor arguments are float64 there, its default
float under x64, and so here). A nonzero `seed` argument pins an op to
its own generator seeded with it, as the reference pins its key.
"""
from __future__ import annotations

import torch

from ..core import dtype as dtypes
from ..core import rng
from ..core.device import current_device
from ..core.dispatch import op
from ._helpers import pair, public
from .creation import _dt, _shape


def _gen(device, seed=0):
    """The device's generator, or a fresh one seeded with `seed`."""
    if not seed:
        return rng.generator(device)
    return torch.Generator(device=device).manual_seed(int(seed))


@op("rand")
def rand(shape, dtype=None, name=None):
    dev = current_device()
    return torch.rand(_shape(shape), generator=_gen(dev), dtype=_dt(dtype),
                      device=dev)


@op("randn")
def randn(shape, dtype=None, name=None):
    dev = current_device()
    return torch.randn(_shape(shape), generator=_gen(dev), dtype=_dt(dtype),
                       device=dev)


@op("uniform")
def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev = current_device()
    u = torch.rand(_shape(shape), generator=_gen(dev, seed),
                   dtype=_dt(dtype), device=dev)
    return u * (max - min) + min


def _fill(x, draw):
    """x's contents replaced by `draw(device)` (x's shape and dtype)."""
    from ..core.tensor import Tensor

    d = x._data if isinstance(x, Tensor) else x
    with torch.no_grad():
        v = draw(d.device, d).to(d.dtype)
    if isinstance(x, Tensor):
        return x._write(v)
    return d.copy_(v)


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    return _fill(x, lambda dev, d: torch.rand(
        d.shape, generator=_gen(dev, seed), device=dev,
        dtype=d.dtype if d.is_floating_point() else torch.float32)
        * (max - min) + min)


@op("normal")
def _normal_t(mean, std):
    """N(mean, std) elementwise, broadcast, on the tensor argument's
    device."""
    mean, std = pair(mean, std)
    shp = torch.broadcast_shapes(mean.shape, std.shape)
    z = torch.randn(shp, generator=_gen(mean.device), device=mean.device,
                    dtype=torch.promote_types(mean.dtype, std.dtype))
    return z * std + mean


@op("normal")
def _normal(mean, std, shape):
    dev = current_device()
    z = torch.randn(_shape(shape), generator=_gen(dev), device=dev,
                    dtype=torch.float64)
    return z * std + mean


def normal(mean=0.0, std=1.0, shape=None, name=None):
    from ..core.tensor import Tensor

    if isinstance(mean, (Tensor, torch.Tensor)) or isinstance(
            std, (Tensor, torch.Tensor)):
        return _normal_t(mean, std)
    return _normal(mean, std, shape)


def normal_(x, mean=0.0, std=1.0, name=None):
    return _fill(x, lambda dev, d: torch.randn(
        d.shape, generator=_gen(dev), device=dev, dtype=d.dtype)
        * std + mean)


@op("gaussian")
def gaussian(shape, mean=0.0, std=1.0, seed=0, dtype=None, name=None):
    dev = current_device()
    return torch.randn(_shape(shape), generator=_gen(dev, seed),
                       dtype=_dt(dtype), device=dev) * std + mean


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype)


@op("randint")
def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    dev = current_device()
    return torch.randint(low, high, _shape(shape), generator=_gen(dev),
                         dtype=dtypes.convert_dtype(dtype), device=dev)


@op("randint_like", n_diff=0)
def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    dt = dtypes.convert_dtype(dtype) if dtype else x.dtype
    return torch.randint(low, high, x.shape, generator=_gen(x.device),
                         dtype=dt, device=x.device)


@op("randperm")
def randperm(n, dtype="int64", name=None):
    dev = current_device()
    return torch.randperm(n, generator=_gen(dev), device=dev).to(
        dtypes.convert_dtype(dtype))


@op("shuffle")
def shuffle(x, axis=0, name=None):
    perm = torch.randperm(x.shape[axis], generator=_gen(x.device),
                          device=x.device)
    return torch.index_select(x, axis, perm)


@op("bernoulli", n_diff=0)
def bernoulli(x, name=None):
    return torch.bernoulli(x, generator=_gen(x.device)).to(x.dtype)


def bernoulli_(x, p=0.5, name=None):
    return _fill(x, lambda dev, d: torch.bernoulli(
        torch.full(d.shape, float(p), device=dev), generator=_gen(dev)))


@op("poisson", n_diff=0)
def poisson(x, name=None):
    return torch.poisson(x, generator=_gen(x.device)).to(x.dtype)


@op("multinomial", n_diff=0)
def multinomial(x, num_samples=1, replacement=False, name=None):
    return torch.multinomial(x.float(), num_samples, replacement,
                             generator=_gen(x.device)).to(torch.int64)


@op("rand_like", n_diff=0)
def rand_like(x, dtype=None, name=None):
    dt = dtypes.convert_dtype(dtype) if dtype else x.dtype
    return torch.rand(x.shape, generator=_gen(x.device), dtype=dt,
                      device=x.device)


@op("randn_like", n_diff=0)
def randn_like(x, dtype=None, name=None):
    dt = dtypes.convert_dtype(dtype) if dtype else x.dtype
    return torch.randn(x.shape, generator=_gen(x.device), dtype=dt,
                       device=x.device)


def exponential_(x, lam=1.0, name=None):
    return _fill(x, lambda dev, d: torch.empty(
        d.shape, device=dev, dtype=torch.float32).exponential_(
        lam, generator=_gen(dev)))


@op("binomial", n_diff=0)
def binomial(count, prob, name=None):
    dt = torch.promote_types(count.dtype, prob.dtype)
    dt = dt if dt.is_floating_point else torch.float32
    return torch.binomial(count.to(dt), prob.to(dt),
                          generator=_gen(count.device)).to(torch.int64)


@op("log_normal")
def log_normal(mean=1.0, std=2.0, shape=None, name=None):
    dev = current_device()
    z = torch.randn(_shape(shape), generator=_gen(dev), device=dev,
                    dtype=torch.float64)
    return torch.exp(z * std + mean)


__all__ = public(globals())
