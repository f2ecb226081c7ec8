"""Weight initializers.

Port of paddle_tpu/nn/initializer.py: `Constant`, `Normal`,
`TruncatedNormal`, `Uniform`, `XavierNormal`, `XavierUniform`,
`KaimingNormal`, `KaimingUniform`, `Assign`, `Orthogonal`, `Dirac`,
`calculate_gain` and `set_global_initializer`, with the reference's fans,
gains and bounds. An initializer writes into the parameter's storage
under `no_grad`. The random ones draw in f32 from the Tensor API's
generator of the parameter's device (`core.rng`: `seed(n)` repeats them),
so their values cannot equal the reference's jax draws; their shapes,
bounds and moments do.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import rng
from ..core.tensor import Tensor


class Initializer:
    def __call__(self, param, block=None):
        d = param._data
        with torch.no_grad():
            d.copy_(self._generate(tuple(d.shape), d.dtype, d.device))
        return param

    def _generate(self, shape, dtype, device):
        raise NotImplementedError

    @staticmethod
    def _normal(shape, device):
        return torch.randn(shape, dtype=torch.float32, device=device,
                           generator=rng.generator(device))

    @staticmethod
    def _uniform(shape, low, high, device):
        u = torch.rand(shape, dtype=torch.float32, device=device,
                       generator=rng.generator(device))
        return u * (high - low) + low


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _generate(self, shape, dtype, device):
        return torch.full(shape, self.value, dtype=dtype, device=device)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _generate(self, shape, dtype, device):
        return (self._normal(shape, device).to(dtype) * self.std
                + self.mean)


class TruncatedNormal(Initializer):
    """mean + std * z, z a standard normal truncated to [a, b]."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def _generate(self, shape, dtype, device):
        z = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(z, 0.0, 1.0, self.a, self.b,
                                    generator=rng.generator(device))
        return (z * self.std + self.mean).to(dtype)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def _generate(self, shape, dtype, device):
        return self._uniform(shape, self.low, self.high, device).to(dtype)


def _fans(shape):
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    rf = int(np.prod(shape[2:]))
    return shape[1] * rf, shape[0] * rf


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def std(self, shape):
        fi, fo = _fans(shape)
        return self.gain * math.sqrt(2.0 / ((self.fan_in or fi)
                                           + (self.fan_out or fo)))

    def _generate(self, shape, dtype, device):
        return self._normal(shape, device).to(dtype) * self.std(shape)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def limit(self, shape):
        fi, fo = _fans(shape)
        return self.gain * math.sqrt(6.0 / ((self.fan_in or fi)
                                           + (self.fan_out or fo)))

    def _generate(self, shape, dtype, device):
        lim = self.limit(shape)
        return self._uniform(shape, -lim, lim, device).to(dtype)


def _kaiming_gain(negative_slope, nonlinearity):
    if nonlinearity in ("relu", "leaky_relu"):
        return math.sqrt(2.0 / (1 + negative_slope ** 2))
    return 1.0


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.negative_slope, self.nonlinearity = \
            fan_in, negative_slope, nonlinearity

    def std(self, shape):
        return _kaiming_gain(self.negative_slope, self.nonlinearity) / \
            math.sqrt(self.fan_in or _fans(shape)[0])

    def _generate(self, shape, dtype, device):
        return self._normal(shape, device).to(dtype) * self.std(shape)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.negative_slope, self.nonlinearity = \
            fan_in, negative_slope, nonlinearity

    def limit(self, shape):
        return _kaiming_gain(self.negative_slope, self.nonlinearity) * \
            math.sqrt(3.0 / (self.fan_in or _fans(shape)[0]))

    def _generate(self, shape, dtype, device):
        lim = self.limit(shape)
        return self._uniform(shape, -lim, lim, device).to(dtype)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def _generate(self, shape, dtype, device):
        v = self.value
        if isinstance(v, Tensor):
            v = v._data
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.array(v))
        return v.detach().to(device=device, dtype=dtype).reshape(shape)


class Orthogonal(Initializer):
    """gain times a matrix with orthonormal rows or columns (the Q of a
    normal draw's QR, signs fixed by R's diagonal), reshaped."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def _generate(self, shape, dtype, device):
        rows = shape[0]
        cols = int(np.prod(shape[1:]))
        flat = self._normal((max(rows, cols), min(rows, cols)), device)
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q[:rows, :cols]).reshape(shape).to(dtype)


class Dirac(Initializer):
    def __init__(self, groups=1):
        self.groups = groups

    def _generate(self, shape, dtype, device):
        out = np.zeros(shape, np.float32)
        oc, ic = shape[0], shape[1]
        center = tuple(s // 2 for s in shape[2:])
        for g in range(self.groups):
            for i in range(min(oc // self.groups, ic)):
                out[(g * (oc // self.groups) + i, i) + center] = 1.0
        return torch.from_numpy(out).to(device=device, dtype=dtype)


calculate_gain_map = {
    "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
    "conv3d": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
    "selu": 3.0 / 4.0,
}


def calculate_gain(nonlinearity, param=None):
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    return calculate_gain_map.get(nonlinearity, 1.0)


def set_global_initializer(weight_init, bias_init=None):
    """Record the global initializers (the reference records them and its
    `create_parameter` does not read them; nor does the port's)."""
    global _global_weight_init, _global_bias_init
    _global_weight_init, _global_bias_init = weight_init, bias_init


_global_weight_init = None
_global_bias_init = None
