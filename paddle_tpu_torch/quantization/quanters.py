"""Fake quantization with a straight-through gradient (port of
paddle_tpu/quantization/quanters.py).

`FakeQuanterWithAbsMax` reads the running abs-max back to the host on
every forward (`float(...)`), as the reference's does: it runs eagerly.
QAT inside a captured `jit.to_static` graph is not supported (a capture
cannot read a value back).
"""
from __future__ import annotations

import torch

from ..core.dispatch import boundary
from ..core.tensor import _raw as raw
from ..nn.layer_base import Layer


class _FakeQuantSTE(torch.autograd.Function):
    """q = clip(round(x / scale), -qmax - 1, qmax) * scale; the gradient
    passes where |x| <= scale * (qmax + 1) and is zero elsewhere, and the
    scale takes none (the reference's `_fq_bwd`)."""

    @staticmethod
    def forward(ctx, x, scale, qmax):
        ctx.save_for_backward(x, scale)
        ctx.qmax = qmax
        return torch.clamp(torch.round(x / scale), -qmax - 1, qmax) * scale

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        inside = (x.abs() <= scale * (ctx.qmax + 1)).to(g.dtype)
        return g * inside, torch.zeros_like(scale), None


@boundary
def fake_quant(x, scale, bit_length: int = 8):
    """Quantize-dequantize with the straight-through gradient."""
    qmax = float(2 ** (bit_length - 1) - 1)
    sc = raw(scale)
    if not torch.is_tensor(sc):
        sc = torch.tensor(float(sc), dtype=torch.float32, device=x.device)
    return _FakeQuantSTE.apply(x, sc, qmax)


class FakeQuanterWithAbsMax(Layer):
    """QAT quanter: a running abs-max scale (read on the host, module
    note) and fake quantization on each forward."""

    def __init__(self, bit_length: int = 8, moving_rate: float = 0.9, **kw):
        super().__init__()
        self.bit_length = bit_length
        self.moving_rate = moving_rate
        self._scale = None

    def forward(self, x):
        qmax = float(2 ** (self.bit_length - 1) - 1)
        cur = float(raw(x).detach().abs().max()) / qmax or 1e-8
        if self._scale is None:
            self._scale = cur
        else:
            r = self.moving_rate
            self._scale = r * self._scale + (1 - r) * cur
        return fake_quant(x, max(self._scale, 1e-8), self.bit_length)

    def scales(self):
        return self._scale


class BaseQuanter(Layer):
    """The quanter contract: forward is a quantize-dequantize with
    straight-through gradients, `scales()` / `zero_points()` report the
    quantization parameters."""

    def scales(self):
        raise NotImplementedError

    def zero_points(self):
        return 0.0


_QUANTER_REGISTRY = {}


def quanter(name):
    """Class decorator registering a quanter factory under `name`."""

    def deco(cls):
        _QUANTER_REGISTRY[name] = cls
        cls._quanter_name = name
        return cls

    return deco
