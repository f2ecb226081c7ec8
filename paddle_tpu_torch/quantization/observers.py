"""Calibration observers (port of paddle_tpu/quantization/observers.py).
Each forward reads its statistic back to the host (`float`), as the
reference's does: calibration runs eagerly."""
from __future__ import annotations

from ..core.tensor import _raw as raw
from ..nn.layer_base import Layer


class _ObserverLayer(Layer):
    def __init__(self, bit_length: int = 8):
        super().__init__()
        self.bit_length = bit_length

    @property
    def qmax(self):
        return float(2 ** (self.bit_length - 1) - 1)

    def scales(self) -> float:
        raise NotImplementedError


class AbsmaxObserver(_ObserverLayer):
    def __init__(self, quant_bits: int = 8, **kw):
        super().__init__(quant_bits)
        self._absmax = 0.0

    def forward(self, x):
        self._absmax = max(self._absmax, float(raw(x).detach().abs().max()))
        return x

    def scales(self) -> float:
        return max(self._absmax, 1e-8) / self.qmax


class MinMaxObserver(_ObserverLayer):
    def __init__(self, quant_bits: int = 8, **kw):
        super().__init__(quant_bits)
        self._min = float("inf")
        self._max = float("-inf")

    def forward(self, x):
        v = raw(x).detach()
        self._min = min(self._min, float(v.min()))
        self._max = max(self._max, float(v.max()))
        return x

    def scales(self) -> float:
        bound = max(abs(self._min), abs(self._max), 1e-8)
        return bound / self.qmax


class BaseObserver(_ObserverLayer):
    """The observer contract: forward collects statistics, `scales()` /
    `zero_points()` report them."""

    def zero_points(self):
        return 0.0
