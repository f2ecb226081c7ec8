"""Quantization-aware training (port of paddle_tpu/quantization/qat.py).

QAT(config).quantize(model) wraps the configured Linears so that forward
fake-quantizes (straight-through) activations and weights; convert()
freezes them to `QuantizedLinear` as PTQ does. The quanters read their
scale on the host, so QAT runs eagerly (not inside a captured
`jit.to_static` graph).
"""
from __future__ import annotations

import copy

from ..nn.layer_base import Layer
from .ptq import QuantizedLinear, _replace_child, _warn_unsupported
from .quanters import FakeQuanterWithAbsMax


class _QATLinear(Layer):
    def __init__(self, inner, act_quanter=None, weight_quanter=None):
        super().__init__()
        self.inner = inner
        self.act_quanter = act_quanter() if isinstance(act_quanter, type) \
            else act_quanter
        self.weight_quanter = weight_quanter() \
            if isinstance(weight_quanter, type) else weight_quanter

    def forward(self, x):
        from ..nn import functional as F

        if self.act_quanter is not None:
            x = self.act_quanter(x)
        w = self.inner.weight
        if self.weight_quanter is not None:
            w = self.weight_quanter(w)
        return F.linear(x, w, getattr(self.inner, "bias", None))


class QAT:
    def __init__(self, config):
        self.config = config

    def quantize(self, model: Layer, inplace: bool = False) -> Layer:
        if not inplace:
            model = copy.deepcopy(model)
        from ..nn import Linear

        for name, child in list(model.named_sublayers()):
            cfg = self.config.config_for(name, child)
            if cfg is None:
                continue
            if not isinstance(child, Linear):
                _warn_unsupported(name, child)
                continue
            act = cfg.activation or FakeQuanterWithAbsMax
            wq = cfg.weight or FakeQuanterWithAbsMax
            _replace_child(model, name, _QATLinear(child, act, wq))
        return model

    def convert(self, model: Layer, inplace: bool = False) -> Layer:
        if not inplace:
            model = copy.deepcopy(model)
        for name, child in list(model.named_sublayers()):
            if isinstance(child, _QATLinear):
                if child.weight_quanter is None:
                    # nothing calibrated the weights: leave the layer fp
                    _replace_child(model, name, child.inner)
                    continue
                w_scale = child.weight_quanter.scales()
                if w_scale is None:
                    raise RuntimeError(
                        f"QAT.convert: quanter on '{name}' has no calibrated "
                        "scale — run at least one forward pass (training or "
                        "calibration) before convert()")
                a_scale = child.act_quanter.scales() \
                    if child.act_quanter else None
                _replace_child(model, name, QuantizedLinear(
                    child.inner, w_scale, a_scale))
        return model
